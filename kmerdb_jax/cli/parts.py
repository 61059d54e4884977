"""all2all-parts: grid comparison over partial databases
(reference src/console_all2all_parts.cpp:11-371).

Pass 1 reads only sample tables of every part; pass 2 walks grid rows,
computing the diagonal cell with the all2all kernel and off-diagonal
cells with the cross-database kernel, streaming out globally-indexed
sparse rows (column indices shifted by the parts' sample offsets).
"""

import os

import numpy as np

from ..io import dbfile
from ..ops import intersect
from ..utils import csvio, log
from ..utils.filters import CombinedFilter
from .params import UsageError


def run_all2all_parts(p):
    if len(p.files) != 2:
        raise UsageError(p.mode)
    list_fn, out_fn = p.files
    with open(list_fn) as f:
        part_fns = f.read().split()
    if not part_fns:
        raise RuntimeError("Cannot open: " + list_fn)

    # pass 1: headers only (SamplesOnly)
    sample_names, sample_counts, part_sizes = [], [], []
    kmer_len, fraction = 0, 1.0
    for i, fn in enumerate(part_fns):
        hdr = dbfile.load_db(fn, dbfile.SAMPLES_ONLY)
        if i == 0:
            kmer_len, fraction = hdr.kmer_length, hdr.fraction
        else:
            if hdr.kmer_length != kmer_len:
                raise RuntimeError("Different k-mer lengths")
            if hdr.fraction != fraction:
                raise RuntimeError("Different fractions")
        sample_names += hdr.sample_names
        sample_counts += [int(c) for c in hdr.sample_kmer_counts]
        part_sizes.append(hdr.n_samples)

    do_sampling = p.sampling_size != 0
    sampler = None
    if do_sampling:
        from ..utils.sampler import Sampler
        strategy = "best" if p.sampling_criterion else "random"
        sampler = Sampler(len(sample_names), p.sampling_size, strategy)

    idx_shifts = np.concatenate([[0], np.cumsum(part_sizes)]).astype(int)

    with open(out_fn, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(kmer_len, fraction, sample_names))
        ofs.write(csvio.totals_row(sample_counts))

        # loaded-part cache: unlike the reference (whose parts exist
        # precisely because RAM is the constraint, so it reloads column
        # parts every row, console_all2all_parts.cpp:157-225), keep
        # parts resident up to a byte budget and only reload beyond it
        cache_budget = int(os.environ.get("KMERDB_PARTS_CACHE_MB",
                                          "4096")) << 20
        cached: dict[int, object] = {}
        cached_bytes = 0

        def part_nbytes(db):
            return int(db.kmers.nbytes + db.kmer_pattern_ids.nbytes
                       + db.pattern_sample_ids.nbytes
                       + db.pattern_offsets.nbytes)

        def get_part(idx):
            nonlocal cached_bytes
            db = cached.get(idx)
            if db is None:
                db = dbfile.load_db(part_fns[idx], dbfile.EVERYTHING)
                nb = part_nbytes(db)
                if cached_bytes + nb <= cache_budget:
                    cached[idx] = db
                    cached_bytes += nb
            return db

        # device grid tier (ops/fused.grid_group_counts): every cell in
        # one device pass over union-coordinate incidence pushed once
        # per part — replaces per-cell pair-list pushes.  Cost-model
        # gated (headers give the workload; the host estimate decides
        # before jax is touched); KMERDB_GRID_DEVICE=1/0 forces.  Holds
        # all parts in host RAM, so the explicit off-switch also
        # restores the cache budget.
        from .consoles import _active_mesh
        mesh = _active_mesh()
        grid_cells = None
        genv = os.environ.get("KMERDB_GRID_DEVICE", "")
        want_grid = genv == "1"
        if genv == "" and mesh is None and len(part_fns) > 1:
            from ..ops import fused
            want_grid = fused.device_chosen(int(sum(part_sizes)),
                                            int(sum(sample_counts)))
        grid_stream = None
        if want_grid:
            from ..ops import fused
            # varint DBs expand ~2-4x in RAM; when the expanded parts
            # cannot all sit inside the cache budget, stream the grid
            # one row-part at a time (device-resident row incidence,
            # once-per-row pushes) instead of abandoning the device
            # tier (KMERDB_GRID_STREAM=1/0 forces)
            senv = os.environ.get("KMERDB_GRID_STREAM", "")
            est = sum(os.path.getsize(fn) for fn in part_fns) * 4
            stream = senv == "1" or (senv != "0" and est > cache_budget)
            if stream:
                grid_stream = fused.grid_rows_streamed(get_part,
                                                       part_sizes)
            else:
                grid_cells = fused.grid_group_counts(
                    [get_part(i) for i in range(len(part_fns))])

        # percent progress over emitted global rows at -v (the
        # reference's long-sparse-path progress, progress.h used at
        # similarity_calculator.cpp:1347)
        prog = log.Progress(max(1, int(sum(part_sizes))))
        for i_row, fn_row in enumerate(part_fns):
            log.verbose(f"grid row {i_row + 1}/{len(part_fns)}")
            db_row = get_part(i_row)
            row_filter_counts = db_row.sample_kmer_counts

            row_cells_dev = None
            if grid_stream is not None:
                _, row_cells_dev = next(grid_stream)

            # cell matrices of this grid row, keyed by i_col
            cells = {}
            for i_col in range(i_row):
                db_col = get_part(i_col)
                if row_cells_dev is not None:
                    X = row_cells_dev[i_col]
                elif grid_cells is not None:
                    X = grid_cells[(i_row, i_col)]
                elif mesh is not None:
                    from ..parallel import sharded
                    X = sharded.db2db_counts_sharded(db_row, db_col,
                                                     mesh)
                else:
                    X = intersect.db2db_counts(db_row, db_col)
                filt = CombinedFilter(p.metric_filters, p.kmer_filter,
                                      row_filter_counts,
                                      db_col.sample_kmer_counts, kmer_len)
                if do_sampling:
                    _cross_to_sampler(sampler, X, filt, p, db_row, db_col,
                                      idx_shifts[i_row], idx_shifts[i_col],
                                      kmer_len)
                else:
                    cells[i_col] = _filtered_pairs_matrix(X, filt)

            # diagonal cell
            if row_cells_dev is not None:
                C = row_cells_dev[i_row]
            elif grid_cells is not None:
                C = grid_cells[(i_row, i_row)]
            elif mesh is not None:
                from ..parallel import sharded
                C = sharded.all2all_counts_sharded(db_row, mesh)
            else:
                C = intersect.all2all_counts(db_row)
            filt = CombinedFilter(p.metric_filters, p.kmer_filter,
                                  row_filter_counts, row_filter_counts,
                                  kmer_len)
            if do_sampling:
                _diag_to_sampler(sampler, C, filt, p, db_row,
                                 idx_shifts[i_row], kmer_len)
            else:
                S = db_row.n_samples
                diag_cell = []
                for r in range(S):
                    row = C[r, :r]
                    keep = filt.mask_row(row, r)
                    nz = np.flatnonzero(row * keep)
                    diag_cell.append((nz, row[nz]))
                cells[i_row] = diag_cell

            if not do_sampling:
                # bulk row assembly: per-cell survivor (col, value)
                # arrays concatenate with global shifts and format
                # through the native pair writer — no per-cell Python
                # tuples (the reference streams rows the same way,
                # console_all2all_parts.cpp:294-315)
                for r in range(db_row.n_samples):
                    g = idx_shifts[i_row] + r
                    cs, vs = [], []
                    for i_col in range(i_row + 1):
                        c, v = cells[i_col][r]
                        if c.size:
                            cs.append(c.astype(np.int64)
                                      + (idx_shifts[i_col] + 1))
                            vs.append(v)
                    cols = (np.concatenate(cs) if cs
                            else np.empty(0, dtype=np.int64))
                    vals = (np.concatenate(vs) if vs
                            else np.empty(0, dtype=np.uint32))
                    ofs.write(csvio.sparse_row_pairs_arrays(
                        sample_names[g], sample_counts[g], cols, vals))
                    prog.step()

        if do_sampling:
            for g in range(len(sample_names)):
                ofs.write(csvio.sparse_row_pairs(
                    sample_names[g], sample_counts[g], sampler.row_pairs(g)))
                prog.step()
        prog.done()


def _filtered_pairs_matrix(X, filt):
    """Per-row survivor (cols, values) array pairs (ascending cols)."""
    out = []
    for r in range(X.shape[0]):
        row = X[r]
        keep = filt.mask_row(row, r)
        nz = np.flatnonzero(row * keep)
        out.append((nz, row[nz]))
    return out


def _cross_to_sampler(sampler, X, filt, p, db_row, db_col, row_shift,
                      col_shift, kmer_len):
    crit = p.sampling_criterion or (lambda c, a, b, k: 1.0)
    rc = db_row.sample_kmer_counts
    cc = db_col.sample_kmer_counts
    for r in range(X.shape[0]):
        row = X[r]
        nz = np.flatnonzero(row)
        if nz.size == 0:
            continue
        keep = filt.mask_row(row[nz], r, nz)
        for j in nz[keep]:
            v = int(row[j])
            score = float(crit(v, int(rc[r]), int(cc[j]), kmer_len))
            sampler.add(row_shift + r, col_shift + int(j), v, score)
            sampler.add(col_shift + int(j), row_shift + r, v, score)


def _diag_to_sampler(sampler, C, filt, p, db_row, shift, kmer_len):
    from ..utils.sampler import feed_lower_triangle
    feed_lower_triangle(sampler, C, filt, p.sampling_criterion,
                        db_row.sample_kmer_counts, kmer_len, shift=shift)
