"""Mode drivers (the reference's console_*.cpp files).

Each run_* takes a parsed Params and produces byte-parity CSV output.
"""

import os
import sys

import numpy as np

from ..models.database import KmerPatternDb
from ..models import builder
from ..ops import intersect
from ..ops.alphabet import get_alphabet
from ..io import dbfile, fasta, ingest, minhash_file
from ..utils import csvio, log
from ..utils.filters import CombinedFilter
from ..utils.num2str import num2str_float, format_double_cpp
from . import params as P
from .loader import iter_samples
from .params import UsageError

_BUILD_BATCH = 1024  # samples per add_samples batch (memory bound)


def _build_batch_size() -> int:
    """KMERDB_BUILD_BATCH overrides the batch bound (read per call,
    not at import).  Larger batches mean fewer merge passes AND fewer
    distinct pow2 partition shapes — each distinct shape compiles its
    own device-build program, the dominant one-time cost of
    KMERDB_BUILD_DEVICE=1.  The DB bytes
    are batch-invariant (set-hash dedup normalizes patterns;
    verified: KMERDB_BUILD_BATCH={32,128} builds cmp equal)."""
    return int(os.environ.get("KMERDB_BUILD_BATCH", _BUILD_BATCH))


def _log(p, *args):
    print(*args, file=sys.stderr)




# ---------------------------------------------------------------------------
# build / minhash
# ---------------------------------------------------------------------------

def _add_batch(db, batch):
    """One add_samples batch, routed through the k-mer-range-sharded
    device build when a CLI mesh is active (byte-identical output —
    tests/test_sharded.py::test_build_sharded_*)."""
    mesh = _active_mesh()
    if mesh is not None:
        from ..parallel import sharded
        return sharded.build_sharded(db, batch, mesh)
    return builder.add_samples(db, batch)


def run_build(p):
    if len(p.files) != 2:
        raise UsageError(p.mode)
    samples_arg, db_filename = p.files

    if p.extend_db:
        db = dbfile.load_db(db_filename, dbfile.EVERYTHING)
        kmer_length = db.kmer_length
        fraction = db.fraction
        fraction_start = db.start_fraction
        alphabet_name = db.alphabet_name
    else:
        # the reference NEVER assigns its db's startFraction: it is
        # constructed as 0 (kmer_db.h:63) and nothing sets it, so the
        # persisted value is always 0 and query-time re-filtering
        # (one2all/new2all/extend ingest) uses the [0, fraction)
        # window regardless of -f-start.  -f-start only shapes the
        # build-time ingest below.  Replicated for parity.
        db = KmerPatternDb(kmer_length=0, fraction=p.fraction,
                           start_fraction=0.0,
                           alphabet_name=p.alphabet_name)
        kmer_length = p.kmer_length
        fraction = p.fraction
        fraction_start = p.fraction_start
        alphabet_name = p.alphabet_name

    import time
    timing = os.environ.get("KMERDB_TIMING") == "1"
    t0 = time.perf_counter()
    batch = []
    for s in iter_samples(samples_arg, p.input_format, kmer_length,
                          fraction, fraction_start, alphabet_name,
                          p.multisample_fasta,
                          num_threads=p.num_threads):
        if db.kmer_length == 0:
            # first sample fixes k/fraction (AbstractKmerDb::addKmers,
            # kmer_db.h:112-125) — relevant for minhash/KMC inputs
            db.kmer_length = s.kmer_length
            db.fraction = s.fraction
        elif s.kmer_length != db.kmer_length:
            raise RuntimeError("sample k-mer length differs from database")
        elif s.fraction != db.fraction:
            # kmer_db.h:118-120: "adding kmers of different minhash
            # fraction" is an error (mixed-fraction .minhash inputs)
            raise RuntimeError(
                "sample minhash fraction differs from database")
        batch.append((s.name, s.kmers))
        if len(batch) >= _build_batch_size():
            db = _add_batch(db, batch)
            batch = []
    t1 = time.perf_counter()
    if batch or db.n_samples == 0:
        db = _add_batch(db, batch)
    t2 = time.perf_counter()
    if db.n_samples == 0:
        _log(p, "WARNING: no samples were ingested (check input paths; "
                "relative list entries resolve against the working "
                "directory)")
    dbfile.save_db(db, db_filename)
    if timing:
        _log(p, f"TIMING ingest={t1 - t0:.2f}s add={t2 - t1:.2f}s "
                f"save={time.perf_counter() - t2:.2f}s")
    _log(p, f"Database stored: {db.n_samples} samples, {db.n_kmers} kmers, "
            f"{db.n_patterns} patterns")


def run_minhash(p):
    if len(p.files) != 1:
        raise UsageError(p.mode)
    # the reference's minhash console hardcodes startValue=0 when
    # building its filter (console_minhash.cpp:19) — -f-start is
    # silently ignored in this mode; replicated for parity
    for s in iter_samples(p.files[0], p.input_format, p.kmer_length,
                          p.fraction, 0.0, p.alphabet_name,
                          p.multisample_fasta,
                          num_threads=p.num_threads):
        # store next to the input path (console_minhash.cpp:45); stored
        # fraction is the CLI fraction
        minhash_file.store(s.path, s.kmers, s.kmer_length, p.fraction)


# ---------------------------------------------------------------------------
# all2all family
# ---------------------------------------------------------------------------

def _active_mesh():
    """The CLI-requested device mesh (parallel/runtime), or None for
    the single-chip tiers."""
    from ..parallel import runtime
    return runtime.active_mesh()


def _matrix_filter(p, db, query_counts=None):
    qc = db.sample_kmer_counts if query_counts is None else query_counts
    return CombinedFilter(p.metric_filters, p.kmer_filter,
                          qc, db.sample_kmer_counts, db.kmer_length)


def _emit_matrix_row(ofs, name, cnt, row, i, filt):
    """One all2all CSV body row (dense, or filter-masked sparse).  The
    single home of the row byte format: run_all2all's emit and the
    fused console both delegate here so `all2all` and `all2all
    -from-fasta` can never drift apart."""
    if filt is not None:
        keep = filt.mask_row(row, i)
        row = np.where(keep, row, 0)
        ofs.write(csvio.sparse_row(name, cnt, row))
    else:
        ofs.write(csvio.dense_row(name, cnt, row))


def _fused_ingest(p, list_filename):
    """Ingest a sample list and run the fused group Gram
    (ops/fused.py): returns (shim_db, C) where shim_db carries the
    names/counts/k/fraction the filter, sampler, and writer stacks
    read — so the -from-fasta forms of all2all and all2all-sp share
    every byte-format code path with their database-backed forms."""
    import time
    from ..utils import log
    from ..ops import fused

    t0 = time.perf_counter()
    names, counts, streams = [], [], []
    kmer_length, fraction = p.kmer_length, p.fraction
    first = True
    for s in iter_samples(list_filename, p.input_format, p.kmer_length,
                          p.fraction, p.fraction_start, p.alphabet_name,
                          p.multisample_fasta,
                          num_threads=p.num_threads):
        if first:
            kmer_length, fraction = s.kmer_length, s.fraction
            first = False
        elif s.kmer_length != kmer_length:
            raise RuntimeError("sample k-mer length differs")
        elif s.fraction != fraction:
            raise RuntimeError("sample minhash fraction differs")
        names.append(s.name)
        counts.append(s.kmers.size)
        streams.append(s.kmers)
    counts = np.asarray(counts, dtype=np.uint32)
    log.verbose(f"{len(names)} samples ingested in "
                f"{time.perf_counter() - t0:.3f}s")

    t1 = time.perf_counter()
    C = fused.all2all_group_counts(streams)
    log.verbose(f"Fused group Gram computed in "
                f"{time.perf_counter() - t1:.3f}s")
    shim = KmerPatternDb(kmer_length=kmer_length, fraction=fraction,
                         alphabet_name=p.alphabet_name,
                         sample_names=names,
                         sample_kmer_counts=counts)
    return shim, C


def run_all2all_fused(p):
    """`all2all -from-fasta <sample-list> <csv>`: the fused
    ingest->group-Gram pipeline (ops/fused.py) — no database is built,
    the device consumes the merged k-mer groups directly.  Output is
    byte-identical to `build` + `all2all` over the same list (same
    header, same counts; C is the same matrix by construction)."""
    if len(p.files) != 2:
        raise UsageError(p.mode)
    list_filename, out_filename = p.files
    db, C = _fused_ingest(p, list_filename)

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))
        filt = _matrix_filter(p, db) if p.sparse_out else None
        for i in range(db.n_samples):
            _emit_matrix_row(ofs, db.sample_names[i],
                             int(db.sample_kmer_counts[i]), C[i, :i],
                             i, filt)


def run_all2all(p):
    import os
    import time
    from ..utils import log
    if getattr(p, "from_fasta", False):
        return run_all2all_fused(p)
    if len(p.files) != 2:
        raise UsageError(p.mode)
    db_filename, out_filename = p.files
    t0 = time.perf_counter()
    db = dbfile.load_db(db_filename, dbfile.PATTERNS)
    t1 = time.perf_counter()
    log.verbose(f"Database loaded in {t1 - t0:.3f}s: "
                f"{db.n_samples} samples, {db.n_patterns} patterns")

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))
        filt = _matrix_filter(p, db) if p.sparse_out else None

        prog = log.Progress(db.n_samples)

        def emit(i, full_row):
            _emit_matrix_row(ofs, db.sample_names[i],
                             int(db.sample_kmer_counts[i]),
                             full_row[:i], i, filt)
            prog.step()

        mesh = _active_mesh()
        if _stream_rows(db, mesh):
            # large-S memory story: C never fully materializes — row
            # stripes stream straight into the CSV writer, either from
            # one device or row-ownership-sharded over the mesh.
            # Sparse output: the count filter runs on the device before
            # the pull (metric filters are re-applied host-side by
            # emit(); they can only narrow further, so the count bounds
            # are a sound superset)
            cell_bounds = None
            if filt is not None:
                kb = p.kmer_filter.bounds
                cell_bounds = (max(1, int(kb[0])),
                               min(0xFFFFFFFF, int(kb[1])))
            if mesh is not None:
                from ..parallel import sharded
                sharded.all2all_rows_sharded(
                    db, mesh, emit, cell_bounds=cell_bounds)
            else:
                from ..ops import device_a2a
                device_a2a.all2all_device_rows(
                    db, emit, cell_bounds=cell_bounds)
        else:
            if mesh is not None:
                from ..parallel import sharded
                C = sharded.all2all_counts_sharded(db, mesh)
            else:
                C = intersect.all2all_counts(db)
            t2 = time.perf_counter()
            log.verbose(f"Similarity matrix computed in {t2 - t1:.3f}s")
            for i in range(db.n_samples):
                emit(i, C[i])
        prog.done()


def _stream_rows(db, mesh=None) -> bool:
    """Route all2all through the striped streaming tier when the full
    C matrix would strain host+device memory (default above 16k
    samples; KMERDB_A2A_STREAM=1/0 forces).  With an active mesh the
    row-stripe-sharded path runs on any backend; one device streams
    only on a GPU."""
    if db.n_samples == 0:
        return False
    env = os.environ.get("KMERDB_A2A_STREAM", "")
    if env in ("0", "1"):
        return env == "1"
    # size gate FIRST: on_gpu() starts the jax backend, and a small CLI
    # job must never pay that just to learn it doesn't stream
    if db.n_samples <= 16384:
        return False
    from ..utils import native
    if not native.available:
        return False
    if mesh is not None:
        return True
    from .._jaxinit import on_gpu
    return on_gpu()


def run_all2all_sp(p):
    """Sparse computation mode: same math here (the Gram kernel is
    already dense-tile based); differs from all2all -sparse only in
    sampling support (console_all2all_sparse.cpp)."""
    if len(p.files) != 2:
        raise UsageError(p.mode)
    db_filename, out_filename = p.files
    if getattr(p, "from_fasta", False):
        # extension of this system: FASTA list -> filtered/sampled sparse
        # matrix in one command, no database (same fused pipeline as
        # all2all -from-fasta; first positional is the sample list)
        db, C = _fused_ingest(p, db_filename)
    else:
        db = dbfile.load_db(db_filename, dbfile.PATTERNS)
        mesh = _active_mesh()
        if mesh is not None:
            from ..parallel import sharded
            C = sharded.all2all_counts_sharded(db, mesh)
        else:
            C = intersect.all2all_counts(db)
    filt = _matrix_filter(p, db)

    sampler = None
    if p.sampling_size != 0:
        from ..utils.sampler import Sampler
        strategy = "best" if p.sampling_criterion else "random"
        sampler = Sampler(db.n_samples, p.sampling_size, strategy)

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))

        # percent progress over output rows at -v (the reference's
        # refresh::progress_state role, similarity_calculator.cpp:479)
        prog = log.Progress(db.n_samples)
        if sampler is not None:
            _feed_sampler(sampler, C, filt, p, db)
            for i in range(db.n_samples):
                ofs.write(csvio.sparse_row_pairs(
                    db.sample_names[i], int(db.sample_kmer_counts[i]),
                    sampler.row_pairs(i)))
                prog.step()
        else:
            for i in range(db.n_samples):
                row = C[i, :i]
                keep = filt.mask_row(row, i)
                row = np.where(keep, row, 0)
                ofs.write(csvio.sparse_row(
                    db.sample_names[i], int(db.sample_kmer_counts[i]), row))
                prog.step()
        prog.done()


def _feed_sampler(sampler, C, filt, p, db):
    from ..utils.sampler import feed_lower_triangle
    feed_lower_triangle(sampler, C, filt, p.sampling_criterion,
                        db.sample_kmer_counts, db.kmer_length)


# ---------------------------------------------------------------------------
# new2all / one2all
# ---------------------------------------------------------------------------

def run_new2all(p):
    if len(p.files) != 3:
        raise UsageError(p.mode)
    db_filename, samples_arg, out_filename = p.files
    db = dbfile.load_db(db_filename, dbfile.EVERYTHING)

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))

        mesh = _active_mesh()

        def flush(names, queries):
            # batched contraction (query-sharded over the mesh when
            # -mesh is active; device H @ B / per-query galloping probes
            # by cost model otherwise); rows stay in input order
            if mesh is not None:
                from ..parallel import sharded
                M = sharded.many2all_counts_sharded(db, queries, mesh)
            else:
                M = intersect.many2all_counts(db, queries)
            filt = None
            if p.sparse_out:
                # one filter for the whole batch (row axis = queries);
                # per-row masks vectorize — no per-cell Python at scale
                filt = _matrix_filter(
                    p, db, query_counts=np.array(
                        [q.size for q in queries], dtype=np.uint32))
            for i, (name, q) in enumerate(zip(names, queries)):
                sims = M[i]
                cnt = int(q.size)
                if p.sparse_out:
                    nz = np.flatnonzero(sims)
                    keep = filt.mask_row(sims[nz], i, nz)
                    kept = nz[keep]
                    pairs = list(zip((kept + 1).tolist(),
                                     sims[kept].tolist()))
                    ofs.write(csvio.sparse_row_pairs(name, cnt, pairs))
                else:
                    ofs.write(csvio.dense_row(name, cnt, sims))

        # percent progress over queries when the list length is known
        # upfront (reference progress.h role); multisample FASTA counts
        # are unknown until read, so those fall back to batch logs
        prog = None
        if not p.multisample_fasta and not fasta.is_fasta_path(samples_arg):
            try:
                prog = log.Progress(len(fasta.read_file_list(samples_arg)))
            except OSError:
                pass

        names, queries = [], []
        n_done = 0
        for s in iter_samples(samples_arg, p.input_format, db.kmer_length,
                              db.fraction, db.start_fraction,
                              db.alphabet_name, p.multisample_fasta,
                              num_threads=p.num_threads):
            names.append(s.name)
            # loader output is sorted unique for genome/KMC inputs; the
            # strictness check costs one vectorized pass and skips the
            # re-sort np.unique would always pay
            q = s.kmers
            if q.size > 1 and not bool(np.all(q[1:] > q[:-1])):
                q = np.unique(q)
            queries.append(q)
            if len(names) >= 512:
                flush(names, queries)
                n_done += len(names)
                if prog is not None:
                    prog.step(len(names))
                else:
                    log.verbose(f"{n_done} queries processed")
                names, queries = [], []
        if names:
            flush(names, queries)
            n_done += len(names)
            if prog is not None:
                prog.step(len(names))
            else:
                log.verbose(f"{n_done} queries processed")
        if prog is not None:
            prog.done()


def run_one2all(p):
    if len(p.files) != 3:
        raise UsageError(p.mode)
    db_filename, sample_arg, out_filename = p.files
    db = dbfile.load_db(db_filename, dbfile.EVERYTHING)

    if p.input_format == P.GENOME:
        contigs = fasta.load_sample_contigs(sample_arg)
        if contigs is None:
            raise RuntimeError(f"Cannot open sample file: {sample_arg}")
        kmers = ingest.extract_sample_kmers(
            contigs, db.kmer_length, get_alphabet(db.alphabet_name),
            db.fraction, db.start_fraction)
    elif p.input_format == P.MINHASH:
        res = minhash_file.load(sample_arg)
        if res is None:
            raise RuntimeError(f"Cannot open sample file: {sample_arg}")
        kmers, k, _ = res
        if k != db.kmer_length:
            raise RuntimeError("Sample and database k-mer length differ")
    else:
        from ..io import kmc
        res = kmc.load(sample_arg, db.fraction, db.start_fraction)
        if res is None:
            raise RuntimeError(f"Cannot open sample file: {sample_arg}")
        kmers, k = res
        if k != db.kmer_length:
            # console_one2all.cpp:58-67: KMC sample k must match the db
            raise RuntimeError("Sample and database k-mer length differ")
        kmers = np.unique(kmers)

    sims = intersect.one2all_counts(db, kmers)
    with open(out_filename, "w", newline="") as ofs:
        # console_one2all.cpp:86-92: totals via ostream, no final newline
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))
        ofs.write(f"{sample_arg},{kmers.size},"
                  + "".join(f"{int(v)}," for v in sims))


# ---------------------------------------------------------------------------
# distance
# ---------------------------------------------------------------------------

def run_distance(p):
    from ..utils.filters import AVAILABLE_METRICS
    if len(p.files) < 2:
        raise UsageError(p.mode)
    in_name, out_name = p.files[0], p.files[1]
    metric = AVAILABLE_METRICS[p.metric_name]

    with open(in_name) as fin, open(out_name, "w", newline="") as fout:
        header = fin.readline().rstrip("\n")
        # 'kmer-length: K fraction: F ,db-samples ,names...'
        # (console_distance.cpp:63-96 streams this with a line buffer;
        # malformed headers must fail as a diagnosed error, not a raw
        # IndexError/ValueError)
        try:
            toks = header.split()
            if toks[0] != "kmer-length:" or toks[2] != "fraction:":
                raise ValueError("unexpected field names")
            kmer_length = int(toks[1])
            fraction = float(toks[3])
            # remainder after the 5th whitespace token (',db-samples')
            idx = 0
            for _ in range(5):
                while header[idx] == " ":
                    idx += 1
                while idx < len(header) and header[idx] != " ":
                    idx += 1
            rest = header[idx:]
        except (IndexError, ValueError) as e:
            raise IOError(f"Cannot parse similarity matrix header of "
                          f"{in_name}: {e}") from e
        names = [t for t in rest.replace(",", " ").split()]
        if not p.phylip_out:
            fout.write(f"kmer-length: {kmer_length} fraction: "
                       f"{format_double_cpp(fraction)}{rest}\n")

        totals_line = fin.readline().rstrip("\n")
        toks = totals_line.replace(",", " ").split()
        try:
            db_counts = [int(t) for t in toks[2:]]
        except ValueError as e:
            raise IOError(f"Cannot parse total-kmers row of "
                          f"{in_name}: {e}") from e
        if p.phylip_out:
            fout.write(f"{len(db_counts)}\n")

        sparse_out = p.sparse_out and not p.phylip_out
        triangle = False
        db_counts_np = np.asarray(db_counts, dtype=np.uint32)
        from ..utils import native
        fast = native.available and p.metric_name in native.METRIC_IDS

        for row_id, line in enumerate(fin):
            line = line.rstrip("\n")
            cpos = line.find(",")
            query_name = line[:cpos]
            rest = line[cpos + 1:]
            cpos = rest.find(",")
            query_count = int(rest[:cpos]) if cpos >= 0 else int(rest or 0)
            body = rest[cpos + 1:] if cpos >= 0 else ""

            filt = CombinedFilter(p.metric_filters, p.kmer_filter,
                                  [query_count], db_counts, kmer_length)

            toks = body.split(",")
            if toks and toks[-1] == "":
                toks.pop()
            has_pairs = ":" in body

            dense = np.zeros(len(db_counts), dtype=np.int64)
            sparse_entries = []
            num_read = len(toks)
            if not has_pairs and not sparse_out:
                # dense fast path
                if toks:
                    dense[:len(toks)] = np.array(toks, dtype=np.int64)
            else:
                num_read = 0
                for tok in toks:
                    if not tok:
                        continue
                    if ":" in tok:
                        c, v = tok.split(":")
                        col = int(c) - 1
                        common = int(v)
                        if p.phylip_out:
                            dense[col] = common
                        else:
                            sparse_out = True
                            if common > 0 and filt(common, 0, col):
                                sparse_entries.append((col, common))
                    else:
                        common = int(tok)
                        if sparse_out:
                            if common > 0 and filt(common, 0, num_read):
                                sparse_entries.append((num_read, common))
                        else:
                            dense[num_read] = common
                    num_read += 1

            if row_id == 0:
                empty_diag = (len(sparse_entries) == 0) if sparse_out \
                    else (dense[0] == 0)
                if query_name == names[0] and empty_diag:
                    triangle = True

            if sparse_out:
                out_cells = "".join(
                    f"{col + 1}:{num2str_float(metric(common, query_count, db_counts[col], kmer_length))},"
                    for col, common in sparse_entries)
                fout.write(f"{query_name},{out_cells}\n")
            else:
                n_out = num_read if p.phylip_out \
                    else (row_id if triangle else len(dense))
                delim = " " if p.phylip_out else ","
                if fast and n_out > 0:
                    mvals = native.metric_row(
                        p.metric_name, dense[:n_out], query_count,
                        db_counts_np[:n_out], kmer_length)
                    body_out = native.row_double6(mvals, delim).decode()
                else:
                    body_out = "".join(
                        num2str_float(metric(int(dense[j]), query_count,
                                             db_counts[j], kmer_length))
                        + delim for j in range(n_out))
                fout.write(query_name + delim + body_out + "\n")
