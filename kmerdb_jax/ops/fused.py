"""Fused FASTA -> all2all pipeline: the Gram runs over raw k-mer
GROUPS, skipping the pattern machinery entirely.

The pattern forest (dedup + CSR + serialization) exists to make a
*database* compact for repeated queries — for a one-shot all2all it is
pure overhead: C[i,j] = |K_i ∩ K_j| = sum over unique k-mers g of
[i in g][j in g], i.e. a weight-1 Gram over the group incidence, and
the groups fall straight out of the ingest merge.  The fused path
deletes pattern dedup, the per-k-mer CSR (110M entries on the 4,096 x
30 kbp scale corpus) and DB serialization, and pays for it with more
Gram rows (1.82M groups vs 157k patterns on that corpus).

Division of labor: the HOST owns extraction and the bucketed merge +
incidence bit-fill — pure byte-shuffling — and the device owns every
multiply-add (the Gram engine, ops/gram.py).  Weights are identically
1, so the whole plan is one light class (n_limbs=1) and ONE weight
vector pushed once.

Reference role: `build` + `all2all` chained
(src/console_build.cpp:48-57 -> src/similarity_calculator.cpp:42-438);
the reference has no fused mode — this is an extension of this
system (CLI: `all2all -from-fasta <sample-list> <csv>`).
"""

import os
import time

import numpy as np

from .._jaxinit import jax_modules

#: per-run phase timings of the last fused all2all (for bench)
last_stats: dict = {}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _merged_partitions(key_streams, hashes=False):
    """Yield per k-mer-range partition of the multiway merge
    (models/builder.py's partitioning, minus dedup/CSR):
    (merged_vals, gstart, n_groups) — or, with hashes,
    (merged_vals, gstart, glen, h1, h2).  merged_vals[gstart[g]:
    gstart[g+1]] is group g's ascending sample-id list; values beyond
    the last group run to merged_vals.size."""
    from ..models import builder
    from ..utils import native

    total = int(sum(s.size for s in key_streams))
    n_parts = max(1, -(-total // builder._PARTITION_ELEMS))
    edges = builder._partition_edges(key_streams, n_parts)
    cuts = builder._partition_cuts(key_streams, edges)

    for part in range(edges.size + 1):
        sliced_k, sliced_v, cvals = [], [], []
        for i, s in enumerate(key_streams):
            lo, hi = int(cuts[i, part]), int(cuts[i, part + 1])
            if hi <= lo:
                continue
            sliced_k.append(s[lo:hi])
            sliced_v.append(None)
            cvals.append(i)
        if not sliced_k:
            continue
        mv, gk, gstart, glen, h1, h2 = native.merge_groups(
            sliced_k, sliced_v, cvals, scratch=True, hashes=hashes)
        if hashes:
            yield mv, gstart, glen, h1, h2
        else:
            yield mv, gstart, gk.size


class _ShimDb:
    """Duck-typed KmerPatternDb carrying exactly the fields
    device_a2a._all2all_device_inner reads, so the fused path reuses
    the pattern path's weighted light/heavy device pipeline
    program-for-program."""

    def __init__(self, offs, sids, weights, n_samples):
        self.pattern_offsets = offs
        self.pattern_sample_ids = sids
        self.pattern_num_kmers = weights
        self.n_samples = n_samples
        self.n_patterns = weights.size


def _dedup_patterns(key_streams):
    """Multiway merge + set-hash dedup WITHOUT the per-kmer CSR or
    serialization: (offsets, sample_ids, multiplicities, n_groups).

    Exactly the builder's pattern construction (merge_groups +
    _dedup_groups per partition, then the cross-partition (h1, h2,
    len) unification of builder._finalize_db) minus everything a
    one-shot all2all never reads — the per-kmer inverse (110M-entry
    CSR at the scale corpus) and the varint container.  Multiplicity
    per pattern = its unique-k-mer count = pattern_num_kmers, so the
    device Gram over these rows is bit-identical to the pattern
    path's."""
    from ..models import builder
    from ..utils import native

    rep_flat, rep_lens, mults = [], [], []
    trip_h1, trip_h2, trip_len = [], [], []
    for mv, gstart, glen, h1, h2 in _merged_partitions(key_streams,
                                                       hashes=True):
        inverse, first = builder._dedup_groups(glen, h1, h2)
        n_pat = first.size
        mults.append(np.bincount(inverse, minlength=n_pat
                                 ).astype(np.uint32))
        lens = glen[first].astype(np.int64)
        offs_all = np.empty(gstart.size + 1, dtype=np.int64)
        offs_all[:gstart.size] = gstart
        offs_all[gstart.size] = mv.size
        out_off = np.zeros(n_pat + 1, dtype=np.int64)
        np.cumsum(lens, out=out_off[1:])
        flat = np.empty(out_off[-1], dtype=np.uint32)
        if native.available:
            native.gather_ragged_u32(
                np.ascontiguousarray(first), offs_all,
                np.ascontiguousarray(mv), out_off[:-1].copy(), flat)
        else:
            for p, g in enumerate(first):
                flat[out_off[p]:out_off[p + 1]] = \
                    mv[offs_all[g]:offs_all[g] + lens[p]]
        rep_flat.append(flat)
        rep_lens.append(lens)
        trip_h1.append(h1[first].copy())
        trip_h2.append(h2[first].copy())
        trip_len.append(glen[first].astype(np.int64))

    if not rep_flat:
        return (np.zeros(1, dtype=np.int64),
                np.zeros(0, dtype=np.uint32),
                np.zeros(0, dtype=np.uint32), 0)
    lens = np.concatenate(rep_lens)
    flat = np.concatenate(rep_flat)
    weights = np.concatenate(mults)
    n_groups = int(sum(int(m.sum()) for m in mults))
    if len(rep_flat) > 1:
        # cross-partition unification (builder._finalize_db's global
        # dedup): same content key, weights summed
        H1 = np.concatenate(trip_h1)
        H2 = np.concatenate(trip_h2)
        LEN = np.concatenate(trip_len)
        inv2, first2 = builder._dedup_groups(LEN, H1, H2)
        if first2.size < lens.size:
            w = np.zeros(first2.size, dtype=np.uint64)
            np.add.at(w, inv2, weights.astype(np.uint64))
            weights = w.astype(np.uint32)
            offs_all = np.zeros(lens.size + 1, dtype=np.int64)
            np.cumsum(lens, out=offs_all[1:])
            keep = lens[first2]
            out_off = np.zeros(first2.size + 1, dtype=np.int64)
            np.cumsum(keep, out=out_off[1:])
            new_flat = np.empty(out_off[-1], dtype=np.uint32)
            if native.available:
                native.gather_ragged_u32(
                    np.ascontiguousarray(first2), offs_all,
                    np.ascontiguousarray(flat),
                    out_off[:-1].copy(), new_flat)
            else:
                for p, g in enumerate(first2):
                    new_flat[out_off[p]:out_off[p + 1]] = \
                        flat[offs_all[g]:offs_all[g] + keep[p]]
            flat = new_flat
            lens = keep

    offs = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs, flat, weights, n_groups


def _host_group_counts(key_streams) -> np.ndarray:
    """Host oracle/fallback: the same group formulation through the
    C++ scatter kernel (weight-1 groups instead of patterns)."""
    from ..utils import native

    S = len(key_streams)
    C = np.zeros((S, S), dtype=np.uint32)
    for mv, gstart, ng in _merged_partitions(key_streams):
        offs = np.empty(ng + 1, dtype=np.int64)
        offs[:ng] = gstart[:ng]
        offs[ng] = mv.size
        if native.available:
            C += native.a2a_dense(offs, np.ascontiguousarray(mv),
                                  np.ones(ng, dtype=np.uint32), S)
        else:
            for g in range(ng):
                ids = mv[offs[g]:offs[g + 1]].astype(np.int64)
                C[np.ix_(ids, ids)] += 1
    return C


def _group_model(S: int, total_elems: int):
    """(host-tier seconds under the resolved constants, group count
    estimate): group count G lies between total/S (identical samples)
    and total (disjoint samples); total/sqrt(S) matches the 4,096 x
    30 kbp scale corpus (123M elements -> 1.82M groups), and the mean
    group length is ~S/4 on relatedness-heavy corpora.  No jax: the
    host estimate gates before the backend is touched."""
    from .costcal import resolve
    c = resolve()
    G = max(int(total_elems / max(S, 1) ** 0.5), 1)
    rate = c["host_rate"] if S <= 1024 else c["host_rate_big"]
    return float(total_elems) * (S / 4) / rate, G


def device_worthwhile(S: int, total_elems: int, c: dict | None = None
                      ) -> bool:
    """Device-vs-host price of a fused job under constants c (default:
    the resolved ones; no device constants -> False).  Pure arithmetic,
    no jax: callers gate on the host estimate first."""
    from . import costcal
    c = c or costcal.resolve()
    if not costcal.has_device(c):
        return False
    from .gram import PAD
    host, G = _group_model(S, total_elems)
    S_pad = _round_up(max(S, 1), PAD)
    packed = float(G) * (S_pad // 8)
    flops = 2.0 * G * S_pad * S_pad
    dev = (c["fixed_s"] + flops / c["dev_flops"]
           + packed / c["push_Bps"] + packed / c["fill_Bps"]
           + S * S * 2 / c["pull_Bps"])
    return dev < host


def device_chosen(S: int, total_elems: int) -> bool:
    """The automatic fused/grid tier choice: the host estimate gates
    before jax is touched, then this machine's calibrated constants
    price the device (ops/costcal.device_constants)."""
    from . import costcal
    c = costcal.device_constants(_group_model(S, total_elems)[0])
    return c is not None and device_worthwhile(S, total_elems, c)


def all2all_group_counts(key_streams, force=None) -> np.ndarray:
    """uint32[S, S] common-k-mer matrix straight from per-sample
    sorted-unique k-mer streams (no database is built).

    force: None = cost-modeled tier choice, True = device, False =
    host (KMERDB_FUSED_DEVICE=1/0 is the env form).  A chosen device
    tier that fails raises.
    """
    env = os.environ.get("KMERDB_FUSED_DEVICE", "")
    if force is None and env in ("0", "1"):
        force = env == "1"
    if force is False:
        return _host_group_counts(key_streams)
    S = len(key_streams)
    total = int(sum(s.size for s in key_streams))
    if force is None and not device_chosen(S, total):
        return _host_group_counts(key_streams)
    if _dedup_route(S, total):
        return _device_pattern_counts(key_streams)
    return _device_group_counts(key_streams)


def _dedup_route(S: int, total_elems: int) -> bool:
    """Choose the device wire format: raw k-mer groups (one merge, no
    dedup) vs set-hash-deduped patterns (~10x fewer incidence rows on
    real corpora, at ~25 ns/element of extra host work).  Dedup wins
    when the push it saves outweighs that work; without calibrated
    push bandwidth the raw route is taken.  KMERDB_FUSED_DEDUP=1/0
    forces."""
    env = os.environ.get("KMERDB_FUSED_DEDUP", "")
    if env in ("0", "1"):
        return env == "1"
    from .costcal import resolve
    c = resolve()
    if "push_Bps" not in c:
        return False
    from .gram import PAD
    _, G = _group_model(S, total_elems)
    S_pad = _round_up(max(S, 1), PAD)
    raw_push_s = G * (S_pad / 8) / c["push_Bps"]
    dedup_s = total_elems * 25e-9 + (G / 10) * (S_pad / 8) / c["push_Bps"]
    return dedup_s < raw_push_s


def grid_group_counts(dbs) -> dict:
    """Every cell of the all2all-parts grid in ONE device pass:
    {(i, j): uint32[S_i, S_j]} for all i >= j (diagonal cells full
    symmetric, i.e. all2all_counts(dbs[i]); off-diagonal cells
    db2db_counts(dbs[i], dbs[j])).

    Rather than pushing a pair-indexed incidence per cell (P^2 cells
    re-shipping each database's data per pair list), every part's
    incidence is expressed over the GLOBAL union k-mer coordinate space
    (rows = union positions, with gaps where other parts own the
    k-mer), so each part is filled and pushed exactly ONCE per run and
    every cell is a weight-1 packed cross-Gram over resident chunks.
    Zero rows contribute nothing, so disjoint parts cost only idle
    multiply-adds, not correctness.

    Reference role: src/console_all2all_parts.cpp:143-331 (which
    re-loads column parts per grid row because host RAM is its
    constraint; here the one-push contract plays that role in device
    memory).
    """
    jax, jnp = jax_modules()
    from . import gram
    from .device_a2a import ROW_ALIGN
    from ..utils import native

    P_n = len(dbs)
    union = np.unique(np.concatenate(
        [db.kmers for db in dbs if db.kmers.size]
        or [np.empty(0, dtype=np.uint64)]))
    G = int(union.size)
    S_pads = [_round_up(max(db.n_samples, 1), gram.PAD) for db in dbs]

    group_bytes = int(os.environ.get("KMERDB_A2A_GROUP_MB", "256")) << 20
    CH = max(ROW_ALIGN, (group_bytes * 8 // max(S_pads))
             // ROW_ALIGN * ROW_ALIGN)
    CH = min(CH, _round_up(max(G, 1), ROW_ALIGN))

    # per-part fill ingredients: global rows + pattern CSR
    part_rows, part_pids, part_offs, part_sids = [], [], [], []
    for db in dbs:
        part_rows.append(np.searchsorted(union, db.kmers).astype(np.int64))
        part_pids.append(np.ascontiguousarray(db.kmer_pattern_ids,
                                              dtype=np.int64))
        part_offs.append(np.ascontiguousarray(db.pattern_offsets,
                                              dtype=np.int64))
        part_sids.append(np.ascontiguousarray(db.pattern_sample_ids,
                                              dtype=np.uint32))
    w_dev = jax.device_put(np.ones(CH, dtype=np.uint32))
    C_dev = {(i, j): jnp.zeros((S_pads[i], S_pads[j]), jnp.uint32)
             for i in range(P_n) for j in range(i + 1)}

    bufs = [np.zeros((CH // 8, sp), dtype=np.uint8) for sp in S_pads]
    for r0 in range(0, max(G, 1), CH):
        r1 = min(G, r0 + CH)
        # only parts owning rows in this union-range chunk get filled,
        # pushed, or multiplied: for range-partitioned (disjoint) parts
        # most (cell, chunk) products are provably zero and skipping
        # them removes nearly all of the grid's device work
        U = [None] * P_n
        for pi in range(P_n):
            a = int(np.searchsorted(part_rows[pi], r0))
            b = int(np.searchsorted(part_rows[pi], r1))
            if b <= a:
                continue
            buf = bufs[pi]
            buf[:] = 0
            rows_loc = part_rows[pi][a:b] - r0
            if native.available:
                native.fill_incidence_bits_rows(
                    rows_loc, part_pids[pi][a:b], part_offs[pi],
                    part_sids[pi], buf)
            else:
                for e in range(b - a):
                    r = int(rows_loc[e])
                    p = int(part_pids[pi][a + e])
                    cols = part_sids[pi][part_offs[pi][p]:
                                         part_offs[pi][p + 1]]
                    buf[r >> 3, cols] |= np.uint8(1 << (r & 7))
            # copy: live views of reused scratch must not reach the
            # asynchronous device_put
            U[pi] = jax.device_put(buf.copy())
        for i in range(P_n):
            if U[i] is None:
                continue
            for j in range(i + 1):
                if U[j] is None:
                    continue
                C_dev[(i, j)] = gram.cross_step(
                    C_dev[(i, j)], U[i], U[j], w_dev, n_limbs=1)

    return {(i, j): gram.pull(C, dbs[i].n_samples, dbs[j].n_samples)
            for (i, j), C in C_dev.items()}


def grid_rows_streamed(get_part, part_sizes):
    """Streamed device grid for all2all-parts ABOVE the host cache
    budget: yields (i_row, {i_col: uint32[S_row, S_col]}) per grid row.

    Unlike grid_group_counts (every part resident in host RAM, one
    global-union push per part per RUN), this holds ONE row part at a
    time: the row part's packed incidence — over its OWN k-mer
    coordinates — is filled and pushed once per grid row and stays
    device-resident across that row's cells (KMERDB_A2A_RESIDENT_MB
    budget; beyond it, chunks re-push per cell); each column part is
    fetched via get_part (the caller's byte-budgeted LRU) and pushed
    once per cell.  Per-part push count therefore matches the
    reference's once-per-grid-row reload discipline
    (src/console_all2all_parts.cpp:157-225) instead of degrading to
    per-cell pair-list pushes when RAM runs out.

    Cell math: C_ij[r, c] = #{k-mers g of the ROW part shared with the
    col part and containing r (row-part pattern) and c (col-part
    pattern)} — a weight-1 packed cross-Gram over row-part k-mer
    coordinates; k-mers absent from the row part contribute nothing to
    that cell by definition.
    """
    jax, jnp = jax_modules()
    from . import gram
    from .device_a2a import ROW_ALIGN
    from ..utils import native

    P_n = len(part_sizes)
    S_pads = [_round_up(max(s, 1), gram.PAD) for s in part_sizes]

    group_bytes = int(os.environ.get("KMERDB_A2A_GROUP_MB", "256")) << 20
    CH_budget = max(ROW_ALIGN, (group_bytes * 8 // max(S_pads))
                    // ROW_ALIGN * ROW_ALIGN)
    w_cache = {}

    def w_dev_for(CH):
        if CH not in w_cache:
            w_cache[CH] = jax.device_put(np.ones(CH, dtype=np.uint32))
        return w_cache[CH]

    resident_budget = int(os.environ.get("KMERDB_A2A_RESIDENT_MB",
                                         "4096")) << 20

    for i_row in range(P_n):
        db_row = get_part(i_row)
        G = int(db_row.kmers.size)
        sp_i = S_pads[i_row]
        # chunk rows: pow2-of-ROW_ALIGN bucket of this part's k-mer
        # count, capped by the scratch budget (bounds the scratch on
        # tiny parts and the compiled-program count)
        CH = ROW_ALIGN
        while CH < min(CH_budget, max(G, 1)):
            CH <<= 1
        w_dev = w_dev_for(CH)
        n_chunks = max(1, -(-G // CH))
        row_pids = np.ascontiguousarray(db_row.kmer_pattern_ids,
                                        dtype=np.int64)
        row_offs = np.ascontiguousarray(db_row.pattern_offsets,
                                        dtype=np.int64)
        row_sids = np.ascontiguousarray(db_row.pattern_sample_ids,
                                        dtype=np.uint32)
        rbuf = np.zeros((CH // 8, sp_i), dtype=np.uint8)

        def row_chunk(c):
            a, b = c * CH, min(G, (c + 1) * CH)
            rbuf[:] = 0
            if b > a:
                if native.available:
                    native.fill_incidence_bits(row_pids[a:b], row_offs,
                                               row_sids, rbuf)
                else:
                    for e in range(b - a):
                        p = int(row_pids[a + e])
                        cols = row_sids[row_offs[p]:row_offs[p + 1]]
                        rbuf[e >> 3, cols] |= np.uint8(1 << (e & 7))
            return jax.device_put(rbuf.copy())

        resident = n_chunks * (CH // 8) * sp_i <= resident_budget
        U_chunks = [row_chunk(c) for c in range(n_chunks)] \
            if resident else None

        cells = {}
        # diagonal cell: weight-1 cross-Gram of the row incidence with
        # itself, accumulated over chunks
        C_ii = jnp.zeros((sp_i, sp_i), jnp.uint32)
        for c in range(n_chunks):
            U = U_chunks[c] if resident else row_chunk(c)
            C_ii = gram.cross_step(C_ii, U, U, w_dev, n_limbs=1)
        cells[i_row] = gram.pull(C_ii, part_sizes[i_row],
                                 part_sizes[i_row])

        for i_col in range(i_row):
            db_col = get_part(i_col)
            sp_j = S_pads[i_col]
            col_offs = np.ascontiguousarray(db_col.pattern_offsets,
                                            dtype=np.int64)
            col_sids = np.ascontiguousarray(db_col.pattern_sample_ids,
                                            dtype=np.uint32)
            # positions of shared k-mers: row-part coordinates
            idx = np.searchsorted(db_col.kmers, db_row.kmers)
            idx_c = np.minimum(idx, max(db_col.kmers.size - 1, 0))
            shared = (db_col.kmers.size > 0) & \
                (db_col.kmers[idx_c] == db_row.kmers)
            col_pids_all = db_col.kmer_pattern_ids[idx_c].astype(
                np.int64)
            cbuf = np.zeros((CH // 8, sp_j), dtype=np.uint8)
            C_ij = jnp.zeros((sp_i, sp_j), jnp.uint32)
            for c in range(n_chunks):
                a, b = c * CH, min(G, (c + 1) * CH)
                loc = np.flatnonzero(shared[a:b]).astype(np.int64)
                if loc.size == 0:
                    continue  # provably-zero (chunk, cell) product
                cbuf[:] = 0
                if native.available:
                    native.fill_incidence_bits_rows(
                        loc, col_pids_all[a + loc], col_offs, col_sids,
                        cbuf)
                else:
                    for e in loc:
                        p = int(col_pids_all[a + e])
                        cols = col_sids[col_offs[p]:col_offs[p + 1]]
                        cbuf[int(e) >> 3, cols] |= np.uint8(
                            1 << (int(e) & 7))
                U = U_chunks[c] if resident else row_chunk(c)
                C_ij = gram.cross_step(C_ij, U, jax.device_put(cbuf.copy()),
                                       w_dev, n_limbs=1)
            cells[i_col] = gram.pull(C_ij, part_sizes[i_row],
                                     part_sizes[i_col])
        yield i_row, cells


def _device_pattern_counts(key_streams) -> np.ndarray:
    """Dedup-route device tier: set-hash pattern dedup on the host
    (no per-kmer CSR, no serialization), then the pattern path's
    light/heavy packed device pipeline program-for-program
    (device_a2a.all2all_device via _ShimDb).  Pushes ~P incidence rows
    instead of ~G >> P raw group rows (see _dedup_route).
    Bit-identical to both the raw-group device route and the pattern
    path (multiplicity per pattern = its unique-k-mer count)."""
    from . import device_a2a

    t0 = time.perf_counter()
    S = len(key_streams)
    if S == 0:
        return np.zeros((0, 0), dtype=np.uint32)
    td0 = time.perf_counter()
    offs, flat, weights, n_groups = _dedup_patterns(key_streams)
    t_dedup = time.perf_counter() - td0
    shim = _ShimDb(offs, flat, weights, S)
    out = device_a2a.all2all_device(shim)
    last_stats.clear()
    last_stats.update(device_a2a.last_stats)
    last_stats.update({
        "n_groups": n_groups, "n_patterns": int(weights.size),
        "route": "dedup", "merge_dedup_s": t_dedup,
        "total_s": time.perf_counter() - t0,
    })
    return out


def _device_group_counts(key_streams) -> np.ndarray:
    """Raw-group device tier: every merged k-mer group is one weight-1
    incidence row, filled chunk by chunk into one packed scratch and
    accumulated into C by the Gram engine."""
    jax, jnp = jax_modules()
    from . import gram
    from .device_a2a import ROW_ALIGN
    from ..utils import native

    t_start = time.perf_counter()
    S = len(key_streams)
    if S == 0:
        return np.zeros((0, 0), dtype=np.uint32)
    S_pad = _round_up(S, gram.PAD)

    group_bytes = int(os.environ.get("KMERDB_A2A_GROUP_MB", "256")) << 20
    group_rows = max(ROW_ALIGN, (group_bytes * 8 // S_pad)
                     // ROW_ALIGN * ROW_ALIGN)
    # bound by the group count's upper bound (total unique <= total
    # elements): small corpora must not size (or compile) a scratch
    # orders beyond their data
    total_elems = int(sum(s.size for s in key_streams))
    group_rows = min(group_rows, _round_up(max(total_elems, 1), ROW_ALIGN))

    # one compiled program: rows fixed at group_rows, short chunks pad
    # with zero rows (zero incidence contributes nothing at any weight)
    C = jnp.zeros((S_pad, S_pad), jnp.uint32)
    w_dev = jax.device_put(np.ones(group_rows, dtype=np.uint32))
    buf = native.alloc_array(group_rows // 8 * S_pad, np.uint8,
                             populate=False).reshape(group_rows // 8,
                                                     S_pad) \
        if native.available else np.zeros((group_rows // 8, S_pad),
                                          np.uint8)

    t_merge = 0.0
    t_fill = 0.0
    t_push = 0.0
    n_groups = 0
    flops = 0.0
    tm0 = time.perf_counter()
    for mv, gstart, ng in _merged_partitions(key_streams):
        t_merge += time.perf_counter() - tm0
        n_groups += ng
        offs = np.empty(ng + 1, dtype=np.int64)
        offs[:ng] = gstart[:ng]
        offs[ng] = mv.size
        mvc = np.ascontiguousarray(mv)
        for c0 in range(0, ng, group_rows):
            c1 = min(ng, c0 + group_rows)
            ta = time.perf_counter()
            buf[:] = 0  # full wipe: a short final chunk must not keep
            #             stale rows from the previous full chunk
            if native.available:
                native.fill_incidence_bits(
                    np.arange(c0, c1, dtype=np.int64), offs, mvc, buf)
            else:
                for i in range(c0, c1):
                    cols = mvc[offs[i]:offs[i + 1]]
                    buf[(i - c0) >> 3, cols] |= np.uint8(1 << ((i - c0) & 7))
            tb = time.perf_counter()
            # full-shape copy: the compiled program's shape is fixed at
            # group_rows (the zeroed tail rows contribute nothing), and
            # a live view of the reused scratch must never reach the
            # asynchronous device_put
            C = gram.gram_step(C, jax.device_put(buf.copy()), w_dev,
                               n_limbs=1)
            flops += 2.0 * group_rows * S_pad * S_pad
            t_fill += tb - ta
            t_push += time.perf_counter() - tb
        tm0 = time.perf_counter()

    t1 = time.perf_counter()
    out = gram.pull(C, S, S)
    t2 = time.perf_counter()

    last_stats.clear()
    last_stats.update({
        "platform": jax.default_backend(),
        "S": S, "S_pad": S_pad, "n_groups": n_groups, "flops": flops,
        "merge_s": t_merge, "fill_s": t_fill, "push_s": t_push,
        "compute_pull_s": t2 - t1, "total_s": t2 - t_start,
    })
    return out
