"""Common-k-mer counting kernels.

The flagship all2all kernel re-expresses the reference's
decompress + SIMD row_add scatter pipeline
(similarity_calculator.cpp:42-438, src/simd/row_add_avx2.cpp) as GEMM
contractions.  With B the (patterns x samples) 0/1 incidence matrix
and w the per-pattern k-mer multiplicity:

    C = B^T diag(w) B        (C[i,j] = |kmers(i) ∩ kmers(j)|)

The device tiers run these contractions through the Gram engine
(ops/gram.py: int8 tensor-core GEMMs over 7-bit weight limbs, exact in
uint32, tolerance zero); the host tier is the native C++ scatter.

one2all probes query k-mers against the sorted k-mer array (vectorized
binary search — replacing hashtable probes, similarity_calculator.cpp:
661-925), histograms pattern ids, and applies counts through the
pattern CSR.
"""

import functools
import os

import numpy as np

from .._jaxinit import jax_modules
from ..models.database import KmerPatternDb

#: patterns per new2all device chunk (bounds the host-built int8
#: incidence blocks; far below gram.MAX_DOT_ROWS)
_CHUNK = 32768
#: CSR elements per device chunk
_CHUNK_E = 1 << 20

#: the last new2all / db2db device-tier run in this process: {"tier",
#: "platform", shapes} (chip_smoke reads it to prove the device ran)
last_device: dict = {}


def _record_device(tier: str, **shapes) -> None:
    jax, _ = jax_modules()
    last_device.clear()
    last_device.update(tier=tier, platform=jax.default_backend(), **shapes)


def _gathered_incidence(pids, offs, sids, n_chunks, P_pad, S_pad):
    """int8[n_chunks, P_pad, S_pad]: row i of chunk c is the sample
    incidence of pattern pids[c * P_pad + i] (host-built)."""
    from ..utils import native
    lens = (offs[1:] - offs[:-1])[pids]
    B = native.alloc_array(n_chunks * P_pad * S_pad, np.int8,
                           populate=False).reshape(n_chunks, P_pad, S_pad)
    for c in range(n_chunks):
        sel = pids[c * P_pad:(c + 1) * P_pad]
        l_c = lens[c * P_pad:(c + 1) * P_pad]
        out_off = np.zeros(sel.size + 1, dtype=np.int64)
        np.cumsum(l_c, out=out_off[1:])
        cols = np.empty(out_off[-1], dtype=np.uint32)
        native.gather_ragged_u32(np.ascontiguousarray(sel), offs,
                                 sids, out_off[:-1].copy(), cols)
        rows = np.repeat(np.arange(sel.size, dtype=np.int32),
                         l_c).astype(np.int32)
        native.fill_incidence(rows, cols.astype(np.int32), B[c])
    return B


def _d2d_device(db_row, db_col, up1, up2, cnts):
    """Device tier of db2db: pattern-pair chunks contracted as
    C += U^T diag(counts) V through the Gram engine — bit-packed
    pair-axis incidence filled straight from both CSRs, C accumulated
    on the device, one pull."""
    from . import gram
    from .device_a2a import ROW_ALIGN
    from ..utils import native
    jax, jnp = jax_modules()
    S1, S2 = db_row.n_samples, db_col.n_samples
    S1_pad = _round_up(max(S1, 1), gram.PAD)
    S2_pad = _round_up(max(S2, 1), gram.PAD)
    n_pairs = up1.size
    rows = min(_round_up(max(n_pairs, 1), ROW_ALIGN), 8 * _CHUNK)
    n_limbs = gram.n_limbs(int(cnts.max()))

    o1 = np.ascontiguousarray(db_row.pattern_offsets, dtype=np.int64)
    s1 = np.ascontiguousarray(db_row.pattern_sample_ids, dtype=np.uint32)
    o2 = np.ascontiguousarray(db_col.pattern_offsets, dtype=np.int64)
    s2 = np.ascontiguousarray(db_col.pattern_sample_ids, dtype=np.uint32)

    Ubuf = np.zeros((rows // 8, S1_pad), dtype=np.uint8)
    Vbuf = np.zeros((rows // 8, S2_pad), dtype=np.uint8)
    wbuf = np.zeros(rows, dtype=np.uint32)
    C = jnp.zeros((S1_pad, S2_pad), jnp.uint32)
    for g0 in range(0, n_pairs, rows):
        g1 = min(n_pairs, g0 + rows)
        Ubuf[:] = 0
        Vbuf[:] = 0
        wbuf[:] = 0
        p1c = np.ascontiguousarray(up1[g0:g1])
        p2c = np.ascontiguousarray(up2[g0:g1])
        if native.available:
            native.fill_incidence_bits(p1c, o1, s1, Ubuf)
            native.fill_incidence_bits(p2c, o2, s2, Vbuf)
        else:
            for i in range(g1 - g0):
                Ubuf[i >> 3, s1[o1[p1c[i]]:o1[p1c[i] + 1]]] |= \
                    np.uint8(1 << (i & 7))
                Vbuf[i >> 3, s2[o2[p2c[i]]:o2[p2c[i] + 1]]] |= \
                    np.uint8(1 << (i & 7))
        wbuf[:g1 - g0] = cnts[g0:g1]
        # copies: never hand live views of reused scratch to the
        # asynchronous device_put
        C = gram.cross_step(C, jax.device_put(Ubuf.copy()),
                            jax.device_put(Vbuf.copy()),
                            jax.device_put(wbuf.copy()), n_limbs=n_limbs)
    _record_device("db2db", pairs=int(n_pairs), S1=S1, S2=S2)
    return gram.pull(C, S1, S2)


def _run_length_counts(sorted_arr: np.ndarray):
    """(unique_values int64[], counts uint32[]) of a sorted array."""
    if sorted_arr.size == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint32))
    boundary = np.empty(sorted_arr.size, dtype=bool)
    boundary[0] = True
    np.not_equal(sorted_arr[1:], sorted_arr[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    uniq = sorted_arr[starts].astype(np.int64)
    counts = np.diff(np.append(starts, sorted_arr.size)).astype(np.uint32)
    return uniq, counts


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _chunk_plan(offs: np.ndarray, P: int, max_p: int, max_e: int):
    """Pattern-range chunk bounds limited by pattern and element budgets."""
    bounds = [0]
    while bounds[-1] < P:
        p0 = bounds[-1]
        p1 = min(P, p0 + max_p)
        hi = int(np.searchsorted(offs, offs[p0] + max_e, side="right")) - 1
        p1 = max(p0 + 1, min(p1, hi))
        bounds.append(p1)
    return bounds


def all2all_counts(db: KmerPatternDb) -> np.ndarray:
    """Full symmetric common-k-mer count matrix, uint32[S, S].

    The diagonal holds sample self-counts (the reference only emits the
    strict lower triangle; callers slice what they need).

    Tier choice: KMERDB_A2A_DEVICE=1 forces the device tier, =0 the
    host C++ scatter.  Otherwise the host estimate decides BEFORE jax
    is imported (a small CLI job never pays backend start), and a job
    big enough on a GPU host is priced with this machine's calibrated
    constants (ops/costcal).  A device tier that was chosen and fails
    raises.  Without the native runtime the device tier's code runs on
    whatever backend JAX has.
    """
    S = db.n_samples
    if db.n_patterns == 0 or S == 0:
        return np.zeros((S, S), dtype=np.uint32)

    from ..utils import native
    device_env = os.environ.get("KMERDB_A2A_DEVICE", "")
    want_device = device_env == "1" or not native.available
    if device_env == "" and native.available:
        from . import costcal
        from .device_a2a import host_cost_s, device_cost_s
        host_s = host_cost_s(db)
        c = costcal.device_constants(host_s)
        want_device = c is not None and device_cost_s(db, c) < host_s
    if want_device:
        from . import device_a2a
        return device_a2a.all2all_device(db)
    return native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                            db.pattern_num_kmers, S)


def one2all_counts(db: KmerPatternDb, query_kmers: np.ndarray) -> np.ndarray:
    """uint32[S] common-kmer counts of one query (sorted unique k-mers)
    against every database sample (reference one2all,
    similarity_calculator.cpp:661-925)."""
    S = db.n_samples
    sims = np.zeros(S, dtype=np.uint32)
    if query_kmers.size == 0 or db.n_kmers == 0:
        return sims
    offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    from ..utils import native
    if native.available:
        pids = native.one2all_probe(
            np.ascontiguousarray(query_kmers),
            np.ascontiguousarray(db.kmers),
            np.ascontiguousarray(db.kmer_pattern_ids, dtype=np.int32))
        if pids.size == 0:
            return sims
        # run-length count of sorted hit pids (avoids a bincount
        # zeroing n_patterns counters per query)
        nz, counts = _run_length_counts(np.sort(pids))
        native.csr_apply(np.ascontiguousarray(nz), counts, offs,
                         np.ascontiguousarray(db.pattern_sample_ids,
                                              dtype=np.uint32),
                         sims)
        return sims
    idx = np.searchsorted(db.kmers, query_kmers)
    idx[idx >= db.n_kmers] = db.n_kmers - 1
    found = db.kmers[idx] == query_kmers
    pids = db.kmer_pattern_ids[idx[found]]
    pat_counts = np.bincount(pids, minlength=db.n_patterns)
    nz = np.flatnonzero(pat_counts)
    for p in nz:
        cnt = np.uint32(pat_counts[p])
        seg = db.pattern_sample_ids[offs[p]:offs[p + 1]]
        sims[seg] += cnt
    return sims


@functools.lru_cache(maxsize=None)
def _jit_m2a():
    jax, _ = jax_modules()
    return functools.partial(
        jax.jit, static_argnames=("n_limbs",))(_m2a_scan_impl)


def _m2a_scan_impl(H_all, B_all, *, n_limbs):
    """sims = H @ B accumulated over pattern chunks in one dispatch.

    H_all: uint8/uint32[n_chunks, Q_pad, P_pad] per-chunk hit counts;
    B_all: int8[n_chunks, P_pad, S_pad] incidence blocks.
    """
    jax, jnp = jax_modules()
    from . import gram
    C0 = jnp.zeros((H_all.shape[1], B_all.shape[2]), dtype=jnp.uint32)

    def step(C, chunk):
        H, B = chunk
        return gram.hits_matmul(C, H, B, n_limbs=n_limbs), None

    C, _ = jax.lax.scan(step, C0, (H_all, B_all))
    return C


def _m2a_host_s(db, probes, S: int) -> float:
    """Host-tier estimate of the new2all apply from the probe results
    (both tiers pay the probes)."""
    from . import costcal
    c = costcal.resolve()
    lens = np.diff(db.pattern_offsets)
    if S >= 512:
        # pattern-major host apply (what _m2a_host_apply runs at this
        # S): per-hit cost is capped by the SIMD row AXPY at ~S/8
        # units, at the cache-resident scatter rate
        cap = np.uint32(max(S // 8, 1))
        apply_ops = float(sum(np.minimum(lens[hp], cap).sum()
                              for hp, _ in probes[0]))
    else:
        apply_ops = float(sum(lens[hp].sum() for hp, _ in probes[0]))
    return apply_ops / c["host_rate"]


def many2all_counts(db: KmerPatternDb, queries: list[np.ndarray],
                    use_device: bool | None = None) -> np.ndarray:
    """uint32[Q, S]: common-k-mer counts of each query (sorted unique
    k-mer array) against every database sample — the batched form of
    one2all that new2all runs (reference console_new2all.cpp:64-95).

    Device path: per query the hit pattern histogram is built on the
    host (galloping probe), then sims = H @ B runs as exact-uint32
    Gram-engine contractions over pattern chunks.  Host path: per-query
    CSR apply.  Tier default = the cost model on the shared probe
    results (both paths pay the probes, so the dispatch sees the EXACT
    host apply workload before choosing); KMERDB_N2A_DEVICE=1/0 forces.
    A chosen device tier that fails raises.
    """
    from ..utils import native
    Q = len(queries)
    S = db.n_samples
    if Q == 0 or S == 0:
        return np.zeros((Q, S), dtype=np.uint32)

    env = os.environ.get("KMERDB_N2A_DEVICE", "")
    probes = None
    if use_device is None:
        use_device = env == "1"
        if env == "" and db.n_patterns and native.available:
            from . import costcal
            probes = _probe_queries(db, queries)
            host_s = _m2a_host_s(db, probes, S)
            c = costcal.device_constants(host_s)
            if c is not None:
                from . import gram
                Q_pad = _round_up(Q, gram.PAD)
                S_pad = _round_up(S, gram.PAD)
                P = float(db.n_patterns)
                h_bytes = Q_pad * P * (1 if probes[1] < 256 else 4)
                flops = 2.0 * Q_pad * P * S_pad * gram.n_limbs(probes[1])
                dev_s = (c["fixed_s"]
                         + (h_bytes + P * S_pad) / c["push_Bps"]
                         + flops / c["dev_flops"]
                         + Q * S * 4 / c["pull_Bps"])
                use_device = dev_s < host_s
    if not use_device or db.n_patterns == 0 or not native.available:
        if probes is not None:
            return _m2a_host_apply(db, probes[0], S)
        if native.available and db.n_patterns:
            # forced-host (KMERDB_N2A_DEVICE=0) must still take the
            # batched probe + pattern-major apply — the per-query
            # one2all loop below is the no-native fallback only
            return _m2a_host_apply(db, _probe_queries(db, queries)[0], S)
        return np.stack([one2all_counts(db, q) for q in queries])

    H_all, B_all, n_limbs = m2a_prepare(db, queries, probes=probes)
    C = np.asarray(_jit_m2a()(H_all, B_all, n_limbs=n_limbs))
    _record_device("new2all", queries=Q, S=S, chunks=int(H_all.shape[0]))
    return C[:Q, :S]


class _ProbeList(list):
    """Per-query (hit_pids, counts) pairs, plus the flat batched-probe
    arrays (`flat`) that let the host apply run as ONE threaded native
    call instead of a Python loop."""
    flat = None


def _probe_queries(db: KmerPatternDb, queries: list[np.ndarray]):
    """Probe every query against the database k-mer array:
    ([(hit_pids, counts)], max_count) — the shared host stage of BOTH
    many2all tiers (the dispatch cost model reads the exact apply
    workload from it before committing to a tier).

    Native path: ONE bucketed multi-query intersect (the db array
    streams from RAM once for the whole batch, key ranges fan out
    across threads — the role of the reference's per-query pool
    threads, console_new2all.cpp:64-95)."""
    from ..utils import native
    kmers = np.ascontiguousarray(db.kmers)
    pids32 = np.ascontiguousarray(db.kmer_pattern_ids, dtype=np.int32)
    probes = _ProbeList()
    if native.available and len(queries) > 1:
        hp, hc, qoffs, ucnt, max_c = native.many2all_probe(
            queries, kmers, pids32, db.n_patterns)
        for q in range(len(queries)):
            o = int(qoffs[q])
            u = int(ucnt[q])
            probes.append((hp[o:o + u], hc[o:o + u]))
        probes.flat = (hp, hc, qoffs, ucnt)
        return probes, max_c
    max_c = 1
    for q in queries:
        hit = np.sort(native.one2all_probe(
            np.ascontiguousarray(q), kmers, pids32)) \
            if native.available else _probe_fallback(db, q)
        hp, cnts = _run_length_counts(hit)
        probes.append((hp, cnts))
        if cnts.size:
            max_c = max(max_c, int(cnts.max()))
    return probes, max_c


def _probe_fallback(db: KmerPatternDb, q: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(db.kmers, q)
    idx[idx >= db.n_kmers] = db.n_kmers - 1
    found = db.kmers[idx] == q
    return np.sort(db.kmer_pattern_ids[idx[found]])


def _m2a_host_apply(db: KmerPatternDb, probes, S: int) -> np.ndarray:
    """Host CSR apply of pre-computed probe results (the one2all_counts
    tail, reusing probes the tier dispatch already paid for)."""
    from ..utils import native
    offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    sids = np.ascontiguousarray(db.pattern_sample_ids, dtype=np.uint32)
    flat = getattr(probes, "flat", None)
    if flat is not None and native.available:
        out = native.alloc_array(len(probes) * S, np.uint32).reshape(
            len(probes), S)
        hp, hc, qoffs, ucnt = flat
        # pattern-major for wide sample axes: each hit pattern's sample
        # list is read once for the whole batch and dense patterns
        # apply as SIMD row AXPYs (query-major re-reads lists per query
        # — 21 s of a 24 s scale new2all on the 256x4096 case; 2 s
        # pattern-major).  At small S the AXPY never engages and the
        # hit transpose is pure overhead (128-sample corpus: 0.38 s
        # query-major vs 1.1 s pattern-major), so query-major keeps
        # the narrow shapes.  KMERDB_APPLY=qmajor/pmajor forces.
        mode = os.environ.get("KMERDB_APPLY", "")
        if mode == "qmajor" or (S < 512 and mode != "pmajor"):
            native.csr_apply_many(qoffs, ucnt, hp, hc, offs, sids, out)
        else:
            native.csr_apply_patmajor(qoffs, ucnt, hp, hc, offs, sids,
                                      db.n_patterns, out)
        return out
    out = np.zeros((len(probes), S), dtype=np.uint32)
    for i, (hp, cnts) in enumerate(probes):
        if hp.size:
            native.csr_apply(np.ascontiguousarray(hp, dtype=np.int64),
                             np.ascontiguousarray(cnts, dtype=np.uint32),
                             offs, sids, out[i])
    return out


def m2a_prepare(db: KmerPatternDb, queries: list[np.ndarray],
                q_align: int | None = None, probes=None):
    """Host prep for the batched query contraction sims = H @ B.

    Returns (H_all uint32[n_chunks, Q_pad, P_pad] per-chunk hit
    counts, B_all int8[n_chunks, P_pad, S_pad] incidence blocks,
    n_limbs).  q_align overrides the Q padding multiple (a mesh shards
    the query axis); probes forwards _probe_queries output when the
    caller already ran it."""
    from ..utils import native
    from . import gram
    Q = len(queries)
    S = db.n_samples

    if probes is None:
        probes = _probe_queries(db, queries)
    probes, max_c = probes
    n_limbs = gram.n_limbs(max_c)

    offs = db.pattern_offsets
    sids = db.pattern_sample_ids
    el_pid = db.element_pattern_ids()
    P = db.n_patterns
    Q_pad = _round_up(Q, q_align or gram.PAD)
    S_pad = _round_up(S, gram.PAD)
    chunk = min(_CHUNK, max(1024, (64 << 20) // max(S_pad, Q_pad)))
    bounds = _chunk_plan(offs, P, chunk, _CHUNK_E)
    n_chunks = len(bounds) - 1
    max_pc = max(bounds[c + 1] - bounds[c] for c in range(n_chunks))
    P_pad = _round_up(max_pc, gram.PAD)

    B_all = native.alloc_array(n_chunks * P_pad * S_pad, np.int8,
                               populate=False).reshape(
                                   n_chunks, P_pad, S_pad)
    # hit counts below 256 travel as u8, quartering the device push
    h_dtype = np.uint8 if max_c < 256 else np.uint32
    H_all = native.alloc_array(
        n_chunks * Q_pad * P_pad * np.dtype(h_dtype).itemsize, np.uint8,
        populate=False).view(h_dtype).reshape(n_chunks, Q_pad, P_pad)
    for c in range(n_chunks):
        p0, p1 = bounds[c], bounds[c + 1]
        lo, hi = int(offs[p0]), int(offs[p1])
        native.fill_incidence(
            (el_pid[lo:hi] - p0).astype(np.int32),
            np.ascontiguousarray(sids[lo:hi], dtype=np.int32), B_all[c])
        for qi, (hp, hc) in enumerate(probes):
            j0, j1 = np.searchsorted(hp, [p0, p1])
            H_all[c, qi, hp[j0:j1] - p0] = hc[j0:j1]
    return H_all, B_all, n_limbs


def d2d_pairs(db_row: KmerPatternDb, db_col: KmerPatternDb):
    """Intersect the two sorted k-mer arrays and run-length-count the
    matched (pid1, pid2) pattern pairs: returns (up1, up2, counts) or
    None when the databases share no k-mers."""
    from ..utils import native
    if db_row.n_kmers == 0 or db_col.n_kmers == 0:
        return None
    if native.available:
        p1, p2 = native.intersect_probe(
            np.ascontiguousarray(db_row.kmers),
            np.ascontiguousarray(db_row.kmer_pattern_ids, dtype=np.int32),
            np.ascontiguousarray(db_col.kmers),
            np.ascontiguousarray(db_col.kmer_pattern_ids, dtype=np.int32))
    else:
        idx = np.searchsorted(db_col.kmers, db_row.kmers)
        idx[idx >= db_col.n_kmers] = db_col.n_kmers - 1
        found = db_col.kmers[idx] == db_row.kmers
        p1 = db_row.kmer_pattern_ids[found]
        p2 = db_col.kmer_pattern_ids[idx[found]]
    if p1.size == 0:
        return None
    pair = p1.astype(np.int64) * db_col.n_patterns + p2.astype(np.int64)
    pair.sort(kind="stable")
    upair, cnts = _run_length_counts(pair)
    up1 = (upair // db_col.n_patterns).astype(np.int64)
    up2 = (upair % db_col.n_patterns).astype(np.int64)
    return up1, up2, np.ascontiguousarray(cnts, dtype=np.uint32)


def db2db_counts(db_row: KmerPatternDb, db_col: KmerPatternDb) -> np.ndarray:
    """uint32[S_row, S_col] cross-database common-k-mer counts
    (reference db2db_sp, similarity_calculator.cpp:1225-1540).

    Sorted-merge intersection of the two k-mer arrays -> (pid1, pid2)
    match counts M, then C = B1^T M B2 applied through the CSRs.
    """
    from ..utils import native
    S1, S2 = db_row.n_samples, db_col.n_samples
    C = np.zeros((S1, S2), dtype=np.uint32)
    pairs = d2d_pairs(db_row, db_col)
    if pairs is None:
        return C
    up1, up2, cnts = pairs

    # device tier: pattern-pair chunks contracted as
    # C = U^T diag(counts) V through the Gram engine.  Dispatch = the
    # cost model on the EXACT pair workload (d2d_pairs already ran, so
    # both sides' work is known); KMERDB_D2D_DEVICE=1/0 forces.
    env = os.environ.get("KMERDB_D2D_DEVICE", "")
    want_device = env == "1"
    if env == "" and native.available:
        # exact host work (one |rows| x |cols| scatter per pair) is
        # known from the pair list alone — computed BEFORE touching jax
        from . import costcal
        c = costcal.resolve()
        l1 = np.diff(db_row.pattern_offsets)[up1].astype(np.float64)
        l2 = np.diff(db_col.pattern_offsets)[up2].astype(np.float64)
        host_s = float(l1 @ l2) / (c["host_rate"] if max(S1, S2) <= 1024
                                   else c["host_rate_big"])
        c = costcal.device_constants(host_s)
        if c is not None:
            from . import gram
            S1_pad = _round_up(S1, gram.PAD)
            S2_pad = _round_up(S2, gram.PAD)
            push = up1.size / 8 * (S1_pad + S2_pad)
            flops = 2.0 * up1.size * S1_pad * S2_pad * gram.n_limbs(
                int(cnts.max()))
            dev_s = (c["fixed_s"] + push / c["push_Bps"]
                     + push / c["fill_Bps"]
                     + flops / c["dev_flops"]
                     + S1 * S2 * 4 / c["pull_Bps"])
            want_device = dev_s < host_s
    if want_device:
        return _d2d_device(db_row, db_col, up1, up2,
                           np.ascontiguousarray(cnts, dtype=np.uint32))

    o1 = np.ascontiguousarray(db_row.pattern_offsets, dtype=np.int64)
    s1 = np.ascontiguousarray(db_row.pattern_sample_ids, dtype=np.uint32)
    o2 = np.ascontiguousarray(db_col.pattern_offsets, dtype=np.int64)
    s2 = np.ascontiguousarray(db_col.pattern_sample_ids, dtype=np.uint32)
    from ..utils import native
    if native.available:
        native.cross_apply(up1, up2,
                           np.ascontiguousarray(cnts, dtype=np.uint32),
                           o1, s1, o2, s2, C)
        return C
    for a, b, cnt in zip(up1, up2, cnts):
        rows = s1[o1[a]:o1[a + 1]]
        cols = s2[o2[b]:o2[b + 1]]
        C[np.ix_(rows, cols)] += np.uint32(cnt)
    return C
