"""Sharded kernels: pattern-sharded all2all with psum merging.

The dense all2all decomposes over patterns: C = sum_p w_p b_p b_p^T.
Sharding the pattern axis across devices makes every device compute a
partial C over its pattern slice; a single psum over the mesh axis
merges partials (uint32 adds are associative, so the reduction is
exact and order-independent — SURVEY hard-part #6).  This replaces the
reference's row-ownership thread partitioning
(similarity_calculator.cpp:371-399) with a collective (NCCL on GPUs).
Every local contraction runs through the Gram engine (ops/gram.py).
"""

import functools

import numpy as np

from .._jaxinit import jax_modules

jax, jnp = jax_modules()  # configures x64 + compile cache
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models.database import KmerPatternDb
from ..ops import gram

#: pattern pairs per db2db device sub-chunk (bounds the host-built
#: int8 pair incidence)
_SUB = 32768


def _multiproc() -> bool:
    return jax.process_count() > 1


def _to_global(arr_np, mesh: Mesh, spec):
    """Full-size host array -> jax.Array laid out per `spec` on the
    mesh.  Single-process: a plain device array (jit shards it).
    Multi-process (jax.distributed): each process contributes ONLY its
    slice along the sharded axis — the host-sharded ingest contract
    (no host ever materializes another host's device rows on the DCN
    path) — and host_local_array_to_global_array assembles the global
    array."""
    if not _multiproc():
        return jnp.asarray(arr_np)
    from jax.experimental import multihost_utils
    axis = next((i for i, s in enumerate(spec) if s is not None), None)
    if axis is None:        # replicated operand: same value everywhere
        return multihost_utils.host_local_array_to_global_array(
            arr_np, mesh, spec)
    nproc = jax.process_count()
    per_proc = arr_np.shape[axis] // nproc
    pid = jax.process_index()
    sl = [slice(None)] * arr_np.ndim
    sl[axis] = slice(pid * per_proc, (pid + 1) * per_proc)
    return multihost_utils.host_local_array_to_global_array(
        np.ascontiguousarray(arr_np[tuple(sl)]), mesh, spec)


def _collect(x, replicated: bool = True):
    """Global jax.Array -> full numpy on EVERY process.  Replicated
    outputs read their local copy; sharded outputs allgather across
    processes (multihost_utils.process_allgather jits an identity with
    replicated out-sharding, so the exchange rides the same collective
    path as the compute)."""
    if not _multiproc():
        return np.asarray(x)
    if replicated:
        return np.asarray(x.addressable_data(0))
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _varying(C):
    """Mark a shard_map carry as varying over the shard axis (it
    accumulates shard-local rows); plain zeros are typed unvarying."""
    try:
        return jax.lax.pcast(C, ("shard",), to="varying")
    except (AttributeError, TypeError):
        return jax.lax.pvary(C, ("shard",))


@functools.partial(jax.jit, static_argnames=("mesh", "n_limbs"))
def _a2a_sharded(B_all, w_full, *, mesh, n_limbs):
    def step(B_l, w_l):
        S = B_l.shape[2]
        C = gram.weighted_cross(_varying(jnp.zeros((S, S), jnp.uint32)),
                                B_l[0], B_l[0], w_l[0], n_limbs=n_limbs)
        return jax.lax.psum(C, "shard")

    return shard_map(
        step, mesh=mesh,
        in_specs=(P("shard"), P("shard")),
        out_specs=P())(B_all, w_full)


@functools.partial(jax.jit, static_argnames=("mesh", "n_limbs"))
def _m2a_sharded(H_all, B_all, *, mesh, n_limbs):
    def step(H_l, B_l):
        C0 = _varying(jnp.zeros((H_l.shape[1], B_l.shape[2]), jnp.uint32))

        def body(C, chunk):
            H, B = chunk
            return gram.hits_matmul(C, H, B, n_limbs=n_limbs), None

        C, _ = jax.lax.scan(body, C0, (H_l, B_l))
        return C

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(None, "shard", None), P()),
        out_specs=P("shard", None))(H_all, B_all)


def many2all_counts_sharded(db: KmerPatternDb, queries, mesh: Mesh
                            ) -> np.ndarray:
    """Query-sharded batched new2all: the query axis of the hit matrix
    H is split across the mesh (the reference's per-query worker
    threads, console_new2all.cpp:64-95, as SPMD); the incidence blocks
    B are replicated; each device contracts its query rows."""
    from ..ops import intersect
    from ..utils import native
    Q = len(queries)
    S = db.n_samples
    if Q == 0 or S == 0 or db.n_patterns == 0:
        return np.zeros((Q, S), dtype=np.uint32)
    if not native.available:
        # m2a_prepare needs the C probes; the per-query NumPy path is
        # the portable fallback (results identical)
        return intersect.many2all_counts(db, queries, use_device=False)
    D = mesh.devices.size
    # q_align must also divide by process count under jax.distributed
    # (each process contributes its query-row slice)
    H_all, B_all, n_limbs = intersect.m2a_prepare(
        db, queries, q_align=D * 8)
    C = _m2a_sharded(_to_global(H_all, mesh, P(None, "shard", None)),
                     _to_global(B_all, mesh, P()),
                     mesh=mesh, n_limbs=n_limbs)
    return _collect(C, replicated=False)[:Q, :S]


@functools.partial(jax.jit, static_argnames=("mesh", "n_limbs"))
def _d2d_sharded(U_all, V_all, w_all, *, mesh, n_limbs):
    def step(U_l, V_l, w_l):
        # drop the size-1 shard axis: [sub, 1, P, S] -> [sub, P, S]
        U_l, V_l, w_l = U_l[:, 0], V_l[:, 0], w_l[:, 0]
        C0 = _varying(jnp.zeros((U_l.shape[2], V_l.shape[2]), jnp.uint32))

        def body(C, chunk):
            U, V, w = chunk
            return gram.weighted_cross(C, U, V, w, n_limbs=n_limbs), None

        C, _ = jax.lax.scan(body, C0, (U_l, V_l, w_l))
        return jax.lax.psum(C, "shard")

    return shard_map(
        step, mesh=mesh,
        in_specs=(P(None, "shard"), P(None, "shard"), P(None, "shard")),
        out_specs=P())(U_all, V_all, w_all)


def db2db_counts_sharded(db_row: KmerPatternDb, db_col: KmerPatternDb,
                         mesh: Mesh) -> np.ndarray:
    """Pattern-pair-sharded cross-database counts: the intersecting
    (p1, p2) pair list is split across the mesh, each device contracts
    its pairs as C_partial = U^T diag(m) V, and one psum merges
    (uint32: exact, order-free) — the reference's double-buffered
    decompressor/worker teams (similarity_calculator.cpp:1340-1529)
    as SPMD."""
    from ..ops import intersect
    from ..utils import native
    S1, S2 = db_row.n_samples, db_col.n_samples
    C = np.zeros((S1, S2), dtype=np.uint32)
    pairs = intersect.d2d_pairs(db_row, db_col)
    if pairs is None:
        return C
    if not native.available:
        return intersect.db2db_counts(db_row, db_col)
    up1, up2, cnts = pairs
    D = mesh.devices.size
    n_pairs = up1.size
    # per-device pair budget, sub-chunked at _SUB pairs
    per_dev = -(-n_pairs // D)
    P_pad = gram.round_up(min(_SUB, max(128, per_dev)), gram.PAD)
    sub = -(-per_dev // P_pad)
    total = D * sub * P_pad
    up1_p = np.zeros(total, dtype=np.int64)
    up2_p = np.zeros(total, dtype=np.int64)
    w_p = np.zeros(total, dtype=np.uint32)
    up1_p[:n_pairs] = up1
    up2_p[:n_pairs] = up2
    w_p[:n_pairs] = cnts
    S1_pad = gram.round_up(S1, gram.PAD)
    S2_pad = gram.round_up(S2, gram.PAD)
    o1 = np.ascontiguousarray(db_row.pattern_offsets, dtype=np.int64)
    s1 = np.ascontiguousarray(db_row.pattern_sample_ids, dtype=np.uint32)
    o2 = np.ascontiguousarray(db_col.pattern_offsets, dtype=np.int64)
    s2 = np.ascontiguousarray(db_col.pattern_sample_ids, dtype=np.uint32)
    U_all = intersect._gathered_incidence(
        up1_p, o1, s1, D * sub, P_pad, S1_pad).reshape(
            D, sub, P_pad, S1_pad).transpose(1, 0, 2, 3)
    V_all = intersect._gathered_incidence(
        up2_p, o2, s2, D * sub, P_pad, S2_pad).reshape(
            D, sub, P_pad, S2_pad).transpose(1, 0, 2, 3)
    w_all = w_p.reshape(D, sub, P_pad).transpose(1, 0, 2)
    n_limbs = gram.n_limbs(int(cnts.max()))
    C = _d2d_sharded(_to_global(U_all, mesh, P(None, "shard")),
                     _to_global(V_all, mesh, P(None, "shard")),
                     _to_global(w_all, mesh, P(None, "shard")),
                     mesh=mesh, n_limbs=n_limbs)
    return _collect(C)[:S1, :S2]


def extract_sharded(seqs, lengths, k: int, alphabet_name: str, mesh: Mesh,
                    fraction: float = 1.0, start: float = 0.0):
    """Data-parallel k-mer extraction: the padded contig batch is
    sharded over the mesh's sample axis (the reference's reader-thread
    pool, loader_ex.cpp:62-66, as SPMD)."""
    from ..ops.extract import _extract_block_jit

    def step(seqs_l, lens_l):
        return _extract_block_jit(seqs_l, lens_l, k=k,
                                  alphabet_name=alphabet_name,
                                  fraction=fraction, start=start)

    fn = shard_map(step, mesh=mesh, in_specs=(P("shard"), P("shard")),
                   out_specs=P("shard"))
    if _multiproc():
        out = fn(_to_global(np.asarray(seqs), mesh, P("shard")),
                 _to_global(np.asarray(lengths), mesh, P("shard")))
        return _collect(out, replicated=False)
    return fn(seqs, lengths)


def all2all_counts_sharded(db: KmerPatternDb, mesh: Mesh) -> np.ndarray:
    """Multi-device all2all: patterns split into one slice per device,
    each slice padded to common geometry; partial counts psum-merged."""
    S = db.n_samples
    D = mesh.devices.size
    P_n = db.n_patterns
    if P_n == 0 or S == 0:
        return np.zeros((S, S), dtype=np.uint32)

    offs = db.pattern_offsets
    el_pid = db.element_pattern_ids()
    sids = db.pattern_sample_ids
    w = db.pattern_num_kmers
    n_limbs = gram.n_limbs(int(w.max()))

    per_dev = (P_n + D - 1) // D
    bounds = [min(P_n, d * per_dev) for d in range(D + 1)]

    from ..utils import native
    B_all = np.zeros((D, per_dev, S), dtype=np.int8)
    w_all = np.zeros((D, per_dev), dtype=np.uint32)
    for d in range(D):
        p0, p1 = bounds[d], bounds[d + 1]
        lo, hi = int(offs[p0]), int(offs[p1])
        rows_d = (el_pid[lo:hi] - p0).astype(np.int32)
        cols_d = np.ascontiguousarray(sids[lo:hi], dtype=np.int32)
        if native.available:
            native.fill_incidence(rows_d, cols_d, B_all[d])
        else:
            B_all[d][rows_d, cols_d] = 1
        w_all[d, :p1 - p0] = w[p0:p1]

    C = _a2a_sharded(_to_global(B_all, mesh, P("shard")),
                     _to_global(w_all, mesh, P("shard")), mesh=mesh,
                     n_limbs=n_limbs)
    return _collect(C)


# ---------------------------------------------------------------------------
# Row-stripe-sharded streaming all2all (mesh x streaming composition)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(1,),
                   static_argnames=("mesh", "n_limbs"))
def _rows_sharded_step(row0_all, C_all, Bp, w, *, mesh, n_limbs):
    """One (round, group) update: device d accumulates its row stripe
    [row0_all[d], +stripe_rows) of the packed Gram.  The incidence is
    replicated (every stripe reads all patterns — the reference's
    row-ownership threads share the DB the same way,
    similarity_calculator.cpp:371-399); only C is sharded, so no psum
    and no full-C materialization anywhere."""
    def step(row0_l, C_l, Bp_l, w_l):
        return gram.packed_gram_rows(C_l, Bp_l, w_l, row0_l[0],
                                     n_limbs=n_limbs)

    return shard_map(
        step, mesh=mesh,
        in_specs=(P("shard"), P("shard"), P(), P()),
        out_specs=P("shard"))(row0_all, C_all, Bp, w)


@functools.partial(jax.jit, static_argnames=("mesh", "dtype"))
def _pull_sharded(C_all, lo, hi, *, mesh, dtype):
    """Device-side inclusive-bounds filter + narrowing per stripe
    shard: non-survivor cells are zeroed (and optionally u16-narrowed)
    on the device, so the pulled stripes carry only survivors."""
    def step(C_l, lo_l, hi_l):
        return gram.filter_narrow(C_l, lo_l, hi_l, dtype=dtype)

    return shard_map(step, mesh=mesh, in_specs=(P("shard"), P(), P()),
                     out_specs=P("shard"))(C_all, lo, hi)


def all2all_rows_sharded(db: KmerPatternDb, mesh: Mesh, row_handler,
                         stripe_rows: int | None = None,
                         cell_bounds: tuple | None = None) -> None:
    """Streamed multi-device all2all: row-stripe ownership over the
    mesh.  Every device computes the full-K Gram for its stripe rows
    (packed incidence replicated, C sharded by rows, NO psum of a full
    C), each round's stripes are pulled u16-narrowed and handed to
    row_handler(i, uint32[S]) in global row order — so `-mesh N` and
    the large-S streaming memory story compose: per-device memory is
    bounded by ONE stripe regardless of S.

    cell_bounds=(lo, hi): sparse-output mode — the inclusive count
    filter runs ON DEVICE per stripe shard (_pull_sharded), so pulled
    stripes carry zeros outside the bounds (same handed-row contract as
    the single-device tier; reference role SparseMatrix::compact2,
    src/array.h:392-446).

    Reference role: the row-ownership split of
    src/similarity_calculator.cpp:371-399 laid over the mesh axis
    instead of a thread pool; the stripe streaming plays
    console_all2all_parts.cpp:294-315's bounded-memory role.
    """
    import os
    from ..ops import device_a2a

    S = db.n_samples
    if S == 0:
        return
    S_pad = gram.round_up(S, gram.PAD)
    nt = S_pad // gram.PAD
    D = int(mesh.devices.size)
    groups, group_rows, _, _, _ = device_a2a._group_plan(
        db.pattern_num_kmers, S_pad)

    if stripe_rows is None:
        stripe_rows = max(gram.PAD, ((128 << 20) // (S_pad * 4))
                          // gram.PAD * gram.PAD)
    nrt = max(1, min(nt, stripe_rows // gram.PAD))
    stripe_rows = nrt * gram.PAD

    packer = device_a2a._Packer(
        db, S_pad, group_rows, put=lambda a: _to_global(a, mesh, P()))
    resident_mb = int(os.environ.get("KMERDB_A2A_RESIDENT_MB", "4096"))
    total_packed = sum(rows // 8 * S_pad for _, _, rows in groups)
    # the incidence is replicated: every device holds the whole set
    resident = total_packed <= (resident_mb << 20)
    dev_groups = [(packer(gp, rows), nl) for gp, nl, rows in groups] \
        if resident else None

    lo, hi = cell_bounds if cell_bounds is not None else (0, 0xFFFFFFFF)
    lo = _to_global(np.uint32(lo), mesh, P())
    hi = _to_global(np.uint32(hi), mesh, P())

    next_row = 0
    for r0 in range(0, nt, D * nrt):
        # device d owns tiles [rt0[d], rt0[d]+nrt); the tail round
        # clamps backwards (duplicate rows are skipped via next_row)
        rt0 = np.minimum(r0 + np.arange(D, dtype=np.int32) * nrt,
                         nt - nrt).astype(np.int32)
        C = _to_global(np.zeros((D * stripe_rows, S_pad),
                                dtype=np.uint32), mesh, P("shard"))
        row0 = _to_global(rt0 * gram.PAD, mesh, P("shard"))
        it = dev_groups if resident else (
            (packer(gp, rows), nl) for gp, nl, rows in groups)
        for (Bp, wg), nl in it:
            C = _rows_sharded_step(row0, C, Bp, wg, mesh=mesh, n_limbs=nl)
        C = _pull_sharded(C, lo, hi, mesh=mesh,
                          dtype=gram.narrow_dtype(C, lo, hi))
        out = _collect(C, replicated=False).astype(np.uint32,
                                                   copy=False)
        for d in range(D):
            base = int(rt0[d]) * gram.PAD
            stripe = out[d * stripe_rows:(d + 1) * stripe_rows]
            for i in range(max(next_row, base),
                           min(base + stripe_rows, S)):
                row_handler(i, stripe[i - base, :S])
            next_row = max(next_row, min(base + stripe_rows, S))
        if next_row >= S:
            break


# ---------------------------------------------------------------------------
# K-mer-range-sharded database build
# ---------------------------------------------------------------------------

def build_sharded(db: KmerPatternDb, samples, mesh: Mesh) -> KmerPatternDb:
    """Multi-device database build sharded by k-mer range.

    The key space is cut at quantile edges into one range per device;
    every device runs the merge + set-hash dedup kernel
    (ops/device_build._merge_dedup_impl) on its range via shard_map,
    and the host assembles the per-range outputs in range order —
    exactly the partition pipeline of models/builder.add_samples, so
    the result is bit-identical to a single-host build with the same
    partition count.  This is the prefix-range shard axis the
    reference scales builds with (SURVEY §7.2 step 3; reference write
    path src/prefix_kmer_db.cpp:244-434).
    """
    from ..models import builder
    from ..ops import device_build

    D = int(mesh.devices.size)
    s0 = db.n_samples
    names = list(db.sample_names) + [name for name, _ in samples]
    counts = np.concatenate([
        db.sample_kmer_counts,
        np.array([arr.size for _, arr in samples], dtype=np.uint32),
    ])
    total = db.n_kmers + int(sum(arr.size for _, arr in samples))
    if total == 0:
        return KmerPatternDb(
            kmer_length=db.kmer_length, fraction=db.fraction,
            start_fraction=db.start_fraction,
            alphabet_name=db.alphabet_name,
            sample_names=names, sample_kmer_counts=counts)

    key_streams = [db.kmers] + [arr for _, arr in samples]
    old_off = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    if old_off.size < 2:
        old_off = np.zeros(2, dtype=np.int64)
    old_sids = np.ascontiguousarray(db.pattern_sample_ids,
                                    dtype=np.uint32)
    old_vals = (builder._PATTERN_REF32
                | db.kmer_pattern_ids.astype(np.uint32))

    edges = builder._partition_edges(key_streams, D)
    cuts = builder._partition_cuts(key_streams, edges)

    # pack every range into a common [D, N_pad] layout (empty ranges
    # pad with the sentinel key and produce zero groups)
    ranges = []
    for part in range(edges.size + 1):
        sliced_k, sliced_v, cvals = [], [], []
        for i, s in enumerate(key_streams):
            lo, hi = int(cuts[i, part]), int(cuts[i, part + 1])
            if hi <= lo:
                continue
            sliced_k.append(s[lo:hi])
            sliced_v.append(old_vals[lo:hi] if i == 0 else None)
            cvals.append(0 if i == 0 else s0 + i - 1)
        ranges.append((sliced_k, sliced_v, cvals))
    while len(ranges) < D:
        ranges.append(([], [], []))

    N_pad = device_build._next_pow2(max(
        max((sum(s.size for s in r[0]) for r in ranges), default=1), 1))
    keys = np.full((D, N_pad), device_build._PAD_KEY, dtype=np.uint64)
    ranks = np.full((D, N_pad), len(key_streams), dtype=np.int32)
    vals = np.zeros((D, N_pad), dtype=np.uint32)
    n_valid = []
    for d, (sk, sv, cv) in enumerate(ranges):
        _, _, _, nv = device_build.pack_streams(
            sk, sv, cv, N_pad, keys[d], ranks[d], vals[d])
        n_valid.append(nv)

    def body(k, r, v, nv):
        return device_build._merge_dedup_impl(k[0], r[0], v[0], nv[0])

    fn = shard_map(
        lambda k, r, v, nv: tuple(a[None] for a in body(k, r, v, nv)),
        mesh=mesh, in_specs=(P("shard"), P("shard"), P("shard"),
                             P("shard")),
        out_specs=P("shard"))
    outs = fn(_to_global(keys, mesh, P("shard")),
              _to_global(ranks, mesh, P("shard")),
              _to_global(vals, mesh, P("shard")),
              _to_global(np.asarray(n_valid, dtype=np.int64), mesh,
                         P("shard")))
    # every process assembles the full range set (allgather under
    # jax.distributed), so the resulting DB is identical everywhere
    outs = [_collect(o, replicated=False) for o in outs]

    parts = builder._Parts()
    for d in range(D):
        if n_valid[d] == 0:
            continue
        merge_out = device_build.slice_valid(
            tuple(np.asarray(o[d]) for o in outs), n_valid[d])
        parts.add(merge_out, old_off, old_sids)
    return builder._finalize_db(db, names, counts, parts)
