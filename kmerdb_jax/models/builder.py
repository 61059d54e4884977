"""Batch database construction via merge + segment ops.

The reference inserts samples one at a time into per-prefix hashtables
and forks/extends patterns behind atomic counters
(prefix_kmer_db.cpp:244-434).  That fork-or-extend chain is inherently
sequential per sample (SURVEY hard-part #2).  Here the problem is
re-expressed as a *batch* computation over sorted streams:

1. element streams: the existing database contributes (kmer,
   PATTERN_REF + old_pattern_id) per k-mer; each new sample contributes
   (kmer, sample_id) — all streams already sorted by k-mer;
2. a pairwise merge tree fuses the streams; each distinct k-mer becomes
   a contiguous group: [optional old-pattern ref] + new sample ids
   ascending (stable tie-break by stream order);
3. the group *content* IS the k-mer's new sample-set; groups are
   deduplicated by order-invariant 128-bit set hashing -> pattern ids;
4. pattern CSR = representative group expanded (old pattern's sample
   list ++ new sample ids); pattern weight w_p = #groups mapping to p.

The k-mer key space is processed in *partitions* (quantile ranges) with
pooled scratch buffers: peak unique memory stays small (fresh pages are
~50us each on some sandboxed hosts) and the same partitioning is the
multi-host shard axis (SURVEY §7: prefix-range sharding).  Pattern
dedup is partition-local; a sample-set spanning partitions yields
duplicate patterns, which is harmless: patterns with equal incidence
contribute additively to every count downstream.

The result is semantically identical to the reference's pattern forest
after the same samples are added in the same order: a pattern is the
exact set of samples sharing a k-mer.
"""

import numpy as np

from .database import KmerPatternDb
from ..utils import native

#: virtual-id offset marking "reference to an existing pattern"
#: (NumPy fallback path: 64-bit values)
_PATTERN_REF = np.int64(1) << np.int64(33)
#: native path: values are uint32 — high bit marks a pattern reference
#: (pattern ids and sample ids both stay < 2^31)
_PATTERN_REF32 = np.uint32(1) << np.uint32(31)

_SALT1 = np.uint64(0x9E3779B97F4A7C15)
_SALT2 = np.uint64(0xC2B2AE3D27D4EB4F)

def _build_device() -> bool:
    """KMERDB_BUILD_DEVICE=1 routes the per-partition merge + dedup to
    the device (ops/device_build.py), bit-identical to the host path."""
    import os
    return os.environ.get("KMERDB_BUILD_DEVICE") == "1"


#: target element count per partition (quantile range of k-mer space).
#: merge_groups buckets internally (cache-sized key ranges), so the
#: partition's job is to bound peak scratch memory — and with it the
#: page-provisioning cost, which on sandboxed hosts (~30us/page however
#: provisioned) dominates the cold first build.  Scratch pools are
#: reused across partitions, so smaller partitions = fewer unique pages;
#: 8M elements (~128 MB arena) measured fastest cold on the bench host.
_PARTITION_ELEMS = 8_000_000


def _mix64(x: np.ndarray, salt: np.uint64) -> np.ndarray:
    """splitmix64-style finalizer for set hashing (not parity-relevant)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + salt
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _ragged_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat source indices of concatenated slices src[starts[i]:+lens[i]]."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(lens)
    begins = ends - lens
    return (np.arange(total, dtype=np.int64)
            + np.repeat(starts.astype(np.int64) - begins, lens))


def _dedup_groups(glens: np.ndarray, h1: np.ndarray, h2: np.ndarray):
    """Group dedup by order-invariant set hash -> local pattern ids.

    Sort groups by a combined 64-bit hash, then cut runs on any change
    of (comb, h1, h2, len).  A rare comb collision between different
    sets only *splits* a pattern (same incidence, weights still sum):
    harmless for every downstream count.  Merging distinct sets would
    need a full (h1, h2, len) collision (~2^-128): ignored.

    Returns (inverse i64[G] group -> pid, first_group i64[P]).
    """
    G = glens.size
    if native.available:
        return native.dedup_groups(
            np.ascontiguousarray(h1, dtype=np.uint64),
            np.ascontiguousarray(h2, dtype=np.uint64),
            np.ascontiguousarray(glens.view(np.uint64) if
                                 glens.dtype == np.int64 else
                                 glens.astype(np.uint64)))
    with np.errstate(over="ignore"):
        comb = _mix64(h1 ^ ((h2 << np.uint64(17)) | (h2 >> np.uint64(47)))
                      ^ glens.astype(np.uint64), _SALT1)
    o = np.argsort(comb, kind="stable")
    comb = comb[o]
    gidx = o.astype(np.int64)
    h1s, h2s, lens_s = h1[gidx], h2[gidx], glens[gidx]
    boundary = np.empty(G, dtype=bool)
    boundary[0] = True
    boundary[1:] = ((comb[1:] != comb[:-1]) | (h1s[1:] != h1s[:-1])
                    | (h2s[1:] != h2s[:-1]) | (lens_s[1:] != lens_s[:-1]))
    pid_sorted = np.cumsum(boundary) - 1
    inverse = np.empty(G, dtype=np.int64)
    inverse[gidx] = pid_sorted
    first_group = gidx[boundary]
    return inverse, first_group


def _partition_edges(key_streams: list[np.ndarray], n_parts: int) -> np.ndarray:
    """Approximate quantile edges of the merged key distribution."""
    if n_parts <= 1:
        return np.empty(0, dtype=np.uint64)
    picks = []
    for s in key_streams:
        if s.size:
            stride = max(1, s.size // 2048)
            picks.append(s[::stride])
    sample = np.sort(np.concatenate(picks))
    idx = (np.arange(1, n_parts) * sample.size) // n_parts
    return np.unique(sample[idx])


def _partition_cuts(key_streams: list[np.ndarray],
                    edges: np.ndarray) -> np.ndarray:
    """cuts[i, p]:cuts[i, p+1] = stream i's slice for partition p of
    the `edges` ranges (side='left': keys equal to an edge open the
    NEXT partition, so a k-mer group never straddles two partitions).
    Single source of truth for the merge partitioning — add_samples,
    sharded.build_sharded and fused._merged_partitions must slice the
    streams identically or their byte-parity contracts diverge."""
    cuts = np.empty((len(key_streams), edges.size + 2), dtype=np.int64)
    for i, s in enumerate(key_streams):
        cuts[i, 0] = 0
        cuts[i, -1] = s.size
        cuts[i, 1:-1] = np.searchsorted(s, edges, side="left")
    return cuts


def add_samples(db: KmerPatternDb,
                samples: list[tuple[str, np.ndarray]]) -> KmerPatternDb:
    """Add a batch of (name, sorted-unique-kmer-array) samples.

    Returns a new KmerPatternDb; `db` itself is not mutated.  Covers
    both initial build and -extend (console_build.cpp:48-57): extending
    is just adding a batch to a non-empty database.
    """
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
            start_fraction=db.start_fraction, alphabet_name=db.alphabet_name,
            sample_names=names, sample_kmer_counts=counts)

    key_streams = [db.kmers] + [arr for _, arr in samples]
    old_off = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    if old_off.size < 2:
        old_off = np.zeros(2, dtype=np.int64)
    old_sids = np.ascontiguousarray(db.pattern_sample_ids, dtype=np.uint32)

    if native.available:
        # names already holds old + new samples, so its length IS the
        # total sample count after this batch
        if db.n_patterns >= (1 << 31) or len(names) >= (1 << 31):
            raise OverflowError("pattern/sample ids exceed 2^31")
        old_vals = (_PATTERN_REF32
                    | db.kmer_pattern_ids.astype(np.uint32))
        n_parts = max(1, -(-total // _PARTITION_ELEMS))
        edges = _partition_edges(key_streams, n_parts)
        cuts = _partition_cuts(key_streams, edges)

        parts = _Parts()

        def partition_slices():
            for part in range(edges.size + 1):
                sliced_k, sliced_v, cvals = [], [], []
                for i, s in enumerate(key_streams):
                    lo, hi = int(cuts[i, part]), int(cuts[i, part + 1])
                    if hi <= lo:
                        continue
                    sliced_k.append(s[lo:hi])
                    sliced_v.append(old_vals[lo:hi] if i == 0 else None)
                    cvals.append(0 if i == 0 else s0 + i - 1)
                if sliced_k:
                    yield sliced_k, sliced_v, cvals

        if _build_device():
            # two-deep software pipeline: partition N's result pull
            # (host-blocking transfer, device mostly idle on slow
            # links) runs on a worker thread while the main thread
            # packs and dispatches partition N+1 (VERDICT r4 item 4)
            import concurrent.futures as cf
            from collections import deque
            from ..ops import device_build as devb
            with cf.ThreadPoolExecutor(max_workers=1) as pool:
                q = deque()
                for sk, sv, cv in partition_slices():
                    h = devb.merge_dedup_dispatch(sk, sv, cv)
                    q.append(pool.submit(devb.merge_dedup_finish, h))
                    while len(q) > 1:
                        parts.add(q.popleft().result(), old_off,
                                  old_sids)
                while q:
                    parts.add(q.popleft().result(), old_off, old_sids)
        else:
            for sk, sv, cv in partition_slices():
                merged_vals, gk, gstart, glen_u, h1, h2 = \
                    native.merge_groups(sk, sv, cv, scratch=True)
                inverse, first_group = _dedup_groups(glen_u, h1, h2)
                parts.add((merged_vals, gk, gstart, glen_u, h1, h2,
                           inverse, first_group), old_off, old_sids)

        return _finalize_db(db, names, counts, parts)

    # NumPy fallback (no compiler): single partition, argsort + reduceat
    streams_v = [_PATTERN_REF + db.kmer_pattern_ids.astype(np.int64)]
    for i, (_, arr) in enumerate(samples):
        streams_v.append(np.full(arr.size, s0 + i, dtype=np.int64))
    return _numpy_build(db, names, counts, key_streams, streams_v)


class _Parts:
    """Per-partition accumulator shared by add_samples and the
    k-mer-range-sharded build (parallel/sharded.py)."""

    def __init__(self):
        self.uk, self.pid, self.w = [], [], []
        self.offlen, self.flat = [], []
        self.trip = []  # (h1, h2, rawlen) per pattern, for global dedup
        self.pid_base = 0

    def add(self, merge_out, old_off, old_sids):
        (merged_vals, gk, gstart, glen_u, h1, h2,
         inverse, first_group) = merge_out
        n_pat = first_group.size

        rep_start = np.ascontiguousarray(gstart[first_group])
        rep_len_u = np.ascontiguousarray(glen_u[first_group])
        out_len = native.csr_lengths(rep_start, rep_len_u, merged_vals,
                                     int(_PATTERN_REF32), old_off)
        p_off = np.zeros(n_pat + 1, dtype=np.int64)
        np.cumsum(out_len, out=p_off[1:])
        flat = np.empty(p_off[-1], dtype=np.uint32)
        native.fill_csr(rep_start, rep_len_u, merged_vals,
                        int(_PATTERN_REF32), old_off, old_sids,
                        p_off[:-1].copy(), flat)

        self.uk.append(gk.copy())
        self.pid.append((inverse + self.pid_base).astype(np.int32))
        self.w.append(np.bincount(inverse, minlength=n_pat
                                  ).astype(np.uint32))
        self.offlen.append(out_len)
        self.flat.append(flat)
        self.trip.append((h1[first_group].copy(),
                          h2[first_group].copy(),
                          glen_u[first_group].astype(np.int64)))
        self.pid_base += n_pat


def _finalize_db(db, names, counts, parts: "_Parts") -> KmerPatternDb:
    uk_parts, pid_parts, w_parts = parts.uk, parts.pid, parts.w
    offlen_parts, flat_parts = parts.offlen, parts.flat
    trip_parts, pid_base = parts.trip, parts.pid_base
    unique_kmers = np.concatenate(uk_parts)
    kmer_pattern_ids = np.concatenate(pid_parts)
    pattern_num_kmers = np.concatenate(w_parts)
    all_len = np.concatenate(offlen_parts)
    flat = np.concatenate(flat_parts)

    if len(trip_parts) > 1:
        # Global pattern dedup: a sample-set spanning partitions was
        # assigned one pattern per partition; unify by the same
        # (h1, h2, rawlen) content key and merge the weights.
        H1 = np.concatenate([t[0] for t in trip_parts])
        H2 = np.concatenate([t[1] for t in trip_parts])
        LEN = np.concatenate([t[2] for t in trip_parts])
        inv2, first2 = _dedup_groups(LEN, H1, H2)
        if first2.size < pid_base:
            kmer_pattern_ids = inv2[kmer_pattern_ids].astype(np.int32)
            w = np.zeros(first2.size, dtype=np.uint64)
            np.add.at(w, inv2, pattern_num_kmers.astype(np.uint64))
            pattern_num_kmers = w.astype(np.uint32)
            old_offsets_all = np.zeros(all_len.size + 1, dtype=np.int64)
            np.cumsum(all_len, out=old_offsets_all[1:])
            keep_len = all_len[first2]
            out_off = np.zeros(first2.size + 1, dtype=np.int64)
            np.cumsum(keep_len, out=out_off[1:])
            new_flat = np.empty(out_off[-1], dtype=np.uint32)
            native.gather_ragged_u32(
                np.ascontiguousarray(first2),
                old_offsets_all, np.ascontiguousarray(flat),
                out_off[:-1].copy(), new_flat)
            flat = new_flat
            all_len = keep_len

    pattern_offsets = np.zeros(all_len.size + 1, dtype=np.int64)
    np.cumsum(all_len, out=pattern_offsets[1:])
    return KmerPatternDb(
        kmer_length=db.kmer_length, fraction=db.fraction,
        start_fraction=db.start_fraction, alphabet_name=db.alphabet_name,
        sample_names=names, sample_kmer_counts=counts,
        kmers=unique_kmers, kmer_pattern_ids=kmer_pattern_ids,
        pattern_offsets=pattern_offsets, pattern_sample_ids=flat,
        pattern_num_kmers=pattern_num_kmers)

def _numpy_build(db, names, counts, key_streams, streams_v):
    """NumPy fallback (no compiler): single partition, argsort +
    reduceat."""
    old_off = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    if old_off.size < 2:
        old_off = np.zeros(2, dtype=np.int64)
    all_k = np.concatenate(key_streams)
    all_v = np.concatenate(streams_v)
    order = np.argsort(all_k, kind="stable")
    sk = all_k[order]
    sv = all_v[order]
    new_group = np.empty(sk.size, dtype=bool)
    new_group[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new_group[1:])
    starts = np.flatnonzero(new_group)
    glens = np.diff(np.append(starts, sk.size))
    m1 = _mix64(sv.view(np.uint64), _SALT1)
    m2 = _mix64(sv.view(np.uint64), _SALT2)
    h1 = np.bitwise_xor.reduceat(m1, starts)
    with np.errstate(over="ignore"):
        h2 = np.add.reduceat(m2, starts)
    unique_kmers = sk[starts]

    inverse, first_group = _dedup_groups(glens, h1, h2)
    n_patterns = first_group.size
    kmer_pattern_ids = inverse.astype(np.int32)
    pattern_num_kmers = np.bincount(inverse, minlength=n_patterns
                                    ).astype(np.uint32)

    rep_start = starts[first_group]
    rep_len = glens[first_group]
    has_old = sv[rep_start] >= _PATTERN_REF
    old_pid = np.where(has_old, sv[rep_start] - _PATTERN_REF, 0
                       ).astype(np.int64)
    old_len = np.where(has_old, old_off[old_pid + 1] - old_off[old_pid], 0)
    new_len = rep_len - has_old
    out_len = old_len + new_len

    pattern_offsets = np.zeros(n_patterns + 1, dtype=np.int64)
    np.cumsum(out_len, out=pattern_offsets[1:])
    flat = np.empty(pattern_offsets[-1], dtype=np.uint32)

    src_old = _ragged_indices(old_off[old_pid], old_len)
    dst_old = _ragged_indices(pattern_offsets[:-1], old_len)
    flat[dst_old] = db.pattern_sample_ids[src_old]
    src_new = _ragged_indices(rep_start + has_old, new_len)
    dst_new = _ragged_indices(pattern_offsets[:-1] + old_len, new_len)
    flat[dst_new] = sv[src_new].astype(np.uint32)

    return KmerPatternDb(
        kmer_length=db.kmer_length, fraction=db.fraction,
        start_fraction=db.start_fraction, alphabet_name=db.alphabet_name,
        sample_names=names, sample_kmer_counts=counts,
        kmers=unique_kmers, kmer_pattern_ids=kmer_pattern_ids,
        pattern_offsets=pattern_offsets, pattern_sample_ids=flat,
        pattern_num_kmers=pattern_num_kmers)
