"""Streamed, bit-packed device tier for all2all.

The incidence ships to the device BIT-PACKED (8x fewer bytes and 8x
less host zeroing than int8), one bounded group at a time; each group
updates C through the Gram engine (ops/gram.py), which unpacks the bits
inside the jitted step.  C stays on the device and is pulled once,
narrowed to uint16 whenever every count fits.

Host RAM stays bounded: one reusable packed group buffer
(KMERDB_A2A_GROUP_MB, default 256 MB) regardless of database size.

Pattern weights are order-invariant under the Gram (C = sum_p w_p
b_p b_p^T), so patterns are partitioned into a light class (w < 128,
one 7-bit limb — the vast majority in real pangenome databases) and a
heavy class (everything else, limbed to the class max), instead of
running every pattern at the global limb count.

Reference role: the all2all similarity stage,
src/similarity_calculator.cpp:42-438 + src/simd/row_add_avx2.cpp:31-125.
"""

import os
import time

import numpy as np

from .._jaxinit import jax_modules
from ..models.database import KmerPatternDb

#: group rows are padded to this multiple (bounds the number of
#: distinct compiled shapes; a multiple of 8 for the bit packing)
ROW_ALIGN = 1024


#: per-run phase timings of the last device all2all (for bench and
#: chip_smoke: a filled dict proves the device tier ran)
last_stats: dict = {}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _s_pad(S: int) -> int:
    from .gram import PAD
    return _round_up(max(S, 1), PAD)


def _limb_split(w: np.ndarray):
    """(light_pids, heavy_pids, heavy_limbs): light patterns fit one
    7-bit limb; heavy patterns are limbed to the heavy-class max."""
    from .gram import LIMB_BITS, n_limbs
    light_mask = w < (1 << LIMB_BITS)
    light = np.flatnonzero(light_mask).astype(np.int64)
    heavy = np.flatnonzero(~light_mask).astype(np.int64)
    heavy_limbs = n_limbs(int(w[heavy].max())) if heavy.size else 0
    return light, heavy, heavy_limbs


def _group_plan(w: np.ndarray, S_pad: int):
    """[(pattern ids, limb count, padded rows)] groups bounded by
    KMERDB_A2A_GROUP_MB of packed incidence, plus the scratch rows."""
    light, heavy, heavy_limbs = _limb_split(w)
    group_bytes = int(os.environ.get("KMERDB_A2A_GROUP_MB", "256")) << 20
    group_rows = max(ROW_ALIGN, (group_bytes * 8 // S_pad)
                     // ROW_ALIGN * ROW_ALIGN)
    # no point sizing the scratch beyond the largest class
    group_rows = min(group_rows, _round_up(max(light.size, heavy.size, 1),
                                           ROW_ALIGN))
    groups = []
    for pids, n_limbs in ((light, 1), (heavy, heavy_limbs)):
        for g0 in range(0, pids.size, group_rows):
            gp = pids[g0:g0 + group_rows]
            groups.append((gp, n_limbs, _round_up(gp.size, ROW_ALIGN)))
    return groups, group_rows, light, heavy, heavy_limbs


def plan_flops(db: KmerPatternDb) -> float:
    """Integer operations of the device plan (full-square Gram)."""
    w = db.pattern_num_kmers
    if w.size == 0:
        return 0.0
    S_pad = _s_pad(db.n_samples)
    groups = _group_plan(w, S_pad)[0]
    return float(sum(2.0 * rows * S_pad * S_pad * nl
                     for _, nl, rows in groups))


def device_cost_s(db: KmerPatternDb, c: dict) -> float:
    """Predicted wall seconds of the device tier under calibrated
    constants c."""
    S_pad = _s_pad(db.n_samples)
    packed = float(db.n_patterns) * (S_pad // 8)
    pull = float(db.n_samples) ** 2 * 2
    return (c["fixed_s"]
            + plan_flops(db) / c["dev_flops"]
            + packed / c["push_Bps"]
            + packed / c["fill_Bps"]
            + pull / c["pull_Bps"])


def host_cost_s(db: KmerPatternDb) -> float:
    """Predicted wall seconds of the host C++ scatter kernel
    (host_rate_big: the scatter slows once C spills the caches)."""
    from . import costcal
    lens = np.diff(db.pattern_offsets)
    c = costcal.resolve()
    rate = (c["host_rate"] if db.n_samples <= 1024
            else c["host_rate_big"])
    return float(np.dot(lens, lens)) / rate


class _Packer:
    """Bounded host scratch that fills and pushes one group at a time.
    Pushes copy the scratch: a live view of a reused buffer must never
    reach the asynchronous device_put."""

    def __init__(self, db, S_pad, group_rows, put=None):
        from ..utils import native
        jax, _ = jax_modules()
        self.offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
        self.sids = np.ascontiguousarray(db.pattern_sample_ids,
                                         dtype=np.uint32)
        self.w = db.pattern_num_kmers
        self.buf = native.alloc_array(
            group_rows // 8 * S_pad, np.uint8, populate=False).reshape(
                group_rows // 8, S_pad) if native.available \
            else np.zeros((group_rows // 8, S_pad), np.uint8)
        self.wbuf = np.zeros(group_rows, dtype=np.uint32)
        self.put = put or jax.device_put
        self.fill_s = 0.0
        self.push_s = 0.0

    def __call__(self, gp, rows):
        """Zero the scratch, fill the pattern-axis bit-packed incidence
        and weights of patterns gp, push both (rows padded)."""
        from ..utils import native
        ta = time.perf_counter()
        buf, wbuf = self.buf, self.wbuf
        buf[:rows // 8] = 0
        wbuf[:rows] = 0
        if native.available:
            native.fill_incidence_bits(gp, self.offs, self.sids, buf)
        else:
            for i, p in enumerate(gp):
                cols = self.sids[self.offs[p]:self.offs[p + 1]]
                buf[i >> 3, cols] |= np.uint8(1 << (i & 7))
        wbuf[:gp.size] = self.w[gp]
        tb = time.perf_counter()
        out = (self.put(self.buf[:rows // 8].copy()),
               self.put(self.wbuf[:rows].copy()))
        self.fill_s += tb - ta
        self.push_s += time.perf_counter() - tb
        return out


def all2all_device_rows(db: KmerPatternDb, row_handler,
                        stripe_rows: int | None = None,
                        cell_bounds: tuple | None = None) -> None:
    """Streamed large-S device all2all: C is computed in row stripes
    (the device holds ONE stripe, never the full matrix) and each
    finished global row is handed to row_handler(i, uint32[S]) in
    order — the large-collection memory story (the reference streams
    parts rows, src/console_all2all_parts.cpp:294-315; here the stripe
    loop plays that role on one device).

    Packed incidence groups are pushed once and stay device-resident
    when they fit KMERDB_A2A_RESIDENT_MB (default 4096); above that
    they are re-packed per stripe from the bounded host scratch.

    cell_bounds=(lo, hi): sparse-output mode — the inclusive count
    filter runs ON DEVICE before the pull, so handed rows carry 0
    outside the bounds (callers' filters map those to omitted cells
    anyway; the caller must pass bounds at least as wide as its own
    count filter).  Reference role: SparseMatrix::compact2,
    src/array.h:392-446."""
    jax, jnp = jax_modules()
    from . import gram

    S = db.n_samples
    if S == 0:
        return
    S_pad = _s_pad(S)
    nt = S_pad // gram.PAD
    groups, group_rows, _, _, _ = _group_plan(db.pattern_num_kmers, S_pad)

    if stripe_rows is None:
        stripe_rows = max(gram.PAD, ((128 << 20) // (S_pad * 4))
                          // gram.PAD * gram.PAD)
    # a sub-tile request still needs one whole PAD-row stripe
    nrt = max(1, min(nt, stripe_rows // gram.PAD))
    stripe_rows = nrt * gram.PAD

    packer = _Packer(db, S_pad, group_rows)
    resident_mb = int(os.environ.get("KMERDB_A2A_RESIDENT_MB", "4096"))
    total_packed = sum(rows // 8 * S_pad for _, _, rows in groups)
    resident = total_packed <= (resident_mb << 20)
    dev_groups = [(packer(gp, rows), nl) for gp, nl, rows in groups] \
        if resident else None

    lo, hi = cell_bounds if cell_bounds is not None else (0, 0xFFFFFFFF)
    n_stripes = 0
    survivors = 0
    next_row = 0
    t0 = time.perf_counter()
    flops = 0.0
    for rt0 in range(0, nt, nrt):
        rt0 = min(rt0, nt - nrt)   # last stripe overlaps backwards
        base = rt0 * gram.PAD
        C = jnp.zeros((stripe_rows, S_pad), jnp.uint32)
        it = dev_groups if resident else (
            (packer(gp, rows), nl) for gp, nl, rows in groups)
        for (Bp, wg), nl in it:
            C = gram.rows_step(C, Bp, wg, jnp.int32(base), n_limbs=nl)
            flops += 2.0 * Bp.shape[0] * 8 * stripe_rows * S_pad * nl
        stripe = gram.pull(C, stripe_rows, S_pad, lo, hi)
        n_stripes += 1
        if cell_bounds is not None:
            survivors += int(np.count_nonzero(stripe))
        for i in range(max(next_row, base), min(base + stripe_rows, S)):
            row_handler(i, stripe[i - base, :S])
        next_row = min(base + stripe_rows, S)
        if next_row >= S:
            break

    last_stats.clear()
    last_stats.update({
        "platform": jax.default_backend(),
        "S": S, "S_pad": S_pad, "n_patterns": int(db.n_patterns),
        "streamed": True, "stripe_rows": stripe_rows,
        "resident_groups": resident, "flops": flops,
        "fill_s": packer.fill_s, "push_s": packer.push_s,
        "total_s": time.perf_counter() - t0,
    })
    if cell_bounds is not None:
        last_stats["sparse_pull"] = {"stripes": n_stripes,
                                     "survivor_cells": survivors}


def kernel_bench(db: KmerPatternDb, reps: int = 5) -> dict:
    """Isolated Gram throughput on THIS database's packed incidence,
    resident on the device: one pass is every group's gram_step into a
    resident C, synced with block_until_ready; the median of `reps`
    timed passes (after one compiling pass) is reported with its share
    of the device's published int8 peak (gram.PEAKS, keyed by
    device_kind — an unknown kind raises)."""
    jax, jnp = jax_modules()
    from . import gram

    kind = jax.devices()[0].device_kind
    peak = gram.device_peak(kind, "int8")
    S_pad = _s_pad(db.n_samples)
    groups, group_rows, _, _, _ = _group_plan(db.pattern_num_kmers, S_pad)
    packer = _Packer(db, S_pad, group_rows)
    dev_groups = [(packer(gp, rows), nl) for gp, nl, rows in groups]
    ops = float(sum(2.0 * rows * S_pad * S_pad * nl
                    for _, nl, rows in groups))

    def one_pass():
        C = jnp.zeros((S_pad, S_pad), jnp.uint32)
        t0 = time.perf_counter()
        for (Bp, wg), nl in dev_groups:
            C = gram.gram_step(C, Bp, wg, n_limbs=nl)
        C.block_until_ready()
        return time.perf_counter() - t0

    one_pass()
    per_pass = float(np.median([one_pass() for _ in range(reps)]))
    return {
        "device_kind": kind, "S_pad": S_pad,
        "ops_per_pass": ops, "s_per_pass": per_pass,
        "tops": ops / per_pass / 1e12,
        "peak_share": ops / per_pass / peak,
    }


def all2all_device(db: KmerPatternDb) -> np.ndarray:
    """Full symmetric uint32[S, S] common-k-mer matrix on the device.

    Streams bit-packed pattern groups through the Gram engine,
    accumulating C on the device; pulls C once (uint16 when every
    count fits).  KMERDB_PROFILE=<dir> writes a profiler trace of the
    call."""
    jax, jnp = jax_modules()
    prof_dir = os.environ.get("KMERDB_PROFILE")
    if prof_dir:
        jax.profiler.start_trace(prof_dir)
    try:
        return _all2all_device_inner(db, jax, jnp)
    finally:
        if prof_dir:
            jax.profiler.stop_trace()


def _all2all_device_inner(db, jax, jnp):
    from . import gram
    S = db.n_samples
    t0 = time.perf_counter()
    S_pad = _s_pad(S)
    groups, group_rows, light, heavy, heavy_limbs = _group_plan(
        db.pattern_num_kmers, S_pad)
    packer = _Packer(db, S_pad, group_rows)

    C = jnp.zeros((S_pad, S_pad), jnp.uint32)
    flops = 0.0
    for gp, nl, rows in groups:
        Bp, wg = packer(gp, rows)
        C = gram.gram_step(C, Bp, wg, n_limbs=nl)
        flops += 2.0 * rows * S_pad * S_pad * nl
    t1 = time.perf_counter()
    C.block_until_ready()
    t2 = time.perf_counter()
    out = gram.pull(C, S, S)
    t3 = time.perf_counter()

    last_stats.clear()
    last_stats.update({
        "platform": jax.default_backend(),
        "S": S, "S_pad": S_pad, "n_patterns": int(db.n_patterns),
        "light_patterns": int(light.size), "heavy_patterns": int(heavy.size),
        "heavy_limbs": heavy_limbs, "flops": flops,
        "fill_s": packer.fill_s, "push_s": packer.push_s,
        "dispatch_s": t1 - t0 - packer.fill_s - packer.push_s,
        "compute_s": t2 - t1, "pull_s": t3 - t2, "total_s": t3 - t0,
    })
    return out
