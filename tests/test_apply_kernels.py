"""csr_apply_patmajor == csr_apply_many on randomized workloads.

The pattern-major apply (native/kmerdb_native.cpp
kmerdb_csr_apply_patmajor) restructures the new2all host tail: hit
lists transpose to a pattern-major CSR, dense patterns apply as SIMD
row AXPYs, and counts accumulate in u16 when every query's total hit
count fits.  The query-major kernel (reference decode-loop role,
similarity_calculator.cpp:737-794) is the oracle.
"""

import numpy as np
import pytest

from kmerdb_jax.utils import native

pytestmark = pytest.mark.skipif(not native.available,
                                reason="native runtime unavailable")


def _random_workload(rng, Q, S, P, max_hits, max_cnt):
    """Random pattern CSR + per-query hit lists in probe layout."""
    plens = rng.integers(1, max(2, S), size=P)
    offsets = np.zeros(P + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(plens)
    sample_ids = np.concatenate([
        np.sort(rng.choice(S, size=plens[p], replace=False)).astype(
            np.uint32) for p in range(P)])
    qoffs = np.zeros(Q, dtype=np.int64)
    hp_list, hc_list, ucnt = [], [], np.zeros(Q, dtype=np.int64)
    pos = 0
    for q in range(Q):
        u = int(rng.integers(0, max_hits + 1))
        pids = np.sort(rng.choice(P, size=u, replace=False)).astype(
            np.int32)
        cnts = rng.integers(1, max_cnt + 1, size=u).astype(np.uint32)
        qoffs[q] = pos
        ucnt[q] = u
        hp_list.append(pids)
        hc_list.append(cnts)
        pos += u
    hp = (np.concatenate(hp_list) if pos else np.empty(0, np.int32))
    hc = (np.concatenate(hc_list) if pos else np.empty(0, np.uint32))
    return qoffs, ucnt, hp, hc, offsets, sample_ids


@pytest.mark.parametrize("seed,Q,S,P,max_cnt", [
    (0, 7, 64, 40, 3),        # u16 accumulation
    (1, 5, 700, 25, 9),       # wide S: dense AXPY path engages
    (2, 3, 130, 11, 70_000),  # per-query totals overflow u16 -> u32
    (3, 1, 16, 300, 2),       # many tiny patterns, one query
    (4, 16, 1024, 64, 1),     # weight-1 counts
])
def test_patmajor_matches_qmajor(seed, Q, S, P, max_cnt):
    rng = np.random.default_rng(seed)
    qoffs, ucnt, hp, hc, offsets, sids = _random_workload(
        rng, Q, S, P, max_hits=min(P, 20), max_cnt=max_cnt)
    a = np.zeros((Q, S), dtype=np.uint32)
    b = np.zeros((Q, S), dtype=np.uint32)
    native.csr_apply_many(qoffs, ucnt, hp, hc, offsets, sids, a)
    native.csr_apply_patmajor(qoffs, ucnt, hp, hc, offsets, sids, P, b)
    assert np.array_equal(a, b)


def test_radix_sort_bit63():
    """Keys with bit 63 set must sort (the width scan `acc >> bits`
    hit shift-by-64 UB — an infinite loop on x86/ARM; found by
    review, reachable via 64-bit KMC k-mer codes)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 62, size=50_000, dtype=np.uint64)
    keys[::3] |= np.uint64(1) << np.uint64(63)
    expect = np.sort(keys.copy())
    native.radix_sort(keys)
    assert np.array_equal(keys, expect)


def test_radix_sort_all_ones():
    keys = np.full(4096, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
    native.radix_sort(keys)
    assert (keys == np.uint64(0xFFFFFFFFFFFFFFFF)).all()


def test_patmajor_empty():
    a = np.zeros((2, 8), dtype=np.uint32)
    native.csr_apply_patmajor(
        np.zeros(2, np.int64), np.zeros(2, np.int64),
        np.empty(0, np.int32), np.empty(0, np.uint32),
        np.zeros(2, np.int64), np.empty(0, np.uint32), 1, a)
    assert not a.any()


def test_patmajor_threads_invariant():
    """Sample-axis thread split must be byte-invariant (the reference
    CI's threads-determinism matrix role for this kernel)."""
    rng = np.random.default_rng(7)
    Q, S, P = 9, 2048, 50
    qoffs, ucnt, hp, hc, offsets, sids = _random_workload(
        rng, Q, S, P, max_hits=30, max_cnt=5)
    old = native.get_threads()
    outs = []
    try:
        for nt in (1, 2, 7):
            native.set_threads(nt)
            o = np.zeros((Q, S), dtype=np.uint32)
            native.csr_apply_patmajor(qoffs, ucnt, hp, hc, offsets,
                                      sids, P, o)
            outs.append(o)
    finally:
        native.set_threads(old)
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], outs[2])
