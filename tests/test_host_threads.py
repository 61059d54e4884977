"""Threaded host kernels: byte-identical at any thread count, faster
when cores exist (the reference's active_thread_pool role,
libs/refresh/active_thread_pool/lib/active_thread_pool.h:368)."""

import os
import time

import numpy as np
import pytest

from kmerdb_jax.utils import native

pytestmark = pytest.mark.skipif(not native.available,
                                reason="no native lib")


@pytest.fixture(autouse=True)
def _restore_threads():
    yield
    native.set_threads(0)


def test_radix_sort_threaded_identical():
    rng = np.random.default_rng(3)
    # > 1M elements engages the parallel path
    keys = rng.integers(0, 1 << 62, size=1_500_000, dtype=np.uint64)
    native.set_threads(1)
    a = keys.copy()
    native.radix_sort(a)
    for nt in (2, 4, 7):
        native.set_threads(nt)
        b = keys.copy()
        native.radix_sort(b)
        np.testing.assert_array_equal(a, b, err_msg=f"nt={nt}")
    assert np.all(a[1:] >= a[:-1])


def test_a2a_blocked_threaded_identical():
    rng = np.random.default_rng(5)
    S, n_pat, plen = 700, 3000, 20
    offs = np.arange(0, n_pat * plen + 1, plen, dtype=np.int64)
    sids = np.sort(rng.integers(0, S, size=(n_pat, plen),
                                dtype=np.uint32), axis=1).ravel()
    w = rng.integers(1, 1000, size=n_pat, dtype=np.uint32)
    os.environ["KMERDB_A2A_HOST_TILE"] = "128"  # force the blocked form
    try:
        native.set_threads(1)
        C1 = native.a2a_dense(offs, sids, w, S)
        for nt in (3, 8):
            native.set_threads(nt)
            np.testing.assert_array_equal(
                C1, native.a2a_dense(offs, sids, w, S), err_msg=f"nt={nt}")
    finally:
        del os.environ["KMERDB_A2A_HOST_TILE"]


def test_fill_incidence_bits_threaded_identical():
    rng = np.random.default_rng(7)
    n_pat, S, plen = 40_000, 512, 9  # > 16k engages the parallel path
    offs = np.arange(0, n_pat * plen + 1, plen, dtype=np.int64)
    sids = rng.integers(0, S, size=n_pat * plen, dtype=np.uint32)
    gp = np.arange(n_pat, dtype=np.int64)
    native.set_threads(1)
    b1 = np.zeros((-(-n_pat // 8), S), dtype=np.uint8)
    native.fill_incidence_bits(gp, offs, sids, b1)
    for nt in (2, 5):
        native.set_threads(nt)
        b2 = np.zeros_like(b1)
        native.fill_incidence_bits(gp, offs, sids, b2)
        np.testing.assert_array_equal(b1, b2, err_msg=f"nt={nt}")


def test_threads_scale_when_cores_exist():
    """rate(N threads) > rate(1) — only measurable on multi-core hosts
    (the bench rig has 1 vCPU; CI elsewhere exercises this)."""
    cores = os.cpu_count() or 1
    if cores < 2:
        pytest.skip("single-core host: no parallel speedup to measure")
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 62, size=4_000_000, dtype=np.uint64)

    def rate(nt):
        native.set_threads(nt)
        a = keys.copy()
        t0 = time.perf_counter()
        native.radix_sort(a)
        return keys.size / (time.perf_counter() - t0)

    rate(1)  # warm pages
    r1 = min(rate(1), rate(1))
    rn = max(rate(cores), rate(cores))
    assert rn > r1 * 1.2, (r1, rn)
