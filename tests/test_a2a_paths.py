"""Host-scatter vs device-Gram all2all equivalence on random databases
(both paths must produce identical exact uint32 counts)."""

import numpy as np
import pytest

from kmerdb_jax.models.database import KmerPatternDb
from kmerdb_jax.ops import intersect
from kmerdb_jax.utils import native


def _random_db(rng, S, P, max_len=20, max_w=300_000):
    lens = rng.integers(1, min(max_len, S + 1), size=P)
    offs = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    sids = np.empty(offs[-1], dtype=np.uint32)
    for p in range(P):
        k = int(lens[p])
        sids[offs[p]:offs[p + 1]] = np.sort(
            rng.choice(S, size=k, replace=False)).astype(np.uint32)
    w = rng.integers(1, max_w, size=P).astype(np.uint32)
    return KmerPatternDb(
        kmer_length=18, sample_names=[f"s{i}" for i in range(S)],
        sample_kmer_counts=np.ones(S, np.uint32),
        pattern_offsets=offs, pattern_sample_ids=sids, pattern_num_kmers=w)


@pytest.mark.skipif(not native.available, reason="no native lib")
@pytest.mark.parametrize("seed,S,P", [(0, 13, 50), (1, 64, 400), (2, 200, 37)])
def test_host_matches_device(seed, S, P):
    rng = np.random.default_rng(seed)
    db = _random_db(rng, S, P)
    host = native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                            db.pattern_num_kmers, S)
    # reference: brute-force numpy
    want = np.zeros((S, S), dtype=np.uint32)
    for p in range(P):
        seg = db.pattern_samples(p)
        want[np.ix_(seg, seg)] += db.pattern_num_kmers[p]
    np.testing.assert_array_equal(host, want)

    # device tier (the Gram engine on this backend)
    dev = _device_a2a(db)
    np.testing.assert_array_equal(dev, want)


def _device_a2a(db):
    from kmerdb_jax.ops import device_a2a
    return device_a2a.all2all_device(db)


@pytest.mark.skipif(not native.available, reason="no native lib")
def test_u32_wraparound_exactness():
    """Counts accumulate mod 2^32 in both paths (reference num_kmers_t)."""
    S = 4
    P = 3
    offs = np.array([0, 2, 4, 6], dtype=np.int64)
    sids = np.array([0, 1, 0, 1, 0, 1], dtype=np.uint32)
    w = np.array([0xF0000000, 0xF0000000, 0x30000000], dtype=np.uint32)
    db = KmerPatternDb(kmer_length=18, sample_names=list("abcd"),
                       sample_kmer_counts=np.ones(S, np.uint32),
                       pattern_offsets=offs, pattern_sample_ids=sids,
                       pattern_num_kmers=w)
    expected = (0xF0000000 * 2 + 0x30000000) % (1 << 32)
    host = native.a2a_dense(offs, sids, w, S)
    assert host[0, 1] == expected
    dev = _device_a2a(db)
    assert dev[0, 1] == expected
