"""Device-tier selection for the counting kernels.

The tier logic (ops/intersect.py) mirrors the reference's single CPU
path with hardware dispatch instead: host C++ below the cost-model
threshold, the Gram engine (ops/gram.py) on the device above it.
These tests pin the env-knob contract (KMERDB_A2A_DEVICE,
KMERDB_N2A_DEVICE, KMERDB_D2D_DEVICE) — a forced device tier runs the
same XLA code on the CPU backend here — and that a device tier which
fails raises instead of silently recomputing on the host.
"""

import pytest

import numpy as np

from kmerdb_jax.models.database import KmerPatternDb
from kmerdb_jax.models import builder
from kmerdb_jax.ops import intersect


def _db(n_samples=6, n_kmers=400, seed=0):
    rng = np.random.default_rng(seed)
    db = KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt")
    pool = rng.integers(0, 1 << 36, size=n_kmers, dtype=np.uint64)
    batch = []
    for i in range(n_samples):
        take = rng.random(n_kmers) < rng.uniform(0.2, 0.8)
        batch.append((f"s{i}", np.unique(pool[take])))
    return builder.add_samples(db, batch)


def _host_oracle(db):
    C = np.zeros((db.n_samples, db.n_samples), dtype=np.uint32)
    offs = db.pattern_offsets
    for p in range(db.n_patterns):
        ids = db.pattern_sample_ids[offs[p]:offs[p + 1]]
        w = db.pattern_num_kmers[p]
        for a in range(len(ids)):
            for b in range(len(ids)):
                C[ids[a], ids[b]] += w
    return C


def test_a2a_device_env_forces_xla_tier(monkeypatch):
    db = _db()
    oracle = _host_oracle(db)
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    np.testing.assert_array_equal(intersect.all2all_counts(db), oracle)
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "0")
    np.testing.assert_array_equal(intersect.all2all_counts(db), oracle)


def test_a2a_device_tier_failure_raises(monkeypatch):
    """A forced device tier that fails must raise — never recompute on
    the host behind a log line — and the CLI must exit non-zero."""
    from kmerdb_jax.ops import device_a2a
    db = _db(seed=1)

    def boom(db):
        raise RuntimeError("device tier exploded")

    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    monkeypatch.setattr(device_a2a, "all2all_device", boom)
    with pytest.raises(RuntimeError, match="exploded"):
        intersect.all2all_counts(db)


def test_n2a_device_env(monkeypatch):
    db = _db(seed=2)
    rng = np.random.default_rng(3)
    queries = [np.unique(rng.integers(0, 1 << 36, size=150,
                                      dtype=np.uint64))
               for _ in range(4)]
    host = intersect.many2all_counts(db, queries, use_device=False)
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    np.testing.assert_array_equal(
        intersect.many2all_counts(db, queries), host)


def test_d2d_device_env(monkeypatch):
    """KMERDB_D2D_DEVICE=1 contracts pattern-pair chunks on the
    device (C = U^T diag(counts) V); results must equal the host
    cross_apply exactly, including count weights above one limb."""
    dbA = _db(n_samples=5, n_kmers=600, seed=6)
    dbB = _db(n_samples=7, n_kmers=600, seed=6)  # same pool -> overlap
    host = intersect.db2db_counts(dbA, dbB)
    assert host.max() > 0, "test corpus must actually intersect"
    monkeypatch.setenv("KMERDB_D2D_DEVICE", "1")
    np.testing.assert_array_equal(intersect.db2db_counts(dbA, dbB), host)


def test_n2a_device_tier_failure_raises(monkeypatch):
    db = _db(seed=4)
    rng = np.random.default_rng(5)
    queries = [np.unique(rng.integers(0, 1 << 36, size=150,
                                      dtype=np.uint64))
               for _ in range(3)]

    def boom(*a, **k):
        raise RuntimeError("device tier exploded")

    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    monkeypatch.setattr(intersect, "m2a_prepare", boom)
    with pytest.raises(RuntimeError, match="exploded"):
        intersect.many2all_counts(db, queries)


def test_n2a_device_tier_u8_hits(monkeypatch):
    """The new2all device tier runs on uint8 hit counts (the narrow
    wire format m2a_prepare emits below 256) and equals the host."""
    db = _db(seed=7)
    rng = np.random.default_rng(8)
    queries = [np.unique(rng.integers(0, 1 << 36, size=150,
                                      dtype=np.uint64))
               for _ in range(3)]
    host = intersect.many2all_counts(db, queries, use_device=False)
    H_all, _, n_limbs = intersect.m2a_prepare(db, queries)
    assert n_limbs == 1 and H_all.dtype == np.uint8, \
        "corpus must exercise the u8 hit-count layout"
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    np.testing.assert_array_equal(
        intersect.many2all_counts(db, queries), host)
