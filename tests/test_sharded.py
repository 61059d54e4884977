"""Sharding invariance: N-device pattern-sharded all2all == single-device.

Plays the role of the reference CI's threads-{1,2,16} matrix (results
must not depend on the parallel decomposition)."""

import numpy as np
import pytest

from kmerdb_jax.io import fasta, ingest
from kmerdb_jax.models.database import KmerPatternDb
from kmerdb_jax.models import builder
from kmerdb_jax.ops import intersect
from kmerdb_jax.ops.alphabet import get_alphabet
from kmerdb_jax.parallel.mesh import make_mesh
from kmerdb_jax.parallel.sharded import all2all_counts_sharded


@pytest.fixture(scope="module")
def synth_db(reference_test_dir):
    path = reference_test_dir / "synth" / "synth.fa"
    headers, seqs = fasta.split_contigs(fasta.read_raw(str(path)))
    alph = get_alphabet("nt")
    samples = [(h.decode(), ingest.extract_sample_kmers([s], 21, alph))
               for h, s in zip(headers, seqs)]
    return builder.add_samples(
        KmerPatternDb(kmer_length=21, fraction=1.0, alphabet_name="nt"),
        samples)


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_sharded_all2all_matches(synth_db, n_devices):
    import jax
    if len(jax.devices()) < n_devices:
        pytest.skip("not enough devices")
    mesh = make_mesh(n_devices)
    got = all2all_counts_sharded(synth_db, mesh)
    want = intersect.all2all_counts(synth_db)
    np.testing.assert_array_equal(got, want)


def test_many2all_sharded_matches_single():
    """Query-sharded batched new2all == single-device host path."""
    from kmerdb_jax.parallel.sharded import many2all_counts_sharded
    from kmerdb_jax.utils import native
    if not native.available:
        pytest.skip("no native lib")
    mesh8 = make_mesh(8)

    rng = np.random.default_rng(23)
    pool = rng.integers(0, 1 << 40, size=4000, dtype=np.uint64)
    samples = [(f"s{i}", np.unique(rng.choice(
        pool, size=rng.integers(100, 700), replace=False)))
        for i in range(6)]
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)
    queries = [np.unique(rng.choice(pool, size=rng.integers(50, 400),
                                    replace=False)) for _ in range(11)]
    single = intersect.many2all_counts(db, queries, use_device=False)
    sharded = many2all_counts_sharded(db, queries, mesh8)
    np.testing.assert_array_equal(sharded, single)


def test_db2db_sharded_matches_single():
    """Pattern-pair-sharded cross-DB counts == host cross_apply."""
    from kmerdb_jax.parallel.sharded import db2db_counts_sharded
    from kmerdb_jax.utils import native
    if not native.available:
        pytest.skip("no native lib")
    mesh8 = make_mesh(8)

    rng = np.random.default_rng(29)
    pool = rng.integers(0, 1 << 40, size=3000, dtype=np.uint64)

    def mk(n, seed):
        r = np.random.default_rng(seed)
        return builder.add_samples(
            KmerPatternDb(kmer_length=18, fraction=1.0,
                          alphabet_name="nt"),
            [(f"s{i}", np.unique(pool[r.random(pool.size)
                                      < r.uniform(0.2, 0.7)]))
             for i in range(n)])

    dbA, dbB = mk(5, 1), mk(9, 2)
    host = intersect.db2db_counts(dbA, dbB)
    assert host.max() > 0
    np.testing.assert_array_equal(
        db2db_counts_sharded(dbA, dbB, mesh8), host)


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("stripe_rows", [None, 128])
def test_rows_sharded_streaming_matches(synth_db, n_devices, stripe_rows):
    """Row-stripe-sharded streaming all2all (mesh x streaming
    composition) == single-device matrix path, rows emitted in order,
    per-device memory one stripe."""
    import jax
    from kmerdb_jax.parallel.sharded import all2all_rows_sharded
    if len(jax.devices()) < n_devices:
        pytest.skip("not enough devices")
    mesh = make_mesh(n_devices)
    S = synth_db.n_samples
    want = intersect.all2all_counts(synth_db)
    rows = {}
    order = []

    def emit(i, row):
        order.append(i)
        rows[i] = row.copy()

    all2all_rows_sharded(synth_db, mesh, emit, stripe_rows=stripe_rows)
    assert order == list(range(S))
    got = np.stack([rows[i] for i in range(S)])
    np.testing.assert_array_equal(got, want)


def test_rows_sharded_heavy_weights(reference_test_dir):
    """Multi-limb (heavy pattern) stripes through the sharded stream."""
    from kmerdb_jax.parallel.sharded import all2all_rows_sharded
    rng = np.random.default_rng(41)
    pool = rng.integers(0, 1 << 40, size=600, dtype=np.uint64)
    # few samples + many shared k-mers -> pattern weights > 255
    samples = [(f"s{i}", np.unique(np.concatenate(
        [pool[:400], rng.choice(pool, size=150)])))
        for i in range(5)]
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)
    mesh = make_mesh(8)
    want = intersect.all2all_counts(db)
    rows = {}
    all2all_rows_sharded(db, mesh, lambda i, r: rows.__setitem__(
        i, r.copy()))
    got = np.stack([rows[i] for i in range(db.n_samples)])
    np.testing.assert_array_equal(got, want)
