"""The Gram engine (ops/gram.py) against pure-integer NumPy oracles:
packed Gram, row stripes, cross products and H @ B, exact in uint32
with zero tolerance — multi-limb weights up to 2^32 (wraparound), odd
sample counts, and both the engine and its bf16 plain reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmerdb_jax.ops import gram


def _oracle(U, V, w):
    C = (U.astype(np.uint64).T * w.astype(np.uint64)) @ V.astype(np.uint64)
    return (C & 0xFFFFFFFF).astype(np.uint32)


def _incidence(rng, rows, S, density=0.2):
    return (rng.random((rows, S)) < density).astype(np.uint8)


@pytest.mark.parametrize("rows,S,wmax,seed", [
    (1024, 128, 120, 0),             # one 7-bit limb
    (2048, 250, 70_000, 1),          # 3 limbs, odd S
    (1024, 131, 16_000_000, 2),      # 4 limbs, odd S
])
def test_gram_matches_oracle(rows, S, wmax, seed):
    rng = np.random.default_rng(seed)
    B = _incidence(rng, rows, S)
    w = rng.integers(0, wmax, size=rows).astype(np.uint32)
    C = gram.gram_step(jnp.zeros((S, S), jnp.uint32),
                       jnp.asarray(gram.pack_rows(B)), jnp.asarray(w),
                       n_limbs=gram.n_limbs(int(w.max())))
    # accumulates into the donated C: a second step doubles it
    C = gram.gram_step(C, jnp.asarray(gram.pack_rows(B)), jnp.asarray(w),
                       n_limbs=gram.n_limbs(int(w.max())))
    np.testing.assert_array_equal(np.asarray(C), 2 * _oracle(B, B, w))


@pytest.mark.parametrize("rows,S,wmax,seed", [
    (512, 128, 200, 3),
    (1536, 200, 70_000, 4),
    (512, 77, 16_000_000, 5),
])
def test_reference_gram_matches_oracle(rows, S, wmax, seed):
    """The plain bf16 reference (8-bit limbs, f32 accumulation) is a
    separate route to the same exact matrix."""
    rng = np.random.default_rng(seed)
    B = _incidence(rng, rows, S)
    w = rng.integers(0, wmax, size=rows).astype(np.uint32)
    n8 = max(1, -(-int(w.max()).bit_length() // 8))
    got = gram.reference_gram(jnp.asarray(B.astype(np.int8)),
                              jnp.asarray(w), n_limbs=n8)
    np.testing.assert_array_equal(np.asarray(got), _oracle(B, B, w))


@pytest.mark.parametrize("S,R,row0", [(384, 128, 128), (300, 128, 172),
                                      (256, 256, 0)])
def test_gram_rows_stripe(S, R, row0):
    """Row stripe [row0, row0 + R) of the packed Gram, any row0."""
    rng = np.random.default_rng(31)
    rows = 1024
    B = _incidence(rng, rows, S, 0.15)
    w = rng.integers(0, 200_000, size=rows).astype(np.uint32)
    out = gram.rows_step(jnp.zeros((R, S), jnp.uint32),
                         jnp.asarray(gram.pack_rows(B)), jnp.asarray(w),
                         jnp.int32(row0), n_limbs=gram.n_limbs(int(w.max())))
    np.testing.assert_array_equal(np.asarray(out),
                                  _oracle(B, B, w)[row0:row0 + R])


@pytest.mark.parametrize("S1,S2,wmax", [(256, 128, 60_000),
                                        (100, 257, 2 ** 32 - 1)])
def test_cross_matches_oracle(S1, S2, wmax):
    """Packed cross-database contraction U^T diag(w) V (db2db and the
    parts grid)."""
    rng = np.random.default_rng(37)
    rows = 1024
    U, V = _incidence(rng, rows, S1), _incidence(rng, rows, S2)
    w = rng.integers(0, wmax, size=rows, dtype=np.uint64).astype(np.uint32)
    C = gram.cross_step(jnp.zeros((S1, S2), jnp.uint32),
                        jnp.asarray(gram.pack_rows(U)),
                        jnp.asarray(gram.pack_rows(V)), jnp.asarray(w),
                        n_limbs=gram.n_limbs(int(w.max())))
    np.testing.assert_array_equal(np.asarray(C), _oracle(U, V, w))


@pytest.mark.parametrize("hmax,hdtype", [(256, np.uint8),
                                         (3_000_000, np.uint32)])
def test_hits_matmul(hmax, hdtype):
    """new2all's sims = H @ B over hit counts of either wire dtype."""
    rng = np.random.default_rng(41)
    Q, K, S = 9, 640, 130
    H = rng.integers(0, hmax, size=(Q, K)).astype(hdtype)
    B = _incidence(rng, K, S).astype(np.int8)
    got = gram.hits_matmul(jnp.zeros((Q, S), jnp.uint32), jnp.asarray(H),
                           jnp.asarray(B), n_limbs=gram.n_limbs(hmax))
    want = (H.astype(np.uint64) @ B.astype(np.uint64)) & 0xFFFFFFFF
    np.testing.assert_array_equal(np.asarray(got), want.astype(np.uint32))


def test_u32_wraparound():
    """Counts wrap mod 2^32 like the reference's num_kmers_t."""
    B = np.zeros((8, 4), dtype=np.uint8)
    B[:3, :2] = 1
    w = np.zeros(8, dtype=np.uint32)
    w[:3] = [0xF0000000, 0xF0000000, 0x30000000]
    C = gram.gram_step(jnp.zeros((4, 4), jnp.uint32),
                       jnp.asarray(gram.pack_rows(B)), jnp.asarray(w),
                       n_limbs=gram.n_limbs(0xF0000000))
    assert int(np.asarray(C)[0, 1]) == (2 * 0xF0000000 + 0x30000000) % 2 ** 32


def test_limb_count():
    assert gram.n_limbs(0) == 1
    assert gram.n_limbs(127) == 1
    assert gram.n_limbs(128) == 2
    assert gram.n_limbs(2 ** 32 - 1) == 5


def test_dot_rows_bound():
    """The int32-exactness bound 127 * K < 2^31 is enforced."""
    assert 127 * gram.MAX_DOT_ROWS < 2 ** 31 <= 127 * (gram.MAX_DOT_ROWS + 1)
    gram._check_rows(gram.MAX_DOT_ROWS)
    with pytest.raises(ValueError):
        gram._check_rows(gram.MAX_DOT_ROWS + 1)


def test_unpack_matches_native_fill():
    """unpack_bits reads exactly the layout native.fill_incidence_bits
    writes (row 8k + b = bit b of byte row k)."""
    from kmerdb_jax.utils import native
    if not native.available:
        pytest.skip("no native lib")
    rng = np.random.default_rng(5)
    S, P = 70, 37
    lens = rng.integers(1, S, size=P)
    offs = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    sids = np.concatenate([np.sort(rng.choice(S, size=int(n), replace=False))
                           for n in lens]).astype(np.uint32)
    Bp = np.zeros((-(-P // 8), S), dtype=np.uint8)
    native.fill_incidence_bits(np.arange(P, dtype=np.int64), offs, sids, Bp)
    got = np.asarray(gram.unpack_bits(jnp.asarray(Bp)))[:P]
    want = np.zeros((P, S), dtype=np.int8)
    for p in range(P):
        want[p, sids[offs[p]:offs[p + 1]]] = 1
    np.testing.assert_array_equal(got, want)


def test_pull_narrow():
    C = jnp.asarray(np.array([[1, 70_000], [65_535, 3]], dtype=np.uint32))
    np.testing.assert_array_equal(gram.pull(C, 2, 1, True), [[1], [65_535]])
    np.testing.assert_array_equal(gram.pull(C, 1, 2, False), [[1, 70_000]])


def test_device_peak_table():
    assert gram.device_peak("NVIDIA H100 80GB HBM3") == 1.979e15
    assert gram.device_peak("NVIDIA H100 PCIe", "bf16") == 7.56e14
    with pytest.raises(KeyError):
        gram.device_peak("cpu")


def test_many2all_device_matches_host():
    """Batched new2all (sims = H @ B on pattern chunks) equals the
    per-query host path."""
    from kmerdb_jax.models.database import KmerPatternDb
    from kmerdb_jax.models import builder
    from kmerdb_jax.ops import intersect
    from kmerdb_jax.utils import native

    if not native.available:
        pytest.skip("no native lib")

    rng = np.random.default_rng(17)
    pool = rng.integers(0, 1 << 40, size=5000, dtype=np.uint64)
    samples = []
    for i in range(9):
        ks = rng.choice(pool, size=rng.integers(200, 1200), replace=False)
        samples.append((f"s{i}", np.unique(ks)))
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)

    queries = []
    for _ in range(7):
        q = rng.choice(pool, size=rng.integers(50, 900), replace=False)
        # mix in k-mers absent from the database
        q = np.concatenate([q, rng.integers(1 << 41, 1 << 42,
                                            size=20, dtype=np.uint64)])
        queries.append(np.unique(q))
    queries.append(np.empty(0, dtype=np.uint64))  # empty query row

    host = intersect.many2all_counts(db, queries, use_device=False)
    dev = intersect.many2all_counts(db, queries, use_device=True)
    np.testing.assert_array_equal(dev, host)


def test_all2all_device_packed_matches_host():
    """device_a2a.all2all_device (packed streaming tier) == host path,
    covering both limb classes and multiple groups."""
    import os
    from kmerdb_jax.models.database import KmerPatternDb
    from kmerdb_jax.models import builder
    from kmerdb_jax.ops import intersect, device_a2a

    rng = np.random.default_rng(23)
    samples = []
    for i in range(40):
        small = rng.choice(4000, size=300, replace=False).astype(np.uint64)
        big = rng.integers(1 << 20, 1 << 36,
                           size=rng.integers(300, 2000)).astype(np.uint64)
        samples.append((f"s{i}", np.unique(np.concatenate([small, big]))))
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)

    host = intersect.all2all_counts(db)
    os.environ["KMERDB_A2A_GROUP_MB"] = "0"   # force multiple groups
    try:
        dev = device_a2a.all2all_device(db)
    finally:
        del os.environ["KMERDB_A2A_GROUP_MB"]
    np.testing.assert_array_equal(dev, host)
    st = device_a2a.last_stats
    assert st["light_patterns"] > 0 and st["heavy_patterns"] > 0
