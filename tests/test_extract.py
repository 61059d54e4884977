"""Unit tests: k-mer extraction, packing, minhash hashing.

The reference ships no unit tests (golden CLI tests only, SURVEY §4);
these pin down the low-level semantics the goldens depend on.
"""

import numpy as np
import pytest

from kmerdb_jax.ops.alphabet import get_alphabet, ALPHABET_NAMES
from kmerdb_jax.ops import extract, minhash
from kmerdb_jax.types import KMER_SENTINEL


def _np_kmers(seq: bytes, k: int, alph, fraction=1.0, start=0.0):
    arr = np.frombuffer(seq, dtype=np.uint8)[None, :]
    out = extract.extract_block_np(arr, np.array([len(seq)]), k, alph,
                                   fraction, start).ravel()
    return [int(x) for x in out if x != KMER_SENTINEL]


def test_nt_packing_simple():
    alph = get_alphabet("nt")
    # ACG with k=3: fwd = A,C,G = 0,1,2 -> 0b00_01_10 = 6
    # rev = comp(G),comp(C),comp(A) = 1,2,3 -> 0b01_10_11 = 27; canonical 6
    # prefix_bits = 9*... for k=3: 3*2-32 < 8 -> shift 34? No: shift = 8-(6-32)
    kmers = extract.extract_kmers_scalar(b"ACG", 3, alph)
    shift, tail = extract.prefix_shift(3, 2)
    assert shift == 8 - (3 * 2 - 32)
    expected = (6 << shift) | (6 & tail)
    assert kmers == [expected]


def test_canonical_min_of_strands():
    alph = get_alphabet("nt")
    # TTT: fwd=0b111111=63(T=3), rev=AAA=0 -> canonical 0
    kmers = extract.extract_kmers_scalar(b"TTT", 3, alph)
    shift, tail = extract.prefix_shift(3, 2)
    assert kmers == [(0 << shift) | (0 & tail)]


def test_preserve_strand():
    alph = get_alphabet("nt-preserve")
    kmers = extract.extract_kmers_scalar(b"TTT", 3, alph)
    shift, tail = extract.prefix_shift(3, 2)
    assert kmers == [(63 << shift) | (63 & tail)]


def test_invalid_symbols_reset_window():
    alph = get_alphabet("nt")
    # N at position 4 invalidates every window containing it
    seq = b"ACGTNACGTACG"
    k = 4
    got = extract.extract_kmers_scalar(seq, k, alph)
    # valid windows: [0..3] and [5..8],[6..9],[7..10],[8..11]
    assert len(got) == 5


@pytest.mark.parametrize("alph_name", ALPHABET_NAMES)
@pytest.mark.parametrize("k", [3, 8, 15, 18, 21, 25, 31])
def test_vectorized_matches_scalar(alph_name, k):
    alph = get_alphabet(alph_name)
    if k > alph.max_kmer_len:
        pytest.skip("k too large for alphabet")
    rng = np.random.default_rng(42 + k)
    chars = b"ACGTUNKREDQWIPYFSMHLVacgtnx *"
    seq = bytes(rng.choice(list(chars), size=300).astype(np.uint8))
    want = extract.extract_kmers_scalar(seq, k, alph)
    got = _np_kmers(seq, k, alph)
    assert got == want


@pytest.mark.parametrize("k", [18, 25])
@pytest.mark.parametrize("fraction", [0.1, 0.5])
def test_vectorized_matches_scalar_minhash(k, fraction):
    alph = get_alphabet("nt")
    rng = np.random.default_rng(7)
    seq = bytes(rng.choice(list(b"ACGT"), size=500).astype(np.uint8))
    want = extract.extract_kmers_scalar(seq, k, alph, fraction)
    got = _np_kmers(seq, k, alph, fraction)
    assert got == want


@pytest.mark.parametrize("k", [18, 21])
def test_device_matches_host(k):
    alph = get_alphabet("nt")
    rng = np.random.default_rng(3)
    seqs = rng.choice(list(b"ACGTN"), size=(4, 256)).astype(np.uint8)
    lengths = np.array([256, 200, k - 1, 0], dtype=np.int32)
    host = extract.extract_block_np(seqs, lengths, k, alph, 0.5, 0.0)
    dev = np.asarray(extract.extract_block_jnp(seqs, lengths, k, alph, 0.5, 0.0))
    np.testing.assert_array_equal(host, dev)


def test_minhash_hash_reference_values():
    """Hash pinned against a direct Python transliteration of
    filter.h:96-115 (independent of the numpy lane implementation)."""

    def ref_hash(kmer, k):
        M = (1 << 64) - 1

        def fmix64(x):
            x ^= x >> 33
            x = (x * 0xFF51AFD7ED558CCD) & M
            x ^= x >> 33
            x = (x * 0xC4CEB9FE1A85EC53) & M
            x ^= x >> 33
            return x

        kd4 = -(-k // 4)
        h = (kmer * 0x87C37B91114253D5) & M
        h = ((h << 31) | (h >> 33)) & M
        h = (h * 0x4CF5AD432745937F) & M
        h1 = (42 ^ h) ^ kd4
        h2 = 42 ^ kd4
        h1 = (h1 + h2) & M
        h2 = (h2 + h1) & M
        h1 = fmix64(h1)
        h2 = fmix64(h2)
        h1 = (h1 + h2) & M
        h2 = (h2 + h1) & M
        return h1 ^ h2

    kmers = np.array([0, 1, 0xDEADBEEF, 0x123456789ABCDEF,
                      0x7FFFFFFFFFFFFFFF], dtype=np.uint64)
    for k in (18, 21, 25):
        got = minhash.hash_np(kmers, k)
        want = [ref_hash(int(x), k) for x in kmers]
        assert [int(g) for g in got] == want
        got_dev = minhash.hash_jnp(kmers, k)
        assert [int(g) for g in np.asarray(got_dev)] == want


def test_minhash_thresholds():
    lo, hi = minhash.thresholds(1.0, 0.0)
    assert lo == 0
    lo, hi = minhash.thresholds(0.1, 0.0)
    assert lo == 0 and hi == int(float(2**64) * 0.1)
