"""Vectorized k-mer extraction: sequence bytes -> packed canonical k-mers.

Behavioral contract (reference src/kmer_extract.h:13-97):

* packing: symbol stream s[0..L-1]; forward k-mer ending at position e
  is  sum_j s[e-k+1+j] << ((k-1-j)*bits);  reverse complement is
  sum_j (size-1-s[e-k+1+j]) << (j*bits);  canonical = min(fwd, rev)
  unless the alphabet preserves strand.
* invalid symbols (mapping < 0) invalidate every window containing
  them (the reference's omit_next_n_kmers counter is equivalent to
  "window contains an invalid position", see the sliding-window
  analysis in the docstring of _window_invalid).
* >=8-bit-prefix guarantee: with prefix_bits = k*bits - 32, if
  prefix_bits < 8 the k-mer is shifted left by (8 - prefix_bits) and
  its low (8 - prefix_bits) bits are duplicated into the vacated
  positions (kmer_extract.h:37-45, 87-88).  The minhash hash operates
  on this *shifted* value, so parity requires it.

The reference walks each contig serially with a rolling pair of
registers; here whole padded batches of contigs are processed as u64
vector lanes with two Horner scans of k static steps — the
data-parallel equivalent (parallel over positions instead of
loop-carried).

Two implementations: `extract_block_np` (host oracle / fallback) and
`extract_block_jnp` (device path, jit-compatible, static shapes).
"""

import functools

import numpy as np

from ..types import KMER_SENTINEL
from .._jaxinit import jax_modules
from .alphabet import Alphabet
from . import minhash


def prefix_shift(kmer_length: int, bits_per_symbol: int) -> tuple[int, int]:
    """(shift, tail_mask) of the >=8-bit-prefix adjustment."""
    prefix_bits = kmer_length * bits_per_symbol - 32
    if prefix_bits < 8:
        shift = 8 - prefix_bits
        return shift, (1 << shift) - 1
    return 0, 0


# ---------------------------------------------------------------------------
# host (NumPy) implementation — oracle + fallback
# ---------------------------------------------------------------------------

def extract_block_np(seqs: np.ndarray, lengths: np.ndarray, k: int,
                     alphabet: Alphabet, fraction: float = 1.0,
                     start: float = 0.0) -> np.ndarray:
    """Extract k-mers from a padded byte block.

    seqs: uint8[B, L] sequence characters (padding arbitrary).
    lengths: int[B] true lengths.
    Returns uint64[B, L-k+1] packed k-mers with KMER_SENTINEL in
    positions that are out-of-range / invalid / filtered out.
    """
    B, L = seqs.shape
    V = L - k + 1
    if V <= 0:
        return np.full((B, 0), KMER_SENTINEL, dtype=np.uint64)
    bits = alphabet.bits_per_symbol

    sym = alphabet.mapping[seqs]                    # int8[B, L]
    pos = np.arange(L, dtype=np.int64)[None, :]
    invalid = (sym < 0) | (pos >= np.asarray(lengths, dtype=np.int64)[:, None])
    s = np.where(invalid, 0, sym).astype(np.uint64)

    with np.errstate(over="ignore"):
        fwd = np.zeros((B, V), dtype=np.uint64)
        for j in range(k):
            fwd = (fwd << np.uint64(bits)) | s[:, j:V + j]
        if alphabet.preserve_strand:
            canon = fwd
        else:
            comp = np.uint64(alphabet.size - 1) - s
            rev = np.zeros((B, V), dtype=np.uint64)
            for j in range(k - 1, -1, -1):
                rev = (rev << np.uint64(bits)) | comp[:, j:V + j]
            canon = np.minimum(fwd, rev)

        shift, tail_mask = prefix_shift(k, bits)
        if shift:
            canon = (canon << np.uint64(shift)) | (canon & np.uint64(tail_mask))

    c = np.zeros((B, L + 1), dtype=np.int32)
    np.cumsum(invalid, axis=1, out=c[:, 1:])
    window_bad = (c[:, k:] - c[:, :V]) > 0          # any invalid in window

    keep = ~window_bad
    if fraction < 1.0:
        keep &= minhash.accept_mask_np(canon, k, fraction, start)
    return np.where(keep, canon, KMER_SENTINEL)


# ---------------------------------------------------------------------------
# device (JAX) implementation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_extract():
    jax, jnp = jax_modules()

    @functools.partial(jax.jit, static_argnames=("k", "alphabet_name",
                                                 "fraction", "start"))
    def _impl(seqs, lengths, *, k, alphabet_name, fraction, start):
        from .alphabet import get_alphabet
        alphabet = get_alphabet(alphabet_name)
        B, L = seqs.shape
        V = L - k + 1
        bits = alphabet.bits_per_symbol

        mapping = jnp.asarray(alphabet.mapping)
        sym = mapping[seqs.astype(jnp.int32)]           # int8[B, L]
        pos = jnp.arange(L, dtype=jnp.int32)[None, :]
        invalid = (sym < 0) | (pos >= lengths.astype(jnp.int32)[:, None])
        s = jnp.where(invalid, 0, sym).astype(jnp.uint64)

        fwd = jnp.zeros((B, V), dtype=jnp.uint64)
        for j in range(k):
            fwd = (fwd << jnp.uint64(bits)) \
                | jax.lax.slice_in_dim(s, j, V + j, axis=1)
        if alphabet.preserve_strand:
            canon = fwd
        else:
            comp = jnp.uint64(alphabet.size - 1) - s
            rev = jnp.zeros((B, V), dtype=jnp.uint64)
            for j in range(k - 1, -1, -1):
                rev = (rev << jnp.uint64(bits)) \
                    | jax.lax.slice_in_dim(comp, j, V + j, axis=1)
            canon = jnp.minimum(fwd, rev)

        shift, tail_mask = prefix_shift(k, bits)
        if shift:
            canon = (canon << jnp.uint64(shift)) \
                | (canon & jnp.uint64(tail_mask))

        c = jnp.cumsum(invalid.astype(jnp.int32), axis=1)
        c = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), c], axis=1)
        window_bad = (jax.lax.slice_in_dim(c, k, L + 1, axis=1)
                      - jax.lax.slice_in_dim(c, 0, V, axis=1)) > 0

        keep = ~window_bad
        if fraction < 1.0:
            keep &= minhash.accept_mask_jnp(canon, k, fraction, start)
        return jnp.where(keep, canon, jnp.uint64(KMER_SENTINEL))

    return _impl


def _extract_block_jit(seqs, lengths, **kw):
    return _jit_extract()(seqs, lengths, **kw)


def extract_block_jnp(seqs, lengths, k: int, alphabet: Alphabet,
                      fraction: float = 1.0, start: float = 0.0):
    """Device k-mer extraction on a padded uint8[B, L] block."""
    _, jnp = jax_modules()
    if seqs.shape[1] - k + 1 <= 0:
        return jnp.full((seqs.shape[0], 0), KMER_SENTINEL, dtype=jnp.uint64)
    return _extract_block_jit(seqs, lengths, k=k, alphabet_name=alphabet.name,
                              fraction=float(fraction), start=float(start))


# ---------------------------------------------------------------------------
# scalar reference (direct transliteration of the semantics, for tests)
# ---------------------------------------------------------------------------

def extract_kmers_scalar(sequence: bytes, k: int, alphabet: Alphabet,
                         fraction: float = 1.0, start: float = 0.0) -> list[int]:
    """Slow, obviously-correct single-contig extraction used as a test
    oracle for the vectorized paths (matches kmer_extract.h:13-97)."""
    L = len(sequence)
    if L < k:
        return []
    bits = alphabet.bits_per_symbol
    mask = (1 << (bits * k)) - 1
    shift, tail_mask = prefix_shift(k, bits)
    lo_thr, hi_thr = minhash.thresholds(fraction, start)

    kmer_str = 0
    kmer_rev = 0
    omit = 0
    out = []
    for i in range(L):
        symb = int(alphabet.mapping[sequence[i]])
        if symb < 0:
            symb = 0
            omit = k if i >= k - 1 else i + 1
        kmer_str = ((kmer_str << bits) | symb) & mask
        kmer_rev = (kmer_rev >> bits) | ((alphabet.size - 1 - symb) << ((k - 1) * bits))
        if i < k - 1:
            continue
        if omit > 0:
            omit -= 1
            continue
        canon = kmer_str if alphabet.preserve_strand else min(kmer_str, kmer_rev)
        canon = (canon << shift) | (canon & tail_mask)
        if fraction >= 1.0:
            out.append(canon)
        else:
            h = int(minhash.hash_np(np.array([canon], dtype=np.uint64), k)[0])
            if lo_thr <= h < hi_thr:
                out.append(canon)
    return out
