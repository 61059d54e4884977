"""MinHash fraction filter: 64-bit mixing hash + acceptance window.

Bit-for-bit contract from reference src/filter.h:33-146:

* ``hash(kmer)`` is a MurmurHash3-style construction: multiply by
  0x87c37b91114253d5, rotl 31, multiply by 0x4cf5ad432745937f, mix with
  42 ^ ceil(k/4), two fmix64 finalizers, cross-add, xor (filter.h:96-115).
* accept iff  min_thr <= h < max_thr  with
  min_thr = u64(2^64 * f_start), max_thr = u64(2^64 * (f_start + f))
  (filter.h:42-43).  fraction == 1.0 short-circuits to accept-all
  (NullFilter, filter.h:120-131).

Implemented twice: a NumPy host reference (oracle for tests, small
inputs) and a jax.numpy device version used inside the extraction
pipeline.  Both operate on uint64 lanes; where the device lacks
64-bit integer units XLA lowers the u64 ops to 32-bit limb
arithmetic.
"""

import numpy as np

from .._jaxinit import jax_modules

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53
_MASK = (1 << 64) - 1


def thresholds(fraction: float, start: float) -> tuple[int, int]:
    """Acceptance window [min_thr, max_thr) as python ints.

    Matches filter.h:42-43: (double)UINT64_MAX rounds to 2^64 exactly;
    the product is truncated toward zero by the uint64 cast.  When
    start + fraction >= 1.0 the product reaches/exceeds 2^64 — the
    reference binary's double->uint64 conversion SATURATES to
    UINT64_MAX there (measured: -f 0.9 -f-start 0.3 keeps the
    [0.3, 1.0) window, i.e. ~70% of k-mers), so the window clamps
    instead of wrapping.
    """
    umax = float(0xFFFFFFFFFFFFFFFF)  # == 2.0**64 after rounding

    def sat(x: float) -> int:
        v = int(x)
        return _MASK if v > _MASK else (0 if v < 0 else v)

    return sat(umax * start), sat(umax * (start + fraction))


def _k_div_4(kmer_length: int) -> int:
    return (kmer_length + 3) // 4  # ceil(k/4), filter.h:54


def hash_np(kmers: np.ndarray, kmer_length: int) -> np.ndarray:
    """NumPy reference of MinHashFilter::hash (filter.h:96-115)."""
    kd4 = np.uint64(_k_div_4(kmer_length))
    c42 = np.uint64(42) ^ kd4

    with np.errstate(over="ignore"):
        h = kmers.astype(np.uint64) * np.uint64(_C1)
        h = (h << np.uint64(31)) | (h >> np.uint64(33))  # rotl64(h, 31)
        h = h * np.uint64(_C2)
        h1 = np.uint64(42) ^ h
        h1 = h1 ^ kd4
        h2 = np.full_like(h1, c42)
        h1 = h1 + h2
        h2 = h2 + h1

        def fmix64(k):
            k = k ^ (k >> np.uint64(33))
            k = k * np.uint64(_F1)
            k = k ^ (k >> np.uint64(33))
            k = k * np.uint64(_F2)
            k = k ^ (k >> np.uint64(33))
            return k

        h1 = fmix64(h1)
        h2 = fmix64(h2)
        h1 = h1 + h2
        h2 = h2 + h1
        return h1 ^ h2


def hash_jnp(kmers, kmer_length: int):
    """Device (jax.numpy) version of MinHashFilter::hash."""
    _, jnp = jax_modules()
    kd4 = jnp.uint64(_k_div_4(kmer_length))
    c42_val = 42 ^ _k_div_4(kmer_length)

    h = kmers.astype(jnp.uint64) * jnp.uint64(_C1)
    h = (h << jnp.uint64(31)) | (h >> jnp.uint64(33))
    h = h * jnp.uint64(_C2)
    h1 = (h ^ jnp.uint64(42)) ^ kd4
    h2 = jnp.uint64(c42_val)
    h1 = h1 + h2
    h2 = h2 + h1

    def fmix64(k):
        k = k ^ (k >> jnp.uint64(33))
        k = k * jnp.uint64(_F1)
        k = k ^ (k >> jnp.uint64(33))
        k = k * jnp.uint64(_F2)
        k = k ^ (k >> jnp.uint64(33))
        return k

    h1 = fmix64(h1)
    h2 = fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1 ^ h2


def accept_mask_np(kmers: np.ndarray, kmer_length: int,
                   fraction: float, start: float = 0.0) -> np.ndarray:
    """Boolean accept mask of the minhash window (host oracle)."""
    if fraction >= 1.0:
        return np.ones(kmers.shape, dtype=bool)
    lo, hi = thresholds(fraction, start)
    h = hash_np(kmers, kmer_length)
    return (h >= np.uint64(lo)) & (h < np.uint64(hi))


def accept_mask_jnp(kmers, kmer_length: int, fraction: float, start: float = 0.0):
    """Boolean accept mask of the minhash window (device)."""
    _, jnp = jax_modules()
    if fraction >= 1.0:
        return jnp.ones(kmers.shape, dtype=bool)
    lo, hi = thresholds(fraction, start)
    h = hash_jnp(kmers, kmer_length)
    return (h >= jnp.uint64(lo)) & (h < jnp.uint64(hi))
