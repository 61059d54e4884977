"""The Gram engine: exact uint32 weighted incidence products in XLA.

Every device count of the system is one contraction of 0/1 incidence
matrices (reference similarity_calculator.cpp:42-438, 737-794,
1225-1540):

    all2all  C = B^T diag(w) B   B: patterns x samples, w: k-mers per pattern
    db2db    C = U^T diag(w) V   U, V: pattern-PAIR incidence, w: shared
    new2all  C = H @ B           H: queries x patterns hit counts

Engine: int8 tensor-core GEMMs.  Weights split into 7-bit limbs, so a
limb-scaled 0/1 operand is int8 (<= 127) and every dot runs s8 x s8 ->
s32 (`preferred_element_type=int32`).  Limb partials recombine as
`part << 7l` in uint32, which wraps mod 2^32 exactly like the
reference's num_kmers_t (src/types.h:5-27).

Exactness rule, tolerance zero: one dot over K rows sums at most
127 * K, exact in int32 while 127 * K < 2^31 (K <= MAX_DOT_ROWS =
16,909,320), asserted per call.  No floating-point operand enters, so
TF32 or any float rounding mode cannot change a count.

The packed layout (utils/native.fill_incidence_bits) stores eight
incidence rows per byte: bit b of byte row k is row 8k + b.  Operands
arrive packed (8x fewer host->device bytes) and are unpacked inside the
jitted step, where XLA fuses the unpack and the limb scaling into the
GEMM's operand producers.
"""

import functools

import numpy as np

from .._jaxinit import jax_modules

jax, jnp = jax_modules()

#: weight bits per limb: 7 keeps every limb-scaled 0/1 entry inside int8
LIMB_BITS = 7
_LIMB_MASK = np.uint32((1 << LIMB_BITS) - 1)
#: largest contraction length one int32-accumulated dot may take
MAX_DOT_ROWS = (2 ** 31 - 1) // 127
#: sample / query axes are padded to this multiple (GEMM-friendly shapes)
PAD = 128

_CONTRACT_ROWS = (((0,), (0,)), ((), ()))


def n_limbs(max_value: int) -> int:
    """7-bit limbs needed to cover weights up to max_value."""
    return max(1, -(-int(max_value).bit_length() // LIMB_BITS))


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_rows(k: int) -> None:
    if k > MAX_DOT_ROWS:
        raise ValueError(f"{k} rows per dot exceed the int32-exact bound "
                         f"{MAX_DOT_ROWS} (127 * K < 2^31)")


def unpack_bits(Bp):
    """uint8[R/8, S] packed incidence -> int8[R, S] 0/1 (row 8k + b is
    bit b of byte row k)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    B = (Bp[:, None, :] >> shifts[None, :, None]) & jnp.uint8(1)
    return B.astype(jnp.int8).reshape(Bp.shape[0] * 8, Bp.shape[1])


def _limb(w, l):
    return ((w >> np.uint32(LIMB_BITS * l)) & _LIMB_MASK).astype(jnp.int8)


def weighted_cross(C, U, V, w, *, n_limbs):
    """C + U^T diag(w) V in exact uint32.  U: int8 0/1 [K, S1],
    V: int8 0/1 [K, S2], w: uint32[K] (0 on padding rows)."""
    _check_rows(U.shape[0])
    w = w.reshape(-1)
    for l in range(n_limbs):
        part = jax.lax.dot_general(
            U * _limb(w, l)[:, None], V, _CONTRACT_ROWS,
            preferred_element_type=jnp.int32)
        C = C + (part.astype(jnp.uint32) << np.uint32(LIMB_BITS * l))
    return C


def packed_gram(C, Bp, w, *, n_limbs):
    """C + B^T diag(w) B over packed incidence Bp (uint8[R/8, S])."""
    B = unpack_bits(Bp)
    return weighted_cross(C, B, B, w, n_limbs=n_limbs)


def packed_gram_rows(C, Bp, w, row0, *, n_limbs):
    """Row stripe of the packed Gram: C + (B^T diag(w) B)[row0:row0+R]
    with R = C.shape[0] (row0 a traced scalar, so every stripe shares
    one compiled program)."""
    B = unpack_bits(Bp)
    U = jax.lax.dynamic_slice_in_dim(B, row0, C.shape[0], axis=1)
    return weighted_cross(C, U, B, w, n_limbs=n_limbs)


def packed_cross(C, Up, Vp, w, *, n_limbs):
    """C + U^T diag(w) V over packed pair incidence."""
    return weighted_cross(C, unpack_bits(Up), unpack_bits(Vp), w,
                          n_limbs=n_limbs)


def hits_matmul(C, H, B, *, n_limbs):
    """C + H @ B in exact uint32.  H: uint8/uint32 [Q, K] hit counts,
    B: int8 0/1 [K, S]."""
    _check_rows(B.shape[0])
    H = H.astype(jnp.uint32)
    for l in range(n_limbs):
        part = jax.lax.dot_general(
            _limb(H, l), B, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        C = C + (part.astype(jnp.uint32) << np.uint32(LIMB_BITS * l))
    return C


def filter_narrow(C, lo, hi, *, dtype):
    """Cells outside the inclusive uint32 bounds [lo, hi] become 0, then
    the matrix narrows to dtype (uint16 when every count fits) — the
    device-side half of a filtered pull."""
    keep = (C >= lo) & (C <= hi)
    return jnp.where(keep, C, jnp.uint32(0)).astype(dtype)


#: jitted steps; the running C is donated so it accumulates in place
gram_step = jax.jit(packed_gram, static_argnames=("n_limbs",),
                    donate_argnums=(0,))
rows_step = jax.jit(packed_gram_rows, static_argnames=("n_limbs",),
                    donate_argnums=(0,))
cross_step = jax.jit(packed_cross, static_argnames=("n_limbs",),
                     donate_argnums=(0,))
pull_filtered = jax.jit(filter_narrow, static_argnames=("dtype",))


@jax.jit
def _kept_max(C, lo, hi):
    return jnp.max(jnp.where((C >= lo) & (C <= hi), C, jnp.uint32(0)))


def narrow_dtype(C, lo=0, hi=0xFFFFFFFF):
    """uint16 when every kept cell of the device matrix fits it (read
    off the device: one reduction and a scalar pull), else uint32."""
    m = int(_kept_max(C, np.uint32(lo), np.uint32(hi)))
    return jnp.uint16 if m < (1 << 16) else jnp.uint32


def pull(C, n_rows: int, n_cols: int, lo=0, hi=0xFFFFFFFF) -> np.ndarray:
    """Device C -> host uint32[n_rows, n_cols] with cells outside
    [lo, hi] zeroed, pulled narrowed to uint16 whenever every kept
    count fits (halves the device->host bytes)."""
    lo, hi = np.uint32(lo), np.uint32(hi)
    out = np.asarray(pull_filtered(C, lo, hi, dtype=narrow_dtype(C, lo, hi)))
    return np.ascontiguousarray(out[:n_rows, :n_cols], dtype=np.uint32)


def pack_rows(B: np.ndarray) -> np.ndarray:
    """Host-side packing of a 0/1 [R, S] matrix into the layout
    unpack_bits reads (R % 8 == 0); for tests and probes."""
    R, S = B.shape
    return np.packbits(B.astype(np.uint8).reshape(R // 8, 8, S), axis=1,
                       bitorder="little").reshape(R // 8, S)


@functools.partial(jax.jit, static_argnames=("n_limbs",))
def reference_gram(B, w, *, n_limbs):
    """Plain reference for the engine, on a separate route: bf16
    operands with 8-bit limbs and float32 accumulation over K chunks of
    at most 65,536 rows (255 * 65,536 < 2^24, exact in float32).
    B: int8 0/1 [K, S], w: uint32[K]; n_limbs counts 8-bit limbs."""
    K, S = B.shape
    ch = min(K, 65536)
    pad = -K % ch
    Bc = jnp.pad(B, ((0, pad), (0, 0))).reshape(-1, ch, S)
    wc = jnp.pad(w.reshape(-1), (0, pad)).reshape(-1, ch)

    def step(C, chunk):
        b, wk = chunk
        bf = b.astype(jnp.bfloat16)
        for l in range(n_limbs):
            wl = ((wk >> np.uint32(8 * l)) & np.uint32(0xFF)).astype(
                jnp.bfloat16)
            part = jax.lax.dot_general(
                bf * wl[:, None], bf, _CONTRACT_ROWS,
                preferred_element_type=jnp.float32)
            C = C + (part.astype(jnp.uint32) << np.uint32(8 * l))
        return C, None

    C, _ = jax.lax.scan(step, jnp.zeros((S, S), jnp.uint32), (Bc, wc))
    return C


#: published dense peak rates (operations/s) by device_kind: NVIDIA
#: H100 data sheet, SXM and PCIe parts, without sparsity
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8": 1.979e15, "bf16": 9.89e14},
    "NVIDIA H100 PCIe": {"int8": 1.513e15, "bf16": 7.56e14},
}


def device_peak(kind: str, dtype: str = "int8") -> float:
    """Published peak of the engine's GEMM type on this device kind;
    a kind missing from PEAKS is an error, never a default."""
    if kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {kind!r}")
    return PEAKS[kind][dtype]
