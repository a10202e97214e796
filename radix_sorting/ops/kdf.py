"""Key-derivation functions (KDF): order-preserving bijections into unsigned words.

A re-design of the reference KDF library (`radix_sort_basic_kdf.hpp:10-48`).
The reference maps any fixed-width key type ``T`` to an unsigned integer of the same
width such that ``kdf(a) < kdf(b)  <=>  a < b`` (in the desired order), which lets a
single unsigned radix engine sort every type:

* unsigned ints: identity                      (`radix_sort_basic_kdf.hpp:19-23`)
* signed ints:   flip the sign bit             (`radix_sort_basic_kdf.hpp:26-30`)
* float32:       ``x ^ (-(x >> 31) | 0x80000000)``  (`radix_sort_basic_kdf.hpp:32-38`)
* float64:       the 64-bit analog             (`radix_sort_basic_kdf.hpp:40-46`)
* descending order: complement the derived key (`README.md:566-574`)

Differences from the reference:

* Keys are encoded into one or two **uint32 words** (``(w,)`` for <=32-bit keys,
  ``(hi, lo)`` for 64-bit keys, most significant first). ``jax_enable_x64`` is
  off by default, so the natural device representation of a 64-bit key is a
  pair of u32 planes.
  This is also exactly the shape the multipass engine wants
  (`radix_sort_u64_multipass.c:117-118`: a 64-bit sort is two chained stable
  32-bit sorts), so the KDF produces multipass-ready words directly.
* The KDF here is a **bijection with an explicit inverse** (`decode``). For
  keys-only sorts the engine sorts the derived words and *decodes* the result,
  instead of carrying the original values as payload — halving data movement.
* bfloat16/float16 are first-class, via the same sign-mangle rule applied at
  their width — as are the ML quantization dtypes: float8_e4m3fn/e5m2
  (8-bit mangle) and int4/uint4 (identity/sign-flip at the LOGICAL
  4-bit width — ``key_bits`` reports 4 even though jnp storage is
  byte-backed; sub-byte arrays have no byte view, so raw-bit access goes
  through same-width bitcasts).

All functions are jit-compatible and shape-preserving.

NaN payloads: the KDF is bit-faithful, so NaNs order by sign and payload. On an
NVIDIA H100 float16, bfloat16 and float32 NaN payloads survive the device bit
for bit (``chip_smoke.py`` sorts 40M random bit patterns of each against a
host oracle).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "encode",
    "decode",
    "num_words",
    "key_bits",
    "complement",
    "split64_np",
    "encode64_np",
    "decode64_np",
    "join64_np",
    "is_bytes_dtype",
    "pack_bytes_be",
    "unpack_bytes_be",
    "encode_bytes_np",
    "decode_bytes_np",
    "SUPPORTED_DTYPES",
]

_U32 = jnp.uint32
_HIGHBIT32 = np.uint32(0x80000000)

# Key dtypes the framework sorts natively (reference supports u8..u64, i32, i64,
# f32, f64 via its CLI dispatch, `radix_experiment.cpp:264-279`; we add the rest
# of the signed widths plus the half-precision floats).
SUPPORTED_DTYPES = (
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64",
    "float8_e4m3fn", "float8_e5m2",  # beyond-reference: the ML dtypes —
    # the same sign-mangle rule at 8-bit width (a 256-value COUNTING domain)
    "int4", "uint4",  # beyond-reference: quantization dtypes — a 16-value
    # COUNTING domain (identity / sign-flip at 4-bit width)
    "bool",  # beyond-reference: argsort(bool) is a stable partition
)

# dtypes whose LOGICAL width differs from their byte-backed storage width
_SUB_BYTE_BITS = {"int4": 4, "uint4": 4}


# --- fixed-width byte-string keys -----------------------------------------
#
# Beyond-reference key type: numpy ``S<W>`` byte strings. The reference's
# record demo sorts BY a one-byte key and merely carries a char name
# (`counting_sort_rec_sk.c:10-12`); sorting by the string itself is the
# natural generalization, and it needs no new engine: big-endian packing of
# the W padded bytes into ceil(W/4) u32 planes makes unsigned multi-word
# plane order IDENTICAL to byte-lexicographic order, which is exactly
# numpy's ordering for same-width ``S`` arrays (trailing-NUL padding
# compares below every non-NUL byte in both). The multi-word sorter —
# already exercised by 64-bit (hi, lo) keys — handles any plane count.

_MAX_BYTES_KEY_WIDTH = 256  # each 4 bytes is one sort operand, so very wide
# keys should ride as index payload + host gather instead.


def is_bytes_dtype(dtype) -> bool:
    """True for numpy fixed-width byte-string dtypes (kind 'S')."""
    if isinstance(dtype, str) or dtype is None:
        return False
    try:
        return np.dtype(dtype).kind == "S"
    except TypeError:
        return False


def pack_bytes_be(u8mat: jax.Array) -> Tuple[jax.Array, ...]:
    """(n, W) uint8 -> ceil(W/4) big-endian u32 planes, most significant first.

    Big-endian packing is what makes unsigned plane comparison equal
    byte-lexicographic comparison; ragged tails zero-pad (order-neutral:
    the pad columns are identical across elements). Inverse:
    :func:`unpack_bytes_be`.
    """
    n, W = u8mat.shape
    G = -(-W // 4)
    if W != G * 4:
        u8mat = jnp.pad(u8mat, ((0, 0), (0, G * 4 - W)))
    cols = u8mat.astype(_U32)
    return tuple(
        (cols[:, 4 * g] << 24) | (cols[:, 4 * g + 1] << 16)
        | (cols[:, 4 * g + 2] << 8) | cols[:, 4 * g + 3]
        for g in range(G))


def unpack_bytes_be(planes, W: int) -> jax.Array:
    """Inverse of :func:`pack_bytes_be`: u32 planes -> (n, W) uint8."""
    cols = [((p >> np.uint32(s)) & np.uint32(0xFF)).astype(jnp.uint8)
            for p in planes for s in (24, 16, 8, 0)]
    return jnp.stack(cols, axis=1)[:, :W]


def _check_bytes_width(W: int) -> None:
    if W == 0:
        raise ValueError("byte-string key width must be > 0 (got S0)")
    if W > _MAX_BYTES_KEY_WIDTH:
        raise ValueError(
            f"byte-string key width {W} > {_MAX_BYTES_KEY_WIDTH}: each 4 "
            "bytes adds a sort operand — sort an index payload and gather "
            "long blobs on the host instead")


def encode_bytes_np(x: np.ndarray, descending: bool = False) -> Tuple[jax.Array, ...]:
    """KDF-encode a 1-D numpy ``S<W>`` array into u32 planes (MSW first).

    The derived planes order exactly as numpy orders the byte strings;
    ``descending=True`` complements every plane (`README.md:566-574` —
    the complement trick is width-agnostic). Inverse: :func:`decode_bytes_np`.
    """
    d = np.dtype(x.dtype)
    if d.kind != "S":
        raise TypeError(f"expected a numpy 'S' dtype, got {d}")
    W = d.itemsize
    _check_bytes_width(W)
    u8 = np.ascontiguousarray(x).view(np.uint8).reshape(x.shape[0], W)
    words = pack_bytes_be(jnp.asarray(u8))
    return complement(words) if descending else words


def decode_bytes_np(words: Sequence[jax.Array], dtype,
                    descending: bool = False) -> np.ndarray:
    """Host-side inverse of :func:`encode_bytes_np`: numpy array of ``dtype``."""
    d = np.dtype(dtype)
    W = d.itemsize
    if descending:
        words = complement(words)
    u8 = unpack_bytes_be(tuple(words), W)
    return np.ascontiguousarray(np.asarray(u8)).view(d).reshape(-1)


def _canonical_dtype(dtype) -> np.dtype:
    d = jnp.dtype(dtype)
    if d.name not in SUPPORTED_DTYPES:
        raise TypeError(f"unsupported key dtype {d.name}; supported: {SUPPORTED_DTYPES}")
    return d


def kind(dtype) -> str:
    """'u' / 'i' / 'f' / 'b' / 'S' — robust to ml_dtypes (bfloat16 reports numpy kind 'V')."""
    if is_bytes_dtype(dtype):
        return "S"
    d = _canonical_dtype(dtype)
    if d == jnp.bool_:
        return "b"
    if jnp.issubdtype(d, jnp.floating):
        return "f"
    if jnp.issubdtype(d, jnp.unsignedinteger):
        return "u"
    return "i"


def key_bits(dtype) -> int:
    """LOGICAL width of the key type in bits (4 for the sub-byte int4/uint4,
    whose jnp storage is byte-backed; 8*W for byte-string keys)."""
    if is_bytes_dtype(dtype):
        return np.dtype(dtype).itemsize * 8
    d = _canonical_dtype(dtype)
    return _SUB_BYTE_BITS.get(d.name, d.itemsize * 8)


def num_words(dtype) -> int:
    """Number of uint32 planes the encoded key occupies (1 for <=32-bit,
    2 for 64-bit, ceil(W/4) for byte-string keys)."""
    if is_bytes_dtype(dtype):
        return -(-np.dtype(dtype).itemsize // 4)
    return 2 if key_bits(dtype) == 64 else 1


def split64_np(x: np.ndarray) -> Tuple[jax.Array, jax.Array]:
    """Raw (hi, lo) u32 device planes of a 64-bit numpy array, no x64 needed.

    Pure bit split (no KDF transform); inverse is :func:`join64_np`.
    """
    u = np.ascontiguousarray(x).view(np.uint64)
    hi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray(u.astype(np.uint32))
    return hi, lo


def join64_np(hi, lo, dtype) -> np.ndarray:
    """Host-side inverse of :func:`split64_np`: 64-bit numpy array of ``dtype``."""
    u = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).astype(np.uint64)
    return u.view(np.dtype(dtype))


def encode64_np(x: np.ndarray, descending: bool = False) -> Tuple[jax.Array, jax.Array]:
    """KDF-encode a 64-bit NUMPY array into (hi, lo) u32 planes, no x64 needed.

    The numpy-input counterpart of :func:`encode`'s 64-bit branch — the same
    sign-flip / float-mangle rules applied to the raw planes, kept HERE so
    the KDF stays the single extension point (CLAUDE.md invariant; a copy of
    these rules previously lived in api._as_words).
    """
    hi, lo = split64_np(x)
    kind = np.dtype(x.dtype).kind
    if kind == "i":
        hi = hi ^ np.uint32(0x80000000)
    elif kind == "f":
        sign = hi >> np.uint32(31)
        ext = jnp.zeros_like(hi) - sign              # 0x00000000 or 0xFFFFFFFF
        hi = hi ^ (ext | np.uint32(0x80000000))
        lo = lo ^ ext
    words = (hi, lo)
    if descending:
        words = complement(words)
    return words


def decode64_np(words, dtype, descending: bool = False) -> np.ndarray:
    """Host-side inverse of :func:`encode64_np`: 64-bit numpy array of ``dtype``."""
    hi, lo = (complement(words) if descending else words)
    kind = np.dtype(dtype).kind
    hi_np = np.asarray(hi).astype(np.uint64)
    lo_np = np.asarray(lo).astype(np.uint64)
    if kind == "i":
        hi_np = hi_np ^ np.uint64(0x80000000)
    elif kind == "f":
        nonneg = (hi_np >> np.uint64(31)) & np.uint64(1)
        ext = np.where(nonneg == 1, np.uint64(0), np.uint64(0xFFFFFFFF))
        hi_np = np.where(nonneg == 1, hi_np ^ np.uint64(0x80000000),
                         ~hi_np & np.uint64(0xFFFFFFFF))
        lo_np = lo_np ^ ext
    return join64_np(hi_np, lo_np, dtype)


def _split64(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Split a 64-bit array into (hi, lo) uint32 planes without requiring x64 mode.

    Works by bitcasting each 64-bit element to a ``(... , 2)`` uint32 view and
    unpacking according to host endianness (JAX bitcast follows the platform's
    little-endian layout).
    """
    v = lax.bitcast_convert_type(x, _U32)  # shape (..., 2), little-endian: [lo, hi]
    return v[..., 1], v[..., 0]


def _join64(hi: jax.Array, lo: jax.Array, dtype) -> jax.Array:
    v = jnp.stack([lo, hi], axis=-1)
    return lax.bitcast_convert_type(v, jnp.dtype(dtype))


def _flip_sign_bit(w: jax.Array, bits: int) -> jax.Array:
    return w ^ np.uint32(1 << (bits - 1))


def _float_mangle(w: jax.Array, bits: int) -> jax.Array:
    """Map raw float bits to an order-preserving unsigned key.

    Reference rule (`radix_sort_basic_kdf.hpp:32-38`):
    ``key = bits ^ (-(bits >> (B-1)) | (1 << (B-1)))`` — negative floats have all
    bits inverted (reversing their order), non-negative floats get the sign bit
    set. Total order: -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN, matching
    the reference's observable ordering on the `radix_tests.cpp:157` fixture.
    """
    live = np.uint32((1 << bits) - 1) if bits < 32 else np.uint32(0xFFFFFFFF)
    sign = w >> np.uint32(bits - 1)
    mask = ((jnp.zeros_like(w) - sign) & live) | np.uint32(1 << (bits - 1))
    return w ^ mask


def _float_unmangle(k: jax.Array, bits: int) -> jax.Array:
    # Inverse: keys with the high bit set were non-negative (just clear it);
    # keys with the high bit clear were negative (invert all bits).
    highbit = np.uint32(1 << (bits - 1))
    was_nonneg = (k & highbit) != 0
    return jnp.where(was_nonneg, k ^ highbit, ~k & np.uint32((1 << bits) - 1))


def encode(x: jax.Array, descending: bool = False) -> Tuple[jax.Array, ...]:
    """Encode keys into order-preserving uint32 word planes (most significant first).

    Returns ``(w,)`` for keys of <=32 bits (narrow keys are zero-extended so only
    the low ``key_bits`` of ``w`` are live — the column-skip probe then elides the
    dead high digits, mirroring `radix_sort.hpp:64-70`), or ``(hi, lo)`` for
    64-bit keys.

    ``descending=True`` complements the derived key (`README.md:566-574`), so a
    single ascending engine produces stable descending sorts, exactly like the
    reference's ``~kdf`` wrappers (`radix_tests.cpp:111-113,175-177`).
    """
    d = _canonical_dtype(x.dtype)
    bits = key_bits(d)
    k = kind(d)

    if bits == 64:
        if k == "u":
            hi, lo = _split64(x)
        elif k == "i":
            hi, lo = _split64(x)
            hi = _flip_sign_bit(hi, 32)
        elif k == "f":
            hi, lo = _split64(x)
            sign = hi >> np.uint32(31)
            ext = jnp.zeros_like(hi) - sign          # 0x00000000 or 0xFFFFFFFF
            hi = hi ^ (ext | _HIGHBIT32)
            lo = lo ^ ext
        else:  # pragma: no cover
            raise TypeError(d)
        words = (hi, lo)
    else:
        if k == "b":
            # False < True; the derived domain is exactly {0, 1}
            w = x.astype(_U32)
        elif k == "u":
            w = x.astype(_U32)
        elif k == "i":
            # Sign-flip at the native width, then zero-extend: reinterpret as
            # unsigned of the same width, XOR the native sign bit.
            uw = lax.bitcast_convert_type(x, jnp.dtype(f"uint{bits}")).astype(_U32)
            w = _flip_sign_bit(uw, bits)
        elif k == "f":
            uw = lax.bitcast_convert_type(x, jnp.dtype(f"uint{bits}")).astype(_U32)
            w = _float_mangle(uw, bits)
        else:  # pragma: no cover
            raise TypeError(d)
        words = (w,)

    if descending:
        live = np.uint32((1 << min(bits, 32)) - 1 if bits < 32 else 0xFFFFFFFF)
        # Complement only the live bits so narrow keys stay zero-extended and
        # the dead high digits remain skippable.
        words = tuple((~w) & live if bits < 32 and i == len(words) - 1 else ~w
                      for i, w in enumerate(words))
    return words


def decode(words: Sequence[jax.Array], dtype, descending: bool = False) -> jax.Array:
    """Inverse of :func:`encode`: recover original key values from derived words."""
    d = _canonical_dtype(dtype)
    bits = key_bits(d)
    k = kind(d)

    if descending:
        if bits < 32:
            live = np.uint32((1 << bits) - 1)
            words = tuple((~w) & live for w in words)
        else:
            words = tuple(~w for w in words)

    if bits == 64:
        hi, lo = words
        if k == "u":
            pass
        elif k == "i":
            hi = _flip_sign_bit(hi, 32)
        elif k == "f":
            was_nonneg = (hi & _HIGHBIT32) != 0
            ext = jnp.where(was_nonneg, np.uint32(0), np.uint32(0xFFFFFFFF))
            hi = jnp.where(was_nonneg, hi ^ _HIGHBIT32, ~hi)
            lo = lo ^ ext
        return _join64(hi, lo, d)

    (w,) = words
    if k == "b":
        return w.astype(jnp.bool_)
    if k == "u":
        return w.astype(d) if bits < 32 else lax.bitcast_convert_type(w, d)
    if k == "i":
        uw = _flip_sign_bit(w, bits)
        if bits < 32:
            uw = uw.astype(jnp.dtype(f"uint{bits}"))
        return lax.bitcast_convert_type(uw, d)
    # float
    uw = _float_unmangle(w, bits)
    if bits < 32:
        uw = uw.astype(jnp.dtype(f"uint{bits}"))
    return lax.bitcast_convert_type(uw, d)


def complement(words: Sequence[jax.Array]) -> Tuple[jax.Array, ...]:
    """Complement derived keys: ascending-engine input for a descending sort.

    Equivalent of the reference's ``~kf(x)`` trick (`README.md:566-574`).
    """
    return tuple(~w for w in words)
