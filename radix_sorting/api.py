"""Public sort API: typed, stable, strategy-dispatched device sorts.

This is the counterpart of the reference's public surface:

  ``radix_sort(src, aux, n, kf) -> T*``        (`radix_sort.hpp:98-115`)
  ``radix_sort_rank(src, ib, n, kf) -> Idx*``  (`radix_sort_rank.hpp:97-112`)
  ``counting_sort_8 / _8s / _rec_sk``          (`counting_sort_8.c`, `_8s.c`, `_rec_sk.c`)
  ``radix_sort_u32_multipass`` (u64 via 2x32)  (`radix_sort_u64_multipass.c:117-118`)

Differences, by design rather than accident:

* **Functional**: no aux buffer / ping-pong pointer in the API; XLA owns
  buffering. The reference returns "whichever buffer holds the result"
  (`radix_sort.hpp:92`) — here that is simply the returned array.
* **KDF is still the single extension point** (`README.md:543-627`): every
  path KDF-encodes to unsigned word planes, sorts ascending, decodes.
  Descending = derived-key complement (`README.md:566-574`).
* **Keys-only sorts never move data**: they sort the derived words and
  decode (no payload rides the sort).
* 64-bit keys are two uint32 planes (multipass-native); numpy 64-bit inputs
  work without enabling ``jax_enable_x64`` (split host-side), jax 64-bit
  arrays work when x64 is enabled.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .config import DEFAULT_CONFIG, SortConfig, Strategy
from .ops import hw_engine, kdf, lsd_engine, probes

__all__ = [
    "sort",
    "argsort",
    "rank_sort",
    "sort_pairs",
    "counting_sort",
    "sort_u64_multipass",
    "sort_batched",
    "argsort_batched",
    "sort_pairs_batched",
]


# ---------------------------------------------------------------------------
# input normalization


def _as_words(x, descending: bool, allow_nd: bool = False) -> Tuple[Tuple[jax.Array, ...], Any]:
    """KDF-encode an input array (jax or numpy) into uint32 word planes.

    Returns (words, original_dtype). Handles 64-bit numpy inputs without x64 by
    splitting into hi/lo planes host-side, and fixed-width byte-string keys
    (numpy ``S<W>``) as ceil(W/4) big-endian planes (see kdf.encode_bytes_np).
    """
    if isinstance(x, np.ndarray) and x.dtype.kind == "S":
        # must precede the 64-bit branch: S8 also has itemsize 8
        if x.ndim != 1:
            raise ValueError(
                f"byte-string keys must be 1-D, got shape {x.shape}")
        return kdf.encode_bytes_np(x, descending), np.dtype(x.dtype)
    if isinstance(x, np.ndarray) and x.dtype.itemsize == 8 and not jax.config.jax_enable_x64:
        if x.ndim != 1 and not allow_nd:
            raise ValueError(f"keys must be 1-D, got shape {x.shape}")
        return kdf.encode64_np(x, descending), np.dtype(x.dtype)
    xa = jnp.asarray(x)
    if xa.ndim != 1 and not allow_nd:
        raise ValueError(f"keys must be 1-D, got shape {xa.shape}")
    return kdf.encode(xa, descending=descending), xa.dtype


def _decode(words, dtype, descending: bool):
    if isinstance(dtype, np.dtype) and dtype.kind == "S":
        return kdf.decode_bytes_np(words, dtype, descending)
    if isinstance(dtype, np.dtype) and dtype.itemsize == 8 and not jax.config.jax_enable_x64:
        return kdf.decode64_np(words, dtype, descending)
    return kdf.decode(words, dtype, descending=descending)


def _check_index_width(n: int, index_dtype) -> None:
    """Raise when ``index_dtype`` cannot represent indices [0, n) — shared by
    every entry point that builds an index plane (wrapping iota would
    silently corrupt the permutation)."""
    if n - 1 > int(jnp.iinfo(index_dtype).max):
        raise ValueError(
            f"index_dtype {jnp.dtype(index_dtype).name} cannot index {n} keys"
        )


def _is_np64_no_x64(leaf) -> bool:
    """64-bit numpy leaf while x64 is off: jnp.asarray would SILENTLY
    truncate to 32 bits (int64 -> int32, float64 -> float32), corrupting
    payload values — such leaves ride as two raw u32 planes instead."""
    return (isinstance(leaf, np.ndarray) and leaf.dtype.itemsize == 8
            and not jax.config.jax_enable_x64)


# Payload byte fields ride the same big-endian packing the byte-string KEY
# KDF uses (payload planes carry no order semantics, so any bijection would
# do; sharing the key codec keeps one implementation).
_pack_bytes_field = kdf.pack_bytes_be
_unpack_bytes_field = kdf.unpack_bytes_be


def _flatten_payload(values):
    """Payload pytree -> sorter operand planes + rebuild metadata.

    Returns (planes, meta); ``meta`` is ``(treedef, specs)`` where each spec
    is ``None`` (leaf rode natively as one operand), the original 64-bit
    numpy dtype (leaf rode as raw (hi, lo) u32 planes — bit-exact without
    x64, like the distributed payload codec in `parallel/_payload.py`), or
    ``("bytes", W, dt)`` for a fixed-width byte-string field.

    Byte-string fields — the reference's record demo carries a short char
    name per key (`radix_tests.cpp` record fixture; `README.md:252`) — enter
    as numpy ``S``/``V`` 1-D arrays or as ``(n, W)`` uint8/int8 device
    matrices (row = one element's bytes), and ride packed u32 planes.
    """
    if values is None:
        return (), None
    leaves, treedef = jax.tree.flatten(values)
    n = None
    planes, specs = [], []
    for leaf in leaves:
        if (isinstance(leaf, np.ndarray) and leaf.dtype.kind in ("S", "V")
                and leaf.ndim == 1):
            W = leaf.dtype.itemsize
            if W == 0:
                raise ValueError("byte-field payload width must be > 0")
            if W > 256:
                raise ValueError(
                    f"byte-field payload width {W} > 256: each 4 bytes adds "
                    "a sort operand — carry long blobs as an index payload "
                    "and gather on the host instead")
            ln = leaf.shape[0]
            u8 = np.ascontiguousarray(leaf).view(np.uint8).reshape(ln, W)
            planes += list(_pack_bytes_field(jnp.asarray(u8)))
            specs.append(("bytes", W, np.dtype(leaf.dtype)))
        elif _is_np64_no_x64(leaf):
            if leaf.ndim != 1:
                raise ValueError("payload leaves must be 1-D arrays")
            ln = leaf.shape[0]
            hi, lo = kdf.split64_np(leaf)
            planes += [hi, lo]
            specs.append(np.dtype(leaf.dtype))
        else:
            a = jnp.asarray(leaf)
            if a.ndim == 2 and a.dtype in (jnp.uint8, jnp.int8):
                if a.shape[1] == 0:
                    raise ValueError("byte-field payload width must be > 0")
                if a.shape[1] > 256:
                    raise ValueError(
                        f"byte-field payload width {a.shape[1]} > 256: each "
                        "4 bytes adds a sort operand — carry long blobs as "
                        "an index payload and gather on the host instead")
                ln = a.shape[0]
                u8 = (a if a.dtype == jnp.uint8
                      else lax.bitcast_convert_type(a, jnp.uint8))
                planes += list(_pack_bytes_field(u8))
                # string marker, NOT jnp.dtype: jnp.dtype IS np.dtype, and
                # the unflattener uses np.dtype to mean "numpy S/V in/out"
                specs.append(("bytes", int(a.shape[1]),
                              "u8" if a.dtype == jnp.uint8 else "i8"))
            elif a.ndim != 1:
                raise ValueError(
                    "payload leaves must be 1-D arrays (or fixed-width byte "
                    f"fields: numpy S/V or (n, W) uint8/int8), got {a.shape} "
                    f"{a.dtype}")
            else:
                ln = a.shape[0]
                planes.append(a)
                specs.append(None)
        if n is None:
            n = ln
        elif ln != n:
            raise ValueError("payload leaves must share the key length")
    return tuple(planes), (treedef, tuple(specs))


def _unflatten_payload(sorted_planes, meta):
    if meta is None:
        return None
    treedef, specs = meta
    out, i = [], 0
    for spec in specs:
        if spec is None:
            out.append(sorted_planes[i])
            i += 1
        elif isinstance(spec, tuple):  # ("bytes", W, dt)
            _, W, dt = spec
            G = -(-W // 4)
            u8 = _unpack_bytes_field(sorted_planes[i:i + G], W)
            i += G
            if isinstance(dt, np.dtype):  # numpy S/V in -> numpy S/V out
                out.append(np.ascontiguousarray(
                    np.asarray(u8)).view(dt).reshape(-1))
            else:
                out.append(u8 if dt == "u8"
                           else lax.bitcast_convert_type(u8, jnp.int8))
        else:
            hi, lo = sorted_planes[i], sorted_planes[i + 1]
            i += 2
            out.append(kdf.join64_np(hi, lo, spec))
    return jax.tree.unflatten(treedef, out)


def _reject_bytes_mask(dtype, value_mask) -> None:
    """Byte-string keys have no bit-mask story: a hex mask is a fixed-width
    integer promise (`radix_experiment.cpp:188-198`); reject instead of
    silently ignoring it."""
    if value_mask is not None and kdf.is_bytes_dtype(dtype):
        raise ValueError(
            "value_mask is not applicable to byte-string (numpy 'S') keys")


def _validate_value_mask(x, dtype, value_mask: int) -> None:
    """Raise when any key carries live bits outside ``value_mask``.

    One OR-reduce plus a host sync — the opt-in check behind
    ``validate_mask=True`` (the reference's masked experiment likewise
    trusts pre-masked data, `radix_experiment.cpp:188-198`).
    """
    if isinstance(x, np.ndarray):
        bits_or = int(np.bitwise_or.reduce(
            np.ascontiguousarray(x).view(f"u{x.dtype.itemsize}")))
    elif kdf.key_bits(dtype) < 8:
        # sub-byte dtypes have no byte view; raw bits via a same-width bitcast
        raw = lax.bitcast_convert_type(jnp.asarray(x), jnp.uint4)
        bits_or = int(jnp.bitwise_or.reduce(raw.astype(jnp.uint32)))
    elif jnp.dtype(x.dtype).itemsize <= 4:
        raw = jnp.asarray(x).view(jnp.dtype(f"uint{jnp.dtype(x.dtype).itemsize * 8}"))
        bits_or = int(jnp.bitwise_or.reduce(raw.astype(jnp.uint32)))
    else:
        # 64-bit jax arrays (x64 enabled): validate on the raw bits of the
        # two u32 planes of a fresh bitcast.
        v = lax.bitcast_convert_type(jnp.asarray(x), jnp.uint32)  # (..., 2)
        bits_or = (int(jnp.bitwise_or.reduce(v[..., 1].ravel())) << 32) \
            | int(jnp.bitwise_or.reduce(v[..., 0].ravel()))
    width_mask = (1 << kdf.key_bits(dtype)) - 1
    stray = bits_or & ~int(value_mask) & width_mask
    if stray:
        raise ValueError(
            f"value_mask violated: keys carry live bits 0x{stray:X} "
            f"outside mask 0x{int(value_mask):X}"
        )


def _compaction_masks(words, value_mask, dtype,
                      cfg: SortConfig) -> Optional[Tuple[int, ...]]:
    """Per-plane masks when PEXT plane compaction pays for the sorter path.

    Multi-word (64-bit) keys whose static ``value_mask`` leaves <= 32 live
    bits sort as ONE compacted u32 operand instead of two planes — fewer
    operands to move, and on a GPU a one-key sort is the one XLA hands to
    the library radix sort. Single-word keys gain nothing (already 1
    operand).
    The budget here is the 32-bit plane width, NOT ``counting_max_bits``
    (which bounds only an explicit COUNTING request).
    """
    if len(words) != 2 or value_mask is None or kdf.is_bytes_dtype(dtype):
        return None
    if int(words[0].shape[0]) < 2:
        return None          # dead-bit restore samples element 0
    return _static_live_mask(words, value_mask, dtype,
                             cfg.replace(counting_max_bits=32))


def _static_live_mask(words, value_mask, dtype, cfg: SortConfig) -> Optional[Tuple[int, ...]]:
    """Static per-plane live-bit masks (plane compaction, the COUNTING
    contract), or None.

    Static knowledge comes from (a) the dtype's width for narrow integer keys
    — the `counting_sort_8.c` domain — or (b) an explicit ``value_mask``
    (the reference CLI's skip-forcing hex mask, `radix_experiment.cpp:188-198`;
    keys must already be masked by the caller, as the reference does). The
    reference's mask knob covers every key width, so 64-bit keys participate
    too: their masks split into (hi, lo) plane masks.
    """
    if kdf.is_bytes_dtype(dtype):
        # byte-string keys always ride the multi-plane sorter; a value_mask
        # promise has no meaning for them (rejected at the entry points)
        return None
    bits = kdf.key_bits(dtype)   # LOGICAL width (4 for int4/uint4)
    # kdf.kind, NOT numpy's dtype.kind: ml_dtypes floats (bfloat16, float8_*)
    # report numpy kind 'V', which (a) dropped bfloat16 off the counting fast
    # path entirely and (b) skipped the negative-admitting-mask guard below,
    # returning a WRONG positional mask for masked bf16 with live sign bit
    # (the float KDF inverts all bits of negative keys).
    kind = kdf.kind(dtype)
    mask = None
    if value_mask is not None:
        mask = int(value_mask) & ((1 << bits) - 1)
        if kind == "f":
            # The float KDF inverts *all* bits of negative keys
            # (`radix_sort_basic_kdf.hpp:32-38`), so a mask admitting negative
            # values spreads liveness beyond the masked positions. Only
            # all-non-negative masked floats keep a positional live mask
            # (derived key = bits | highbit, sign position dead-constant).
            if mask & (1 << (bits - 1)):
                return None
        # Signed-int KDF is a positional sign-bit XOR: live positions of the
        # derived key equal the live positions of the raw bits.
    elif kind == "b":
        mask = 1  # bool derived domain is exactly {0, 1}: 2-bin counting
    elif kind in ("u", "i", "f") and bits <= cfg.counting_max_bits:
        # Valid for floats too at *dtype width*: the KDF maps a b-bit float
        # into b live derived bits (`_float_mangle` masks to the width), so
        # a 16-bit float's derived word is a dense 16-bit domain.
        mask = (1 << bits) - 1
    if mask is None:
        return None
    if bin(mask).count("1") > min(cfg.counting_max_bits, 32):
        return None
    if len(words) == 2:
        return (mask >> 32, mask & 0xFFFFFFFF)
    return (mask,)


# ---------------------------------------------------------------------------
# public ops


def sort(x, *, config: SortConfig = DEFAULT_CONFIG, value_mask: Optional[int] = None,
         validate_mask: bool = False):
    """Stable sort of a 1-D key array. Returns the sorted array (same dtype).

    The keys-only equivalent of `radix_sort(src, aux, n)` (`radix_sort.hpp:98`).

    ``value_mask`` is a static *promise* that every key satisfies
    ``key == key & value_mask`` (the CLI's column-skip knob,
    `radix_experiment.cpp:188-198` — the reference likewise masks the data
    before sorting). On 64-bit keys with <= 32 live bits it lets the two
    planes sort as ONE compacted operand. A violated promise silently truncates keys to the mask, exactly as
    feeding unmasked data to the reference's masked experiment would; mask
    the data first (``x & mask``) if unsure, or pass ``validate_mask=True``
    to pay one OR-reduce (plus a host sync) and get a ValueError instead.
    """
    cfg = config
    words, dtype = _as_words(x, cfg.descending)
    _reject_bytes_mask(dtype, value_mask)
    n = int(words[0].shape[0])
    if n <= 1:
        # normalize like the n>1 path would (a bare list must not leak back)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x if isinstance(x, jax.Array) else jnp.asarray(x)
    if value_mask is not None and validate_mask:
        _validate_value_mask(x, dtype, value_mask)

    strategy = cfg.strategy
    if strategy == Strategy.COUNTING:
        # the `counting_sort_8.c` contract: keys-only over a small live
        # domain the caller promises statically; it runs the HW_SORT route
        if _static_live_mask(words, value_mask, dtype, cfg) is None:
            raise ValueError(
                "COUNTING strategy needs a narrow key dtype or a value_mask with "
                f"<= {cfg.counting_max_bits} live bits"
            )
        strategy = Strategy.HW_SORT
    # Computed once, consulted twice: the device-probe guard below and the
    # operand selection must see the SAME answer — the guard's correctness
    # argument is "whenever the probe is skipped, compaction definitely
    # engages".
    cmasks = _compaction_masks(words, value_mask, dtype, cfg)
    if strategy == Strategy.AUTO:
        if cmasks is None and cfg.dynamic_probe and len(words) == 2 \
                and not any(isinstance(w, jax.core.Tracer) for w in words):
            # Runtime column-skip probe (the reference's histogram probe,
            # `radix_sort.hpp:64-70`, in live-bit form): measure which bits
            # actually vary. Always correct — dead bits are constant by
            # MEASUREMENT, no promise involved — at the cost of one reduce
            # plus a host sync. The masks describe the encoded (possibly
            # complemented) planes themselves, so they are positional for
            # every dtype. A one-word key has nothing to gain: it is one
            # sorter operand already.
            measured = tuple(int(m) for m in
                             jax.device_get(probes.live_bit_mask(words)))
            if 0 < sum(bin(m).count("1") for m in measured) <= 32:
                cmasks = measured
        if cmasks is None and cfg.device_probe and len(words) == 2:
            # (The compaction guard: a 64-bit value_mask with <= 32 live
            # bits is a *static* promise of the one-operand sorter route,
            # which must not be pre-empted by the runtime probe; the probe
            # only helps unpromised data.)
            # In-graph probe, NO host sync: a constant hi plane (any key
            # population inside one 2^32 span) sorts the lo plane as ONE
            # operand (see hw_engine.sort_words2_range_probe). A one-word
            # key has nothing to probe for.
            sw = hw_engine.sort_words2_range_probe(
                words[0], words[1], guard=cfg.detect_presorted)
            return _decode(sw, dtype, cfg.descending)
        strategy = Strategy.HW_SORT

    if strategy == Strategy.LSD:
        # plane compaction pays here too (fewer words -> fewer digit passes);
        # mirrors sort_pairs' LSD route
        operands = words if cmasks is None \
            else (probes.compact_word_planes(words, cmasks),)
        sw, _ = lsd_engine.sort_words_lsd(
            operands, (), radix_bits=cfg.radix_bits, chunk=cfg.lsd_chunk,
            skip_trivial=cfg.skip_trivial_digits,
        )
        if cmasks is not None:
            sw = probes.expand_word_planes(sw[0], words, cmasks)
        return _decode(sw, dtype, cfg.descending)

    # HW_SORT; keys-only, so the unstable fast path is exact (see hw_engine).
    # Masked 64-bit keys with <= 32 live bits sort as ONE compacted operand,
    # the one-key sort XLA hands to the library radix sort, instead of the
    # two-key comparison sort of the raw planes.
    operands = words if cmasks is None \
        else (probes.compact_word_planes(words, cmasks),)
    if cfg.detect_presorted:
        sw, _ = hw_engine.sort_words_presort_guard(operands, stable=False)
    else:
        sw, _ = hw_engine.sort_words(operands, stable=False)
    if cmasks is not None:
        sw = probes.expand_word_planes(sw[0], words, cmasks)
    return _decode(sw, dtype, cfg.descending)


def argsort(x, *, config: SortConfig = DEFAULT_CONFIG, index_dtype=jnp.uint32,
            value_mask: Optional[int] = None, validate_mask: bool = False):
    """Stable argsort: the rank/index sort (`radix_sort_rank.hpp:97-112`).

    The input is never modified (the reference takes ``const T* RESTRICT``);
    returns the unique stable permutation as ``index_dtype``.

    ``value_mask`` (same promise as :func:`sort`) lets masked 64-bit keys
    with <= 32 live bits rank with ONE compacted key operand instead of two
    planes.
    """
    cfg = config
    words, dtype = _as_words(x, cfg.descending)
    _reject_bytes_mask(dtype, value_mask)
    n = int(words[0].shape[0])
    _check_index_width(n, index_dtype)
    iota = jnp.arange(n, dtype=index_dtype)
    if n <= 1:
        return iota
    if value_mask is not None and validate_mask:
        _validate_value_mask(x, dtype, value_mask)

    if cfg.strategy == Strategy.COUNTING:
        # raise like sort() does for an inapplicable COUNTING request —
        # silently running the sorter would measure the wrong engine
        raise ValueError(
            "Strategy.COUNTING is keys-only (the `counting_sort_8.c` "
            "contract); use AUTO, LSD, or HW_SORT for argsort")
    if cfg.strategy == Strategy.LSD:
        _, (perm,) = lsd_engine.sort_words_lsd(
            words, (iota,), radix_bits=cfg.radix_bits, chunk=cfg.lsd_chunk,
            skip_trivial=cfg.skip_trivial_digits,
        )
        return perm
    cmasks = _compaction_masks(words, value_mask, dtype, cfg)
    operands = words if cmasks is None \
        else (probes.compact_word_planes(words, cmasks),)
    # The index rides as the LAST SORT KEY: (key, index) is strict, so the
    # unstable sorter yields exactly the stable permutation, measurably
    # faster than carrying the index as payload (see hw_engine.argsort_words).
    # The presorted predicate is unchanged by the appended increasing index.
    if cfg.detect_presorted:
        sw, _ = hw_engine.sort_words_presort_guard(operands + (iota,),
                                                   stable=False)
        return sw[-1]
    _, perm = hw_engine.argsort_words(operands, index_dtype=index_dtype)
    return perm


# Reference naming alias: rank sort == argsort (`radix_sort_rank.hpp:7`).
rank_sort = argsort


def sort_pairs(keys, values, *, config: SortConfig = DEFAULT_CONFIG,
               value_mask: Optional[int] = None, validate_mask: bool = False):
    """Stable sort of keys carrying an arbitrary payload pytree.

    The record-sort capability (`counting_sort_rec_sk.c:14-41`,
    `radix_tests.cpp:45-69`): the reference sorts structs via a key-extraction
    function; the array-program equivalent is structure-of-arrays payload
    permutation in the same fused sort.

    Payload leaves are 1-D arrays of any supported dtype (64-bit numpy
    leaves ride bit-exactly without x64), or fixed-width byte-string fields
    — the reference's record demo carries a short char name per key
    (`README.md:252`) — as numpy ``S``/``V`` 1-D arrays or ``(n, W)``
    uint8/int8 matrices, packed 4 bytes per u32 operand plane (whether one
    argsort + a gather beats wide operands on a GPU is ROADMAP queue 2).

    ``value_mask`` (same promise as :func:`sort`) lets masked 64-bit keys
    with <= 32 live bits ship ONE compacted key operand through the stable
    sorter instead of two planes. Compaction is a bijection on the masked
    domain, so key equality — and with it the stable payload order — is
    preserved exactly.
    """
    cfg = config
    words, dtype = _as_words(keys, cfg.descending)
    _reject_bytes_mask(dtype, value_mask)
    leaves, pmeta = _flatten_payload(values)
    n = int(words[0].shape[0])
    if n != (leaves[0].shape[0] if leaves else n):
        raise ValueError("keys and payload lengths differ")
    if value_mask is not None and validate_mask:
        _validate_value_mask(keys, dtype, value_mask)

    if cfg.strategy == Strategy.COUNTING:
        raise ValueError(
            "Strategy.COUNTING is keys-only (the `counting_sort_8.c` "
            "contract); use AUTO, LSD, or HW_SORT for sort_pairs")
    cmasks = _compaction_masks(words, value_mask, dtype, cfg)
    operands = words if cmasks is None \
        else (probes.compact_word_planes(words, cmasks),)
    if cfg.strategy == Strategy.LSD:
        sw, sp = lsd_engine.sort_words_lsd(
            operands, leaves, radix_bits=cfg.radix_bits, chunk=cfg.lsd_chunk,
            skip_trivial=cfg.skip_trivial_digits,
        )
    elif cfg.detect_presorted:
        sw, sp = hw_engine.sort_words_presort_guard(operands, leaves)
    else:
        sw, sp = hw_engine.sort_words(operands, leaves)
    if cmasks is not None:
        sw = probes.expand_word_planes(sw[0], words, cmasks)
    sorted_keys = _decode(sw, dtype, cfg.descending)
    return sorted_keys, _unflatten_payload(sp, pmeta)


def counting_sort(keys, values=None, *, config: SortConfig = DEFAULT_CONFIG):
    """Counting sort for narrow integer keys (<= 16 bits).

    Keys-only: the `counting_sort_8.c` contract, realized as one library
    sort of the narrow derived key (on a GPU no histogram + regeneration
    formulation beat it at any domain up to 2^17 bins; PERF.md). With
    payload: the stable scatter form
    (`counting_sort_8s.c`, record form `counting_sort_rec_sk.c`), realized as
    a single stable sort by the narrow derived key.
    """
    bits = jnp.dtype(jnp.asarray(keys).dtype).itemsize * 8
    if bits > 16:
        raise TypeError("counting_sort requires a key dtype of <= 16 bits")
    if values is None:
        return sort(keys, config=config.replace(strategy=Strategy.AUTO))
    # the payload form IS the counting-with-payload realization (stable sort
    # by the narrow key), so an explicit COUNTING request maps to AUTO here
    # rather than tripping sort_pairs' keys-only COUNTING rejection
    if config.strategy == Strategy.COUNTING:
        config = config.replace(strategy=Strategy.AUTO)
    return sort_pairs(keys, values, config=config)


def sort_u64_multipass(x, *, config: SortConfig = DEFAULT_CONFIG):
    """64-bit sort as two chained stable 32-bit sorts.

    The explicit multipass composition of `radix_sort_u64_multipass.c:117-118`:
    sort by the low word, then stable-sort by the high word — correct only
    because each pass is stable (`README.md:471-473`). The general :func:`sort`
    handles 64-bit keys as one two-word sort; this entry point exists to keep
    the multipass contract itself tested and benchmarkable.
    """
    cfg = config
    words, dtype = _as_words(x, cfg.descending)
    if len(words) != 2:
        raise TypeError("sort_u64_multipass requires a 64-bit key dtype")
    hi, lo = words
    # pass 1: keyshift 0 — sort by low word, carry high word
    (lo1,), (hi1,) = hw_engine.sort_words((lo,), (hi,))
    # pass 2: keyshift 32 — stable sort by high word, carry low word
    # (stability is what makes the composition correct, `README.md:471-473`)
    (hi2,), (lo2,) = hw_engine.sort_words((hi1,), (lo1,))
    return _decode((hi2, lo2), dtype, cfg.descending)


# ---------------------------------------------------------------------------
# batched (multi-row) sorts
#
# The reference is strictly 1-D (`radix_sort.hpp:98`: one array, one aux
# buffer), so these have no reference counterpart — they are the natural
# extension: `lax.sort` sorts along any dimension of an N-D operand in
# one fused device program, so a (B, n) batch costs one dispatch, not B.


def _moveaxis_last(x, axis: int):
    """(x with `axis` moved last, normalized axis). Works for jax and numpy."""
    ndim = x.ndim
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of bounds for {ndim}-D keys")
    axis %= ndim
    if axis == ndim - 1:
        return x, axis
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(np.moveaxis(x, axis, -1)), axis
    return jnp.moveaxis(x, axis, -1), axis


def _restore_axis(x, axis: int):
    if axis == x.ndim - 1:
        return x
    mv = np.moveaxis if isinstance(x, np.ndarray) else jnp.moveaxis
    return mv(x, -1, axis)



def _single_batch(xm) -> bool:
    """True when the batch collapses to one row. The batched entry points
    reshape such batches to 1-D, so that they take the 1-D sort path (on a
    GPU a batched `lax.sort` is XLA's own sort kernel, a 1-D one-key sort
    the library radix sort)."""
    return int(np.prod(xm.shape[:-1])) == 1

def sort_batched(x, *, axis: int = -1, config: SortConfig = DEFAULT_CONFIG):
    """Independently sort every 1-D slice of ``x`` along ``axis``.

    Keys-only, any supported dtype, ascending or descending via
    ``config.descending``. One fused device sort over the whole batch.
    """
    xm, axis = _moveaxis_last(x, axis)
    if _single_batch(xm):
        out = sort(xm.reshape(-1), config=config)
        return _restore_axis(out.reshape(xm.shape), axis)
    words, dtype = _as_words(xm, config.descending, allow_nd=True)
    dim = words[0].ndim - 1
    sw = lax.sort(tuple(words), dimension=dim, is_stable=False,
                  num_keys=len(words))
    return _restore_axis(_decode(tuple(sw), dtype, config.descending), axis)


def argsort_batched(x, *, axis: int = -1, config: SortConfig = DEFAULT_CONFIG,
                    index_dtype=jnp.uint32):
    """Stable argsort of every 1-D slice along ``axis``.

    Returns per-slice indices (the batched form of :func:`argsort`); ties
    resolve to the lower index, the unique stable permutation per row.
    """
    xm, axis = _moveaxis_last(x, axis)
    if _single_batch(xm):
        out = argsort(xm.reshape(-1), config=config, index_dtype=index_dtype)
        return _restore_axis(out.reshape(xm.shape), axis)
    words, _ = _as_words(xm, config.descending, allow_nd=True)
    dim = words[0].ndim - 1
    _check_index_width(int(words[0].shape[dim]), index_dtype)
    iota = lax.broadcasted_iota(index_dtype, words[0].shape, dim)
    # index as last sort key: strict order, unstable sorter, stable result
    out = lax.sort(tuple(words) + (iota,), dimension=dim, is_stable=False,
                   num_keys=len(words) + 1)
    return _restore_axis(out[-1], axis)


def sort_pairs_batched(keys, values, *, axis: int = -1,
                       config: SortConfig = DEFAULT_CONFIG):
    """Stable batched record sort: keys + payload pytree, each leaf key-shaped.

    The batched form of :func:`sort_pairs`; every leaf is permuted by its
    row's stable key order in the same fused sort.
    """
    key_shape = tuple(jnp.shape(keys))
    km, axis = _moveaxis_last(keys, axis)
    words, dtype = _as_words(km, config.descending, allow_nd=True)
    dim = words[0].ndim - 1
    leaves, treedef = jax.tree.flatten(values)
    moved, specs, norm_leaves = [], [], []
    for leaf in leaves:
        if _is_np64_no_x64(leaf):
            # ride as raw (hi, lo) u32 planes; jnp.asarray would silently
            # truncate (see _flatten_payload)
            if tuple(leaf.shape) != key_shape:
                raise ValueError("payload leaves must match the keys' shape")
            hi, lo = kdf.split64_np(leaf)
            moved += [_moveaxis_last(hi, axis)[0], _moveaxis_last(lo, axis)[0]]
            specs.append(np.dtype(leaf.dtype))
            norm_leaves.append(leaf)
        else:
            la = jnp.asarray(leaf)
            if tuple(la.shape) != key_shape:
                raise ValueError("payload leaves must match the keys' shape")
            moved.append(_moveaxis_last(la, axis)[0])
            specs.append(None)
            norm_leaves.append(la)
    if _single_batch(km):
        shp = km.shape
        flat_leaves = [leaf.reshape(-1) for leaf in norm_leaves]  # dtype-preserving
        sk, sv = sort_pairs(
            km.reshape(-1), jax.tree.unflatten(treedef, flat_leaves),
            config=config)
        return (_restore_axis(sk.reshape(shp), axis),
                jax.tree.map(lambda p: _restore_axis(p.reshape(shp), axis), sv))
    out = lax.sort(tuple(words) + tuple(moved), dimension=dim, is_stable=True,
                   num_keys=len(words))
    sw, sp = out[: len(words)], out[len(words):]
    sorted_keys = _restore_axis(_decode(tuple(sw), dtype, config.descending), axis)
    rebuilt, i = [], 0
    for spec in specs:
        if spec is None:
            rebuilt.append(_restore_axis(sp[i], axis))
            i += 1
        else:
            rebuilt.append(_restore_axis(
                kdf.join64_np(sp[i], sp[i + 1], spec), axis))
            i += 2
    return sorted_keys, jax.tree.unflatten(treedef, rebuilt)
