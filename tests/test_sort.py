"""Value-sort tests across dtypes, strategies, and degenerate inputs.

Mirrors `radix_tests.cpp`: 50k random ints forward + reverse (`test_int`,
:179-207), float edge cases (`test_float`, :156-173), plus the degeneracy
injectors SURVEY §5 calls for (constant, presorted, reverse, masked).
"""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.utils import verify

STRATEGIES = [rst.Strategy.AUTO, rst.Strategy.HW_SORT, rst.Strategy.LSD]


def _np_sorted(x, descending=False):
    s = np.sort(np.asarray(x), kind="stable")
    return s[::-1] if descending else s


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32", "int8", "int16", "int32"])
def test_random_ints(rng, strategy, dtype):
    d = np.dtype(dtype)
    info = np.iinfo(d)
    x = rng.integers(info.min, int(info.max) + 1, size=50_000, dtype=d)
    cfg = rst.SortConfig(strategy=strategy)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, _np_sorted(x))


@pytest.mark.parametrize("dtype", ["uint32", "int32"])
def test_random_ints_descending(rng, dtype):
    d = np.dtype(dtype)
    info = np.iinfo(d)
    x = rng.integers(info.min, int(info.max) + 1, size=50_000, dtype=d)
    cfg = rst.SortConfig(descending=True)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, _np_sorted(x, descending=True))
    assert verify.is_sorted(out, descending=True)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_float_edge_cases(strategy):
    # the reference float fixture (`radix_tests.cpp:157`), NaN included
    x = np.array([0.0, -0.0, 0.5, -0.5, 128.0, -128.0, 646464.0, np.inf,
                  -np.inf, np.nan], dtype=np.float32)
    cfg = rst.SortConfig(strategy=strategy)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    # KDF total order: -inf < -128 < -0.5 < -0 < +0 < 0.5 < 128 < 646464 < inf < nan
    expect = np.array([-np.inf, -128.0, -0.5, -0.0, 0.0, 0.5, 128.0, 646464.0,
                       np.inf, np.nan], dtype=np.float32)
    assert np.array_equal(out.view(np.uint32), expect.view(np.uint32))
    assert verify.same_multiset(out, x)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_random_floats(rng, dtype):
    n = 20_000
    if dtype == "bfloat16":
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32)).astype(jnp.bfloat16)
        out = rst.sort(x)
        xs = np.sort(np.asarray(x.astype(jnp.float32)))
        assert np.array_equal(np.asarray(out.astype(jnp.float32)), xs)
        return
    x = rng.standard_normal(n).astype(dtype)
    out = np.asarray(rst.sort(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2"])
def test_float8_sorts(rng, dtype):
    # 8-bit ML dtypes: KDF-only extension — all engines sort the derived
    # 8-bit domain (a 256-value COUNTING domain). Oracle: derived-key order.
    from radix_sorting.ops import kdf
    raw = rng.integers(0, 256, size=30_000, dtype=np.uint8)
    x = jnp.asarray(raw).view(jnp.dtype(dtype))
    out = rst.sort(x)
    kx = np.asarray(kdf.encode(x)[0])
    ko = np.asarray(kdf.encode(out)[0])
    assert np.array_equal(np.sort(kx), ko)
    outd = rst.sort(x, config=rst.SortConfig(descending=True))
    kd = np.asarray(kdf.encode(outd)[0])
    assert np.array_equal(np.sort(kx)[::-1], kd)
    # argsort is the stable permutation of the derived order
    perm = np.asarray(rst.argsort(x))
    assert verify.is_permutation(perm)
    assert np.array_equal(kx[perm], np.sort(kx))


def test_bfloat16_takes_counting_path():
    # regression: ml_dtypes floats report numpy dtype kind 'V'; the static
    # live-mask check keyed on numpy kind, so bf16 never reached the counting
    # fast path (f16 did). The derived 16-bit domain must qualify.
    from radix_sorting import api
    from radix_sorting.config import SortConfig
    x = jnp.asarray(np.arange(64, dtype=np.uint16)).view(jnp.bfloat16)
    words, dt = api._as_words(x, False)
    assert api._static_live_mask(words, None, dt, SortConfig()) == (0xFFFF,)


def test_bfloat16_masked_negatives_correct(rng):
    # regression: the same numpy-kind miss skipped the float sign-bit guard,
    # returning a WRONG positional mask for masked bf16 admitting negatives
    # (the float KDF inverts all bits of negative keys, so liveness spreads
    # beyond the masked positions; the counting path then corrupted values)
    mask = 0xFF80  # sign bit live
    raw = (rng.integers(0, 1 << 16, size=20_000, dtype=np.uint16)
           & np.uint16(mask))
    x = jnp.asarray(raw).view(jnp.bfloat16)
    from radix_sorting import api
    from radix_sorting.config import SortConfig
    words, dt = api._as_words(x, False)
    assert api._static_live_mask(words, mask, dt, SortConfig()) is None
    out = rst.sort(x, value_mask=mask)
    from radix_sorting.ops import kdf
    kx = np.asarray(kdf.encode(x)[0])
    ko = np.asarray(kdf.encode(out)[0])
    assert np.array_equal(np.sort(kx), ko)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_degenerate_inputs(rng, strategy):
    cfg = rst.SortConfig(strategy=strategy)
    for x in [
        np.full(10_000, 0xDEADBEEF, np.uint32),            # constant
        np.arange(10_000, dtype=np.uint32),                # presorted
        np.arange(10_000, dtype=np.uint32)[::-1].copy(),   # reverse
        np.zeros(0, np.uint32),                            # empty
        np.array([42], np.uint32),                         # single
        np.array([2, 1], np.uint32),                       # minimal swap
    ]:
        out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
        assert np.array_equal(out, np.sort(x)), (strategy, x[:4])


def test_value_mask_counting_path(rng):
    # the CLI's skip-forcing hex-mask experiment (`radix_experiment.cpp:188-198`,
    # `README.md:888-891`): masked keys must take the COUNTING path and agree
    mask = 0xF0F00000
    x = (rng.integers(0, 1 << 32, size=100_000, dtype=np.uint32) & mask).astype(np.uint32)
    out = np.asarray(rst.sort(jnp.asarray(x), value_mask=mask))
    assert np.array_equal(out, np.sort(x))
    # explicit COUNTING succeeds; without enough live-bit budget it must raise
    out2 = np.asarray(
        rst.sort(jnp.asarray(x), config=rst.SortConfig(strategy=rst.Strategy.COUNTING),
                 value_mask=mask)
    )
    assert np.array_equal(out2, np.sort(x))
    with pytest.raises(ValueError):
        rst.sort(jnp.asarray(x), config=rst.SortConfig(strategy=rst.Strategy.COUNTING))


def test_value_mask_validation(rng):
    mask = 0x0000FF00
    good = (rng.integers(0, 1 << 32, size=1000, dtype=np.uint32) & mask).astype(np.uint32)
    out = np.asarray(rst.sort(jnp.asarray(good), value_mask=mask, validate_mask=True))
    assert np.array_equal(out, np.sort(good))
    bad = good.copy()
    bad[17] |= 0x10000
    with pytest.raises(ValueError, match="value_mask violated"):
        rst.sort(jnp.asarray(bad), value_mask=mask, validate_mask=True)


def test_value_mask_validation_u64(rng):
    # 64-bit keys (numpy path, no x64): validation must see both word planes
    mask = 0x00FF0000_0000FF00
    good = (rng.integers(0, 1 << 64, size=1000, dtype=np.uint64)
            & np.uint64(mask)).astype(np.uint64)
    out = np.asarray(rst.sort(good, value_mask=mask, validate_mask=True),
                     dtype=np.uint64)
    assert np.array_equal(out, np.sort(good))
    bad = good.copy()
    bad[3] |= np.uint64(1 << 40)  # stray bit in the HIGH word
    with pytest.raises(ValueError, match="value_mask violated"):
        rst.sort(bad, value_mask=mask, validate_mask=True)


def test_value_mask_counting_u64(rng):
    # 64-bit masked keys hit the counting path: live bits span BOTH planes
    mask = 0x0000_00F0_F000_0000
    x = (rng.integers(0, 1 << 64, size=60_000, dtype=np.uint64)
         & np.uint64(mask)).astype(np.uint64)
    out = np.asarray(
        rst.sort(x, value_mask=mask,
                 config=rst.SortConfig(strategy=rst.Strategy.COUNTING)),
        dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))
    # AUTO picks counting too and agrees
    out2 = np.asarray(rst.sort(x, value_mask=mask), dtype=np.uint64)
    assert np.array_equal(out2, np.sort(x))


def test_value_mask_counting_i64_descending(rng):
    mask = 0x8000_0000_0000_FF00  # sign bit live: positional for ints
    x = (rng.integers(0, 1 << 64, size=30_000, dtype=np.uint64)
         & np.uint64(mask)).view(np.int64)
    cfg = rst.SortConfig(descending=True)
    out = np.asarray(rst.sort(x, config=cfg, value_mask=mask), dtype=np.int64)
    assert np.array_equal(out, np.sort(x)[::-1])


def test_value_mask_f64_negative_mask_falls_back(rng):
    # f64 mask admitting negatives cannot keep a positional live mask:
    # explicit COUNTING must raise, AUTO must still sort correctly via HW
    mask = 0x8000_0000_0000_FF00
    x = (rng.integers(0, 1 << 64, size=10_000, dtype=np.uint64)
         & np.uint64(mask)).view(np.float64)
    with pytest.raises(ValueError):
        rst.sort(x, config=rst.SortConfig(strategy=rst.Strategy.COUNTING),
                 value_mask=mask)
    out = np.asarray(rst.sort(x, value_mask=mask), dtype=np.float64)
    # oracle in the KDF total order (-0.0 sorts strictly before +0.0, which
    # numpy's comparison sort does not guarantee bitwise)
    b = x.view(np.uint64)
    key = np.where(b >> np.uint64(63) == 1, ~b, b | np.uint64(1 << 63))
    oracle = x[np.argsort(key, kind="stable")]
    assert np.array_equal(out.view(np.uint64), oracle.view(np.uint64))


def test_dynamic_probe_counting(rng):
    # runtime column skip: no value_mask promise, the probe measures liveness
    cfg = rst.SortConfig(dynamic_probe=True)
    x = (rng.integers(0, 256, size=50_000, dtype=np.uint32) << 13).astype(np.uint32)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, np.sort(x))
    # floats with negatives: probe masks describe the DERIVED planes, so the
    # float positional caveat of value_mask does not apply
    f = np.where(rng.integers(0, 2, size=20_000) == 1, np.float32(-1.5),
                 np.float32(3.25)).astype(np.float32)
    out = np.asarray(rst.sort(jnp.asarray(f), config=cfg))
    assert np.array_equal(out, np.sort(f))
    # 64-bit keys: live bits across both planes
    x64 = ((rng.integers(0, 16, size=20_000, dtype=np.uint64) << 40)
           | rng.integers(0, 16, size=20_000, dtype=np.uint64)).astype(np.uint64)
    out = np.asarray(rst.sort(x64, config=cfg), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x64))
    # full-entropy data falls through to the hardware sorter, still correct
    y = rng.integers(0, 1 << 32, size=20_000, dtype=np.uint32)
    assert np.array_equal(np.asarray(rst.sort(jnp.asarray(y), config=cfg)),
                          np.sort(y))
    # under jit the probe is skipped (tracers), result unchanged
    import jax
    out = np.asarray(jax.jit(lambda a: rst.sort(a, config=cfg))(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))


def test_value_mask_descending(rng):
    mask = 0x0000FF00
    x = (rng.integers(0, 1 << 32, size=50_000, dtype=np.uint32) & mask).astype(np.uint32)
    cfg = rst.SortConfig(descending=True)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg, value_mask=mask))
    assert np.array_equal(out, np.sort(x)[::-1])


@pytest.mark.parametrize("radix_bits", [4, 8, 11])
def test_lsd_radix_widths(rng, radix_bits):
    # the 8/11-bit digit-width study (`README.md:781-811`) as a config knob
    x = rng.integers(0, 1 << 32, size=30_000, dtype=np.uint32)
    cfg = rst.SortConfig(strategy=rst.Strategy.LSD, radix_bits=radix_bits)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, np.sort(x))


def test_u64_sorts(rng):
    x = rng.integers(0, 1 << 64, size=30_000, dtype=np.uint64)
    out = rst.sort(x)
    assert np.array_equal(np.asarray(out, dtype=np.uint64), np.sort(x))
    out_mp = rst.sort_u64_multipass(x)
    assert np.array_equal(np.asarray(out_mp, dtype=np.uint64), np.sort(x))


def test_lsd_u64_two_word_keys(rng):
    # the LSD engine over two-word (64-bit) keys: 16 passes at 4-bit digits
    # exercises multi-word digit extraction and per-pass elision together
    x = rng.integers(0, 1 << 64, size=5_000, dtype=np.uint64)
    cfg = rst.SortConfig(strategy=rst.Strategy.LSD, radix_bits=4)
    out = np.asarray(rst.sort(x, config=cfg), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))


def test_i64_f64_sorts(rng):
    xi = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, size=20_000,
                      dtype=np.int64)
    assert np.array_equal(np.asarray(rst.sort(xi), dtype=np.int64), np.sort(xi))
    xf = rng.standard_normal(20_000).astype(np.float64)
    assert np.array_equal(np.asarray(rst.sort(xf), dtype=np.float64), np.sort(xf))


def test_counting_sort_u8(rng):
    x = rng.integers(0, 256, size=65_536, dtype=np.uint8)
    out = np.asarray(rst.counting_sort(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))


def test_counting_sort_16bit_dtypes(rng):
    # 16-bit domains exceed the regeneration budget (2^16 bins): the counting
    # engine must route them through the sorter fallback, not hang or OOM
    xu = rng.integers(0, 1 << 16, size=50_000, dtype=np.uint16)
    assert np.array_equal(np.asarray(rst.counting_sort(jnp.asarray(xu))), np.sort(xu))
    xi = rng.integers(-1 << 15, 1 << 15, size=50_000, dtype=np.int16)
    assert np.array_equal(np.asarray(rst.counting_sort(jnp.asarray(xi))), np.sort(xi))


def test_counting_sort_f16(rng):
    # 16-bit floats are a dense 16-bit derived domain (dtype-width live mask)
    x = rng.standard_normal(30_000).astype(np.float16)
    out = np.asarray(rst.counting_sort(jnp.asarray(x)))
    assert np.array_equal(out.view(np.uint16), np.sort(x).view(np.uint16))


def test_sort_f16_counting_strategy(rng):
    # explicit COUNTING strategy on a float16 key with a raised budget
    x = rng.standard_normal(20_000).astype(np.float16)
    cfg = rst.SortConfig(strategy=rst.Strategy.COUNTING, counting_max_bits=16,
                         detect_presorted=False)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out.view(np.uint16), np.sort(x).view(np.uint16))


def test_bool_keys(rng):
    # beyond-reference: bool keys; argsort(bool) is a stable partition
    x = rng.integers(0, 2, size=10_000).astype(bool)
    out = np.asarray(rst.sort(jnp.asarray(x)))
    assert out.dtype == np.bool_ and np.array_equal(out, np.sort(x))
    perm = np.asarray(rst.argsort(jnp.asarray(x)))
    assert np.array_equal(perm, np.argsort(x, kind="stable").astype(np.uint32))
    # descending: True first, stable
    cfg = rst.SortConfig(descending=True)
    perm = np.asarray(rst.argsort(jnp.asarray(x), config=cfg))
    oracle = np.argsort(~x, kind="stable")
    assert np.array_equal(perm, oracle.astype(np.uint32))
    # payload rides
    v = rng.integers(0, 1 << 32, size=10_000, dtype=np.uint32)
    sk, sv = rst.sort_pairs(jnp.asarray(x), jnp.asarray(v))
    order = np.argsort(x, kind="stable")
    assert np.array_equal(np.asarray(sv), v[order])


def test_numpy_u64_2d_rejected():
    # the numpy 64-bit _as_words branch must enforce 1-D like the jax branch
    x = np.arange(12, dtype=np.uint64).reshape(3, 4)
    with pytest.raises(ValueError, match="1-D"):
        rst.sort(x)
    with pytest.raises(ValueError, match="1-D"):
        rst.argsort(x)
    # batched entry points still accept N-D numpy u64
    out = np.asarray(rst.sort_batched(x), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x, axis=-1))


def test_sort_normalizes_tiny_list_inputs():
    # n<=1 early return must not leak a bare Python list back (review finding)
    out = rst.sort([5])
    assert hasattr(out, "dtype") and out.shape == (1,)
    out = rst.sort([])
    assert hasattr(out, "dtype") and out.shape == (0,)


def test_sort_lsd_masked_u64_compaction_route(rng):
    # sort()'s LSD branch applies plane compaction like sort_pairs' does
    mask = (0xFFF << 32) | 0xFF0
    x = rng.integers(0, 1 << 63, size=20_011, dtype=np.uint64) & np.uint64(mask)
    cfg = rst.SortConfig(strategy=rst.Strategy.LSD)
    out = np.asarray(rst.sort(x, config=cfg, value_mask=mask), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))


@pytest.mark.parametrize("dtype", ["int4", "uint4"])
def test_int4_sorts(rng, dtype):
    # sub-byte quantization dtypes: logical 4-bit width (kdf.key_bits),
    # 16-bin counting domain; storage is byte-backed in jnp
    d = jnp.dtype(dtype)
    lo = -8 if dtype == "int4" else 0
    x = jnp.asarray(rng.integers(lo, lo + 16, size=20_000,
                                 dtype=np.int8)).astype(d)
    xi = np.asarray(x.astype(jnp.int32))
    out = rst.sort(x)
    assert np.array_equal(np.asarray(out.astype(jnp.int32)), np.sort(xi))
    outd = rst.sort(x, config=rst.SortConfig(descending=True))
    assert np.array_equal(np.asarray(outd.astype(jnp.int32)), np.sort(xi)[::-1])
    perm = np.asarray(rst.argsort(x))
    assert np.array_equal(perm, np.argsort(xi, kind="stable"))
    # logical-width metadata + value_mask validation at 4 bits
    from radix_sorting.ops import kdf
    assert kdf.key_bits(d) == 4 and kdf.num_words(d) == 1
    with pytest.raises(ValueError):
        rst.sort(x, value_mask=0x3, validate_mask=True)
