"""Record sorting, stability, and rank-sort tests.

Mirrors the reference fixtures: the 8-record duplicate-key table whose labels
make stability observable (`radix_tests.cpp:20-29`), the pointer-array
reverse sort (`:121-146`), and the rank sort with permutation-validity check
(`:71-105`).
"""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.models import (
    RankSorter,
    RecordCountingSorter,
    StableCountingSorter8,
)
from radix_sorting.utils import verify

# the `radix_tests.cpp:20-29` fixture: duplicate key 45 labeled 1st/2nd/3rd
KEYS = np.array([255, 45, 0, 45, 255, 45, 1, 255], dtype=np.uint8)
NAMES = np.array([0, 1, 2, 3, 4, 5, 6, 7], dtype=np.uint32)  # label by input slot
# stable expectation: key order 0,1,45,45,45,255,255,255 with 45s in slots 1,3,5
EXPECT_KEYS = np.array([0, 1, 45, 45, 45, 255, 255, 255], dtype=np.uint8)
EXPECT_SLOTS = np.array([2, 6, 1, 3, 5, 0, 4, 7], dtype=np.uint32)

STRATEGIES = [rst.Strategy.AUTO, rst.Strategy.HW_SORT, rst.Strategy.LSD]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sortrec_stability(strategy):
    cfg = rst.SortConfig(strategy=strategy)
    sk, sv = rst.sort_pairs(jnp.asarray(KEYS), jnp.asarray(NAMES), config=cfg)
    assert np.array_equal(np.asarray(sk), EXPECT_KEYS)
    assert np.array_equal(np.asarray(sv), EXPECT_SLOTS)


def test_record_counting_sorter_pytree():
    # `counting_sort_rec_sk.c`: records with key extraction; payload is a pytree
    records = {
        "key": jnp.asarray(KEYS),
        "name": jnp.asarray(NAMES),
        "aux": jnp.asarray(NAMES.astype(np.float32) * 1.5),
    }
    out = RecordCountingSorter()(records, key_of=lambda r: r["key"])
    assert np.array_equal(np.asarray(out["name"]), EXPECT_SLOTS)
    assert np.array_equal(np.asarray(out["key"]), EXPECT_KEYS)


def test_stable_counting_sorter8():
    sk, sv = StableCountingSorter8()(jnp.asarray(KEYS), jnp.asarray(NAMES))
    assert np.array_equal(np.asarray(sk), EXPECT_KEYS)
    assert np.array_equal(np.asarray(sv), EXPECT_SLOTS)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sortrec_descending(strategy):
    # the pointer-array reverse sort (`radix_tests.cpp:121-146`) uses ~key;
    # stable descending keeps equal-key input order
    cfg = rst.SortConfig(strategy=strategy, descending=True)
    sk, sv = rst.sort_pairs(jnp.asarray(KEYS), jnp.asarray(NAMES), config=cfg)
    assert np.array_equal(np.asarray(sk), np.array([255, 255, 255, 45, 45, 45, 1, 0], np.uint8))
    assert np.array_equal(np.asarray(sv), np.array([0, 4, 7, 1, 3, 5, 6, 2], np.uint32))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "uint8"])
def test_rank_sort(rng, strategy, dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        x = rng.standard_normal(10_000).astype(d)
    else:
        info = np.iinfo(d)
        x = rng.integers(info.min, int(info.max) + 1, size=10_000, dtype=d)
    cfg = rst.SortConfig(strategy=strategy)
    perm = np.asarray(rst.rank_sort(jnp.asarray(x), config=cfg))
    assert verify.is_permutation(perm)
    assert verify.rank_is_stable_sort(x, perm)
    assert np.array_equal(perm, np.argsort(x, kind="stable").astype(np.uint32))


def test_rank_sort_input_unmodified():
    x = jnp.asarray(KEYS)
    before = np.asarray(x).copy()
    _ = rst.rank_sort(x)
    assert np.array_equal(np.asarray(x), before)


def test_rank_sorter_fixture():
    perm = np.asarray(RankSorter()(jnp.asarray(KEYS)))
    assert np.array_equal(perm, EXPECT_SLOTS)


def test_rank_permutation_rejects_bad():
    assert not verify.is_permutation(np.array([0, 1, 1, 3], np.uint32))
    assert not verify.is_permutation(np.array([0, 1, 2, 4], np.uint32))
    assert verify.is_permutation(np.array([3, 0, 2, 1], np.uint32))


# ---------------------------------------------------------------------------
# plane compaction for masked 64-bit keys (round 3): pairs/rank sorts ship
# ONE compacted key operand instead of two planes when a static value_mask
# leaves <= 32 live bits — the sorter is operand-width-bound, so this is a
# measured win; these tests pin the route's exactness and stability.


def _masked_u64(rng_, n, full_mask, dead=0):
    r = rng_.integers(0, 1 << 62, size=n).astype(np.uint64)
    return (r & np.uint64(full_mask)) | np.uint64(dead)


def test_pairs_compacted_masked_u64_stability(rng):
    # few distinct keys -> heavy duplication makes stability observable
    full_mask = (0xFF << 32) | 0x0000F000  # 8 + 4 = 12 live bits, both planes
    dead = (1 << 40) | 0x21               # constant bits outside the mask
    n = 4003
    keys = _masked_u64(rng, n, full_mask, dead)
    payload = np.arange(n, dtype=np.uint32)
    sk, sv = rst.sort_pairs(keys, payload, value_mask=full_mask | dead)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(np.asarray(sk), keys[order])
    assert np.array_equal(np.asarray(sv), payload[order])
    # descending: complemented planes, same masks
    cfg = rst.SortConfig(descending=True)
    sk, sv = rst.sort_pairs(keys, payload, config=cfg,
                            value_mask=full_mask | dead)
    order_d = np.argsort(~keys, kind="stable")
    assert np.array_equal(np.asarray(sk), keys[order_d])
    assert np.array_equal(np.asarray(sv), payload[order_d])


def test_argsort_compacted_masked_u64(rng):
    full_mask = (0x1F << 32) | 0xFE000000  # 5 + 7 live bits
    n = 3001
    keys = _masked_u64(rng, n, full_mask)
    perm = rst.argsort(keys, value_mask=full_mask)
    assert np.array_equal(np.asarray(perm), np.argsort(keys, kind="stable"))


def test_keys_only_compacted_masked_u64_wide():
    # 24 live bits: past the counting budget (16) but within the 32-bit
    # compaction budget -> HW path with ONE merged operand
    rng_ = np.random.default_rng(11)
    full_mask = (0xFFF << 32) | 0xFFF00000  # 12 + 12 = 24 live bits
    keys = _masked_u64(rng_, 5000, full_mask)
    out = rst.sort(keys, value_mask=full_mask)
    assert np.array_equal(np.asarray(out), np.sort(keys))


def test_pairs_masked_f64_nonnegative(rng):
    # all-non-negative masked f64: positional masks survive the float KDF
    bits = (rng.integers(0, 1 << 20, size=2000, dtype=np.uint64)
            << np.uint64(30))
    keys = bits.view(np.float64)
    mask = int(((1 << 20) - 1) << 30)
    payload = np.arange(keys.size, dtype=np.uint32)
    sk, sv = rst.sort_pairs(keys, payload, value_mask=mask)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(np.asarray(sk), keys[order])
    assert np.array_equal(np.asarray(sv), payload[order])


def test_pairs_value_mask_validation(rng):
    full_mask = (0xFF << 32) | 0xF000
    keys = _masked_u64(rng, 1000, full_mask) | np.uint64(1)  # stray bit 0
    with pytest.raises(ValueError, match="value_mask violated"):
        rst.sort_pairs(keys, np.arange(1000, dtype=np.uint32),
                       value_mask=full_mask, validate_mask=True)
    with pytest.raises(ValueError, match="value_mask violated"):
        rst.argsort(keys, value_mask=full_mask, validate_mask=True)


def test_pairs_compaction_lsd_route(rng):
    # compaction composes with the LSD engine too (fewer words -> fewer passes)
    full_mask = (0xF << 32) | 0xFF
    keys = _masked_u64(rng, 2000, full_mask)
    payload = np.arange(2000, dtype=np.uint32)
    cfg = rst.SortConfig(strategy=rst.Strategy.LSD)
    sk, sv = rst.sort_pairs(keys, payload, config=cfg, value_mask=full_mask)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(np.asarray(sk), keys[order])
    assert np.array_equal(np.asarray(sv), payload[order])


# ---------------------------------------------------------------------------
# round-3 review regressions


def test_pairs_numpy64_payload_bit_exact(rng):
    # 64-bit NUMPY payload leaves without x64 must survive bit-exactly (a
    # plain jnp.asarray silently truncated int64 -> int32 / float64 ->
    # float32 — review finding); they ride as raw (hi, lo) u32 planes
    n = 4_001
    keys = rng.integers(0, 50, size=n, dtype=np.uint32)
    p64 = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) | np.uint64(1 << 40)
    pf64 = rng.standard_normal(n)                      # float64
    sk, sv = rst.sort_pairs(jnp.asarray(keys), {"u": p64, "f": pf64})
    order = np.argsort(keys, kind="stable")
    assert sv["u"].dtype == np.uint64
    assert np.array_equal(sv["u"], p64[order])
    assert sv["f"].dtype == np.float64
    assert np.array_equal(sv["f"].view(np.uint64), pf64[order].view(np.uint64))


def test_pairs_batched_numpy64_payload_bit_exact(rng):
    n, rows = 513, 4
    keys = rng.integers(0, 9, size=(rows, n), dtype=np.uint32)
    p64 = rng.integers(0, 1 << 63, size=(rows, n), dtype=np.int64)
    sk, sv = rst.sort_pairs_batched(jnp.asarray(keys), {"p": p64})
    for r in range(rows):
        order = np.argsort(keys[r], kind="stable")
        assert np.array_equal(np.asarray(sv["p"][r], dtype=np.int64),
                              p64[r][order])


def test_counting_strategy_rejected_for_rank_and_pairs(rng):
    x = rng.integers(0, 256, size=1000, dtype=np.uint32)
    cfg = rst.SortConfig(strategy=rst.Strategy.COUNTING)
    with pytest.raises(ValueError, match="keys-only"):
        rst.argsort(jnp.asarray(x), config=cfg, value_mask=0xFF)
    with pytest.raises(ValueError, match="keys-only"):
        rst.sort_pairs(jnp.asarray(x), jnp.asarray(x), config=cfg,
                       value_mask=0xFF)
    # counting_sort's payload form IS counting-with-payload: must not raise
    k8 = x.astype(np.uint8)
    sk, sv = rst.counting_sort(jnp.asarray(k8), jnp.asarray(x), config=cfg)
    order = np.argsort(k8, kind="stable")
    assert np.array_equal(np.asarray(sv), x[order])


# ---------------------------------------------------------------------------
# fixed-width byte-string payload fields (the reference record demo carries a
# short char name per key — `README.md:252`; packed u32 operand planes
# instead of pointer gathers)


def test_pairs_bytes_payload_numpy_strings(rng):
    n = 4_000
    keys = rng.integers(0, 50, size=n, dtype=np.uint32)  # duplicate-heavy
    names = np.array([f"id{i:06d}".encode() for i in range(n)], dtype="S8")
    order = np.argsort(keys, kind="stable")
    for cfg in (rst.SortConfig(), rst.SortConfig(strategy=rst.Strategy.LSD),
                rst.SortConfig(descending=True)):
        o = order if not cfg.descending else np.argsort(
            np.iinfo(np.uint32).max - keys, kind="stable")
        sk, sv = rst.sort_pairs(jnp.asarray(keys), {"name": names}, config=cfg)
        assert sv["name"].dtype == names.dtype
        assert np.array_equal(sv["name"], names[o])
        assert np.array_equal(np.asarray(sk), keys[o])


def test_pairs_bytes_payload_device_matrices(rng):
    n = 2_000
    keys = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
    w = 7  # not a multiple of the 4-byte plane packing
    mat = rng.integers(0, 256, size=(n, w), dtype=np.uint8)
    m8 = (mat.astype(np.int32) - 128).astype(np.int8)
    order = np.argsort(keys, kind="stable")
    sk, sv = rst.sort_pairs(jnp.asarray(keys),
                            {"u": jnp.asarray(mat), "i": jnp.asarray(m8)})
    assert sv["u"].dtype == jnp.uint8 and sv["u"].shape == (n, w)
    assert np.array_equal(np.asarray(sv["u"]), mat[order])
    assert sv["i"].dtype == jnp.int8
    assert np.array_equal(np.asarray(sv["i"]), m8[order])


def test_pairs_bytes_payload_void_and_mixed(rng):
    n = 1_000
    keys = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    rec = np.frombuffer(rng.integers(0, 256, size=3 * n, dtype=np.uint8)
                        .tobytes(), dtype="V3")
    p64 = rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    sk, sv = rst.sort_pairs(keys, {"rec": rec, "v": p64})
    assert np.array_equal(sv["rec"].view("V3").reshape(-1), rec[order])
    assert np.array_equal(sv["v"], p64[order])
    # masked-key compaction route carries byte fields identically
    km = keys & np.uint64(0xFFFF0000)
    om = np.argsort(km, kind="stable")
    _, svm = rst.sort_pairs(km, {"rec": rec},
                            value_mask=0xFFFF0000, validate_mask=True)
    assert np.array_equal(svm["rec"].view("V3").reshape(-1), rec[om])


def test_pairs_bytes_payload_errors(rng):
    keys = jnp.asarray(np.arange(8, dtype=np.uint32))
    with pytest.raises(ValueError, match="width must be > 0"):
        rst.sort_pairs(keys, jnp.zeros((8, 0), jnp.uint8))
    with pytest.raises(ValueError, match="payload leaves"):
        rst.sort_pairs(keys, jnp.zeros((8, 3), jnp.uint16))  # only u8/i8 2-D
    with pytest.raises(ValueError, match="lengths differ"):
        rst.sort_pairs(keys, np.array([b"ab"] * 7, dtype="S2"))
    with pytest.raises(ValueError, match="> 256"):
        rst.sort_pairs(keys, jnp.zeros((8, 300), jnp.uint8))
    with pytest.raises(ValueError, match="> 256"):
        rst.sort_pairs(keys, np.zeros(8, dtype="V300"))
