"""Model-zoo tests: one configured sorter per reference listing (SURVEY §2).

Each zoo entry must reproduce its listing's observable contract; oracles are
numpy stable sorts. Also covers the keyfile/timing/scan utility surface.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst
from radix_sorting.models import (
    BitmapSorter16,
    CountingSorter8,
    GenericRadixSorter,
    MultipassSorterU64,
    RadixSorterU32,
    RankSorter,
    RecordCountingSorter,
    StableCountingSorter8,
)


def test_counting_sorter_8(rng):
    x = rng.integers(0, 256, size=10_000, dtype=np.uint8)
    out = np.asarray(CountingSorter8()(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))
    with pytest.raises(TypeError):
        CountingSorter8()(jnp.asarray(x).astype(jnp.uint16))


def test_stable_counting_sorter_8(rng):
    k = rng.integers(0, 8, size=5_000, dtype=np.uint8)
    v = rng.integers(0, 1 << 32, size=5_000, dtype=np.uint32)
    sk, sv = StableCountingSorter8()(jnp.asarray(k), jnp.asarray(v))
    order = np.argsort(k, kind="stable")
    assert np.array_equal(np.asarray(sk), k[order])
    assert np.array_equal(np.asarray(sv), v[order])


def test_record_counting_sorter(rng):
    # the `counting_sort_rec_sk.c` shape: records with a key_of extractor
    records = {
        "key": jnp.asarray(rng.integers(0, 45, size=3_000, dtype=np.uint8)),
        "name": jnp.asarray(rng.integers(0, 1 << 32, size=3_000, dtype=np.uint32)),
    }
    sorted_records = RecordCountingSorter()(records, key_of=lambda r: r["key"])
    k = np.asarray(records["key"])
    order = np.argsort(k, kind="stable")
    assert np.array_equal(np.asarray(sorted_records["key"]), k[order])
    assert np.array_equal(np.asarray(sorted_records["name"]),
                          np.asarray(records["name"])[order])


def test_radix_sorter_u32(rng):
    x = rng.integers(0, 1 << 32, size=50_000, dtype=np.uint32)
    out = np.asarray(RadixSorterU32()(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))
    # with the skip-forcing mask
    xm = (x & np.uint32(0xFF000000)).astype(np.uint32)
    out = np.asarray(RadixSorterU32()(jnp.asarray(xm), value_mask=0xFF000000))
    assert np.array_equal(out, np.sort(xm))


def test_multipass_sorter_u64(rng):
    x = rng.integers(0, 1 << 64, size=10_000, dtype=np.uint64)
    out = np.asarray(MultipassSorterU64()(x), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))


def test_rank_sorter(rng):
    x = rng.integers(0, 100, size=20_000, dtype=np.uint32)
    perm = np.asarray(RankSorter()(jnp.asarray(x)))
    assert np.array_equal(perm, np.argsort(x, kind="stable").astype(np.uint32))


def test_bitmap_sorter_16(rng):
    x = rng.integers(0, 1 << 16, size=30_000, dtype=np.uint16)
    values, count = BitmapSorter16()(jnp.asarray(x))
    uq = np.unique(x)
    assert int(count) == len(uq)
    assert np.array_equal(np.asarray(values)[: len(uq)], uq)
    # descending config must not be silently ignored (review finding)
    values, count = BitmapSorter16(rst.SortConfig(descending=True))(
        jnp.asarray(x))
    assert int(count) == len(uq)
    assert np.array_equal(np.asarray(values)[: len(uq)], uq[::-1])


def test_generic_radix_sorter(rng):
    g = GenericRadixSorter()
    xf = rng.standard_normal(10_000).astype(np.float32)
    assert np.array_equal(np.asarray(g(jnp.asarray(xf))), np.sort(xf))
    k = rng.integers(-50, 50, size=5_000, dtype=np.int32)
    v = rng.integers(0, 1 << 32, size=5_000, dtype=np.uint32)
    sk, sv = g(jnp.asarray(k), jnp.asarray(v))
    order = np.argsort(k, kind="stable")
    assert np.array_equal(np.asarray(sv), v[order])


def test_generic_sorter_descending_config(rng):
    g = GenericRadixSorter(config=rst.SortConfig(descending=True))
    x = rng.integers(0, 1000, size=5_000, dtype=np.uint32)
    assert np.array_equal(np.asarray(g(jnp.asarray(x))), np.sort(x)[::-1])


# ---------------------------------------------------------------------------
# utility surface


def test_keyfile_roundtrip(tmp_path, rng):
    from radix_sorting.utils import keyfile
    keys = keyfile.generate_keys(1000, seed=7)
    p = tmp_path / "keys.dat"
    keyfile.write_keyfile(p, keys)
    back = keyfile.read_keyfile(p, 1000)
    assert np.array_equal(back, keys)
    assert keyfile.read_keyfile(p, 10_000).shape[0] == 1000  # clipped to file
    assert keyfile.DEFAULT_COUNT == 40_000_000
    assert keyfile.default_keyfile().name == "40M_32bit_keys.dat"


def test_keyfile_grows_to_request(tmp_path, monkeypatch):
    # A request past the default 40M words must GROW the file (CLI reading
    # 40M u64 = 80M words; 160M wide-tier runs), and growth must keep the
    # existing prefix bit-identical (PCG64 draws are prefix-stable), so
    # parity/bench artifacts derived from the first 40M words are unchanged.
    from radix_sorting.utils import keyfile
    monkeypatch.setattr(keyfile, "DEFAULT_COUNT", 1_000)
    p = tmp_path / "grow.dat"
    small = keyfile.load_or_create(500, path=p)
    assert p.stat().st_size == 1_000 * 4 and small.shape[0] == 500
    big = keyfile.load_or_create(3_000, path=p)
    assert p.stat().st_size == 3_000 * 4 and big.shape[0] == 3_000
    assert np.array_equal(big[:500], small)   # prefix preserved across growth


def test_steady_state_ms_smoke():
    from radix_sorting.utils import timing
    x = jnp.arange(4096, dtype=jnp.uint32)
    ms = timing.steady_state_ms(lambda a: rst.sort(a), x, reps=2)
    assert ms > 0
    c = timing.counters(4096, ms)
    assert c["KeyRate"] > 0 and c["bytes_per_second"] == c["KeyRate"] * 4


def test_steady_chain_ms_smoke(rng):
    # the canonical scramble-chain harness: plain, aux-operand, and u16 forms
    from jax import lax
    from radix_sorting.utils import timing
    x = jnp.asarray(rng.integers(0, 1 << 32, 4096, dtype=np.uint32))
    assert timing.steady_chain_ms(lambda c: lax.sort(c), x, reps=2) > 0
    hi = jnp.zeros_like(x)
    ms = timing.steady_chain_ms(lambda c, h: lax.sort((h, c), num_keys=2)[1],
                                x, reps=2, aux=hi)
    assert ms > 0
    x16 = jnp.asarray(rng.integers(0, 1 << 16, 4096, dtype=np.uint16))
    assert timing.steady_chain_ms(lambda c: lax.sort(c), x16, reps=2) > 0


def test_scan_helpers(rng):
    from radix_sorting.ops.scan import exclusive_scan, scatter_bases
    from radix_sorting.ops.histogram import chunked_digit_histogram
    h = jnp.asarray(rng.integers(0, 10, size=(4, 8)).astype(np.int32))
    ex = np.asarray(exclusive_scan(h, axis=-1))
    assert np.array_equal(ex, np.cumsum(np.asarray(h), -1) - np.asarray(h))
    # scatter bases: disjoint, order-complete covering of [0, total)
    bases = np.asarray(scatter_bases(h))
    hn = np.asarray(h)
    slots = []
    for b in range(8):
        for c in range(4):
            slots.extend(range(bases[c, b], bases[c, b] + hn[c, b]))
    assert sorted(slots) == list(range(hn.sum()))
    # chunked histogram agrees with bincount per chunk
    d = rng.integers(0, 8, size=64, dtype=np.uint32)
    ch = np.asarray(chunked_digit_histogram(jnp.asarray(d), 8, 4))
    for c in range(4):
        assert np.array_equal(ch[c], np.bincount(d[c * 16:(c + 1) * 16], minlength=8))


def test_trace_smoke(tmp_path):
    # the tracing subsystem (SURVEY §5 row 1): one traced block produces a
    # profile artifact
    from radix_sorting.utils import timing
    with timing.trace(str(tmp_path)) as logdir:
        np.asarray(rst.sort(jnp.arange(1024, dtype=jnp.uint32)))
    import pathlib
    assert any(pathlib.Path(logdir).rglob("*")), "no profile artifacts written"
