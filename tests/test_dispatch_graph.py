"""The production dispatch graph: counting tier, range probe, dense tiers.

One graph runs on every backend — narrow and masked keys (one library sort
of ONE operand: 64-bit keys with <= 32 live bits are compacted into one
u32 word first), the in-graph ``lax.cond`` hi-plane probe
(``SortConfig.device_probe``) with both branches, and the dense
group-by / weighted-histogram scatter-adds — so the tested path is the
production path. The reference's analog is its always-on self-verification
(`radix_experiment.cpp:208-212`).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp


def test_counting_route_is_one_sort_for_u8_u16():
    # u8 and u16 keys under AUTO: no histogram (scatter) in the program,
    # one sort of the derived word
    import radix_sorting as rst
    for dt in (jnp.uint8, jnp.uint16):
        jaxpr = str(jax.make_jaxpr(rst.sort)(jnp.zeros((1000,), dt)))
        assert "scatter" not in jaxpr and jaxpr.count("sort[") == 1, dt


def test_plain_counting_tier_u8(rng):
    # u8 keys (256-value domain)
    import radix_sorting as rst
    x = rng.integers(0, 256, size=70_003, dtype=np.uint8)
    out = np.asarray(rst.sort(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))


def test_masked_u32_plain_pdep(rng):
    # 8 live bits under a value_mask promise
    import radix_sorting as rst
    mask = 0xF0F00000
    x = (rng.integers(0, 1 << 32, size=150_007, dtype=np.uint32)
         & np.uint32(mask))
    out = np.asarray(rst.sort(jnp.asarray(x), value_mask=mask))
    assert np.array_equal(out, np.sort(x))


def test_masked_u32_12bit_dead_bits(rng):
    # 12 live bits plus constant dead bits restored by PDEP
    import radix_sorting as rst
    mask = 0x3FFC0  # 12 contiguous live bits
    x = (rng.integers(0, 1 << 32, size=600_011, dtype=np.uint32)
         & np.uint32(mask)) | np.uint32(0x80000004 & ~mask)
    out = np.asarray(rst.sort(jnp.asarray(x), value_mask=mask | 0x80000004))
    assert np.array_equal(out, np.sort(x))


def test_counting_sparse_skewed(rng):
    # one element in each of ~1500 of 2048 values, the rest piled into one
    import radix_sorting as rst
    bins, n = 1 << 11, 400_009
    singles = np.arange(1500, dtype=np.uint32)
    x = np.concatenate([singles,
                        np.full(n - singles.size, 2000, np.uint32)])
    x = np.random.default_rng(7).permutation(x)
    cfg = rst.SortConfig(strategy=rst.Strategy.COUNTING)
    out = np.asarray(rst.sort(jnp.asarray(x), value_mask=bins - 1, config=cfg))
    assert np.array_equal(out, np.sort(x))


def test_masked_u64_two_plane(rng):
    # cross-plane mask (5 + 7 = 12 live bits): both planes compacted into one
    import radix_sorting as rst
    mask_hi, mask_lo = 0x1F, 0xFE000000  # 5 + 7 = 12 live bits
    full_mask = (mask_hi << 32) | mask_lo
    r = rng.integers(0, 1 << 62, size=600_013).astype(np.uint64)
    x = r & np.uint64(full_mask)
    out = np.asarray(rst.sort(x, value_mask=int(full_mask)))
    assert np.array_equal(out, np.sort(x))


@pytest.mark.parametrize("route", ["auto_mask", "counting_mask", "dynamic_probe",
                                   "auto_mask_desc"])
@pytest.mark.parametrize("detect_presorted", [False, True])
def test_masked_u64_sorts_one_operand(rng, monkeypatch, route,
                                      detect_presorted):
    # 64-bit keys with few live bits across both planes must reach the
    # library sort as ONE compacted operand, never as the two-key sort of
    # the raw planes (XLA's comparison kernel on a GPU)
    import radix_sorting as rst
    from radix_sorting.ops import hw_engine
    seen = []
    for name in ("sort_words", "sort_words_presort_guard"):
        real = getattr(hw_engine, name)
        monkeypatch.setattr(
            hw_engine, name,
            lambda ws, *a, _real=real, **k: seen.append(len(tuple(ws)))
            or _real(ws, *a, **k))
    mask = (0x0F0F << 32) | 0xF0F0_0000            # 8 + 8 = 16 live bits
    x = rng.integers(0, 1 << 64, size=50_021, dtype=np.uint64) & np.uint64(mask)
    cfg = rst.SortConfig(detect_presorted=detect_presorted)
    kw = {"value_mask": mask}
    if route == "counting_mask":
        cfg = cfg.replace(strategy=rst.Strategy.COUNTING)
    elif route == "dynamic_probe":
        cfg, kw = cfg.replace(dynamic_probe=True), {}
    elif route == "auto_mask_desc":
        cfg = cfg.replace(descending=True)
    out = np.asarray(rst.sort(x, config=cfg, **kw), dtype=np.uint64)
    want = np.sort(x)[::-1] if cfg.descending else np.sort(x)
    assert np.array_equal(out, want)
    assert seen and all(k == 1 for k in seen), seen


def test_u16_full_domain(rng):
    # u16 over the full domain (a 2^16-value COUNTING domain)
    import radix_sorting as rst
    x = rng.integers(0, 1 << 16, size=90_017, dtype=np.uint16)
    out = np.asarray(rst.sort(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))


def test_bitmap_presence_route(rng):
    from radix_sorting.ops.bitmap import bitmap_unique_sort
    x = rng.integers(0, 500, size=70_001, dtype=np.uint16)
    values, count = bitmap_unique_sort(x)
    expect = np.unique(x)
    assert int(count) == expect.size
    assert np.array_equal(np.asarray(values)[: expect.size], expect)


def test_lsd_engine_route(rng):
    # Strategy.LSD end-to-end (per-pass chunked histograms + stable scatter;
    # the fused multi_digit_histogram op is a standalone listing-parity op,
    # NOT on this path — see histogram.py)
    import radix_sorting as rst
    x = rng.integers(0, 1 << 32, size=70_009, dtype=np.uint32)
    cfg = rst.SortConfig(strategy=rst.Strategy.LSD)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, np.sort(x))


# ---------------------------------------------------------------------------
# in-graph probe: `SortConfig.device_probe` dispatches two-word keys on
# their hi plane with a lax.cond — no host sync. Both branches run here.


def test_device_probe_builds_cond(monkeypatch):
    # two-word keys: a cond between the one-operand and two-operand sorts;
    # one-word keys: no probe at all
    import radix_sorting as rst
    from radix_sorting.ops import hw_engine as ce
    jaxpr = str(jax.make_jaxpr(ce.sort_words2_range_probe)(
        jnp.zeros((1000,), jnp.uint32), jnp.zeros((1000,), jnp.uint32)))
    assert "cond[" in jaxpr and "num_keys=1" in jaxpr and "num_keys=2" in jaxpr
    calls = []
    real = ce.sort_words2_range_probe
    monkeypatch.setattr(ce, "sort_words2_range_probe",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = rst.SortConfig(device_probe=True)
    rst.sort(np.arange(1000, dtype=np.uint64), config=cfg)
    rst.sort(jnp.arange(1000, dtype=jnp.uint32), config=cfg)
    assert calls == [1]


def test_device_probe_narrow_offset_range(rng):
    # values in [3e9, 3e9 + 1500): narrow RANGE, huge values — only the
    # offset trick catches this (no static mask could)
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    n = 500_003
    x = (rng.integers(0, 1500, size=n).astype(np.uint64)
         + np.uint64(3_000_000_000)).astype(np.uint32)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, np.sort(x))
    # descending through the same probe (complemented word, range unchanged)
    outd = np.asarray(rst.sort(jnp.asarray(x),
                               config=cfg.replace(descending=True)))
    assert np.array_equal(outd, np.sort(x)[::-1])


def test_device_probe_wide_takes_sorter(rng):
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    x = rng.integers(0, 1 << 32, size=500_005, dtype=np.uint32)
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, np.sort(x))


def test_device_probe_narrow_signed_and_float(rng):
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    xi = rng.integers(-700, 700, size=500_007, dtype=np.int32)
    out = np.asarray(rst.sort(jnp.asarray(xi), config=cfg))
    assert np.array_equal(out, np.sort(xi))
    # f32 in a tight band: derived-word range is narrow too
    xf = (1.0 + rng.integers(0, 1000, size=500_009).astype(np.float32)
          * np.float32(2**-23))
    out = np.asarray(rst.sort(jnp.asarray(xf), config=cfg))
    assert np.array_equal(out, np.sort(xf))


def test_device_probe_u64_hi_const_narrow_lo(rng):
    # 64-bit keys inside one 2^32 span with a narrow lo range: the hi-plane
    # constancy probe sorts the lo plane alone — all in-graph
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    base = np.uint64(0x1234_5678_9000_0000)
    x = base + rng.integers(0, 2000, size=500_011).astype(np.uint64)
    out = np.asarray(rst.sort(x, config=cfg), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))
    outd = np.asarray(rst.sort(x, config=cfg.replace(descending=True)),
                      dtype=np.uint64)
    assert np.array_equal(outd, np.sort(x)[::-1])


def test_device_probe_u64_hi_const_wide_lo(rng):
    # constant hi plane, full-entropy lo: takes the ONE-operand sorter branch
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    base = np.uint64(7) << np.uint64(32)
    x = base + rng.integers(0, 1 << 32, size=300_003).astype(np.uint64)
    out = np.asarray(rst.sort(x, config=cfg), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))


def test_device_probe_defers_to_static_compaction(rng, monkeypatch):
    # A 64-bit value_mask with <= 32 live bits is a STATIC promise of the
    # one-operand compacted sorter route; device_probe must
    # not pre-empt it with the runtime range probe. Regression for the
    # round-3 review finding: poison the probe entry points and assert the
    # masked sort still succeeds (i.e. took the compaction route).
    import radix_sorting as rst
    from radix_sorting.ops import hw_engine as ce

    def boom(*a, **k):
        raise AssertionError("range probe must not pre-empt static compaction")

    monkeypatch.setattr(ce, "sort_words2_range_probe", boom)
    cfg = rst.SortConfig(device_probe=True)
    mask = (0xFFF << 32) | 0xFFF0_0000          # 24 live bits across planes
    x = rng.integers(0, 1 << 63, size=100_003, dtype=np.uint64) & np.uint64(mask)
    out = np.asarray(rst.sort(x, config=cfg, value_mask=mask), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))


def test_device_probe_u64_varying_hi_takes_full_sorter(rng):
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    x = rng.integers(0, 1 << 63, size=300_005, dtype=np.uint64)
    out = np.asarray(rst.sort(x, config=cfg), dtype=np.uint64)
    assert np.array_equal(out, np.sort(x))
    # i64 through the sign-flip KDF: one negative key breaks hi constancy
    xi = x.astype(np.int64)
    out = np.asarray(rst.sort(xi, config=cfg), dtype=np.int64)
    assert np.array_equal(out, np.sort(xi))


def test_device_probe_f64_band(rng):
    # f64 values in a tight positive band: mangled hi plane is constant,
    # lo plane narrow -> the one-operand branch end to end
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    x = 1.0 + rng.integers(0, 1500, size=500_009).astype(np.float64) * 2.0**-52
    out = np.asarray(rst.sort(x, config=cfg), dtype=np.float64)
    assert np.array_equal(out, np.sort(x))


def test_device_probe_skewed_narrow():
    # narrow range, mass piled into one value: still exact
    import radix_sorting as rst
    cfg = rst.SortConfig(device_probe=True)
    n = 400_011
    bins = 1 << 16
    singles = np.arange(0, bins - 64, max(1, (bins - 64) // 1500),
                        dtype=np.uint32)[:1500]
    x = np.concatenate([singles,
                        np.full(n - singles.size, bins - 1, np.uint32)])
    x = np.random.default_rng(13).permutation(x)
    assert int(x.max()) - int(x.min()) < bins
    out = np.asarray(rst.sort(jnp.asarray(x), config=cfg))
    assert np.array_equal(out, np.sort(x))


def test_group_reduce_dense_tier_scatter(rng):
    # the dense group-by tier (scatter-add counts + u32 sums) vs the
    # sort-native route
    from radix_sorting.extras import group_reduce
    n, G = 40_000, 1 << 10
    k = rng.integers(0, G, size=n, dtype=np.uint32)
    k[::500] = G + 3  # out of range: dropped, not aliased
    v = rng.integers(-(1 << 30), 1 << 30, size=n, dtype=np.int32)
    uk_d, rv_d, ng_d = group_reduce(k, v, reduce="sum", groups=G)
    ok = k < G
    uk_s, rv_s, ng_s = group_reduce(k[ok], v[ok], reduce="sum",
                                    size=int(ng_d))
    m = int(ng_d)
    assert int(ng_s) == m
    assert np.array_equal(np.asarray(uk_d)[:m], np.asarray(uk_s)[:m])
    assert np.array_equal(np.asarray(rv_d)[:m], np.asarray(rv_s)[:m])


def test_group_reduce_dense_signed_bias(rng):
    # signed narrow values: the +2^(bits-1) bias / count*bias correction
    from radix_sorting.extras import group_reduce
    n, G = 20_000, 32
    k = rng.integers(0, G, size=n, dtype=np.int32)
    v = rng.integers(-128, 128, size=n, dtype=np.int8)
    uk, rv, ng = group_reduce(k, v, reduce="sum", groups=G)
    ref = np.zeros(G, np.int64)
    np.add.at(ref, k, v.astype(np.int64))
    ids = np.asarray(uk)[: int(ng)]
    assert np.array_equal(np.asarray(rv)[: int(ng)], ref[ids].astype(np.int32))


def test_group_reduce_dense_f32(rng):
    # FLOAT dense tier: scatter-add f32 sums vs a float64 oracle within
    # |err| <= count_g * 2^-23 * max|v| per group (the adds run in no fixed
    # order on a GPU, so only a bound is exact)
    from radix_sorting.extras import group_reduce
    n, G = 40_000, 1 << 10
    k = rng.integers(0, G, size=n, dtype=np.uint32)
    k[::500] = G + 3  # out of range: dropped, not aliased
    v = (rng.standard_normal(n) * 100).astype(np.float32)
    live = k < G
    ref = np.zeros(G, np.float64)
    np.add.at(ref, k[live], v[live].astype(np.float64))
    vmax = np.zeros(G, np.float64)
    np.maximum.at(vmax, k[live], np.abs(v[live]).astype(np.float64))
    cnt = np.bincount(k[live], minlength=G)

    uk, rv, ng = group_reduce(k, jnp.asarray(v), reduce="sum", groups=G)
    assert rv.dtype == jnp.float32
    m = int(ng)
    assert m == int((cnt > 0).sum())
    ids = np.asarray(uk)[:m]
    got = np.asarray(rv)[:m].astype(np.float64)
    assert np.all(np.abs(got - ref[ids]) <= cnt[ids] * 2.0**-23 * vmax[ids])
    # the sort-native cumsum-difference route, against its own looser bound
    absv = np.zeros(G, np.float64)
    np.add.at(absv, k[live], np.abs(v[live]).astype(np.float64))
    uk_s, rv_s, ng_s = group_reduce(k[live], v[live], reduce="sum", size=m)
    assert int(ng_s) == m
    assert np.array_equal(np.asarray(uk_s)[:m], ids)
    assert np.all(np.abs(np.asarray(rv_s)[:m].astype(np.float64) - ref[ids])
                  <= absv[ids] * 2**-10 + np.abs(ref).sum() * 2**-20 + 1e-5)

    uk2, rm, ng2 = group_reduce(k, jnp.asarray(v), reduce="mean", groups=G)
    want_mean = ref[ids] / np.maximum(cnt[ids], 1)
    assert np.allclose(np.asarray(rm)[: int(ng2)], want_mean,
                       rtol=1e-3, atol=1e-4)
    # f16 values ride the same tier through one exact cast
    vh = np.round(v[:n]).astype(np.float16)
    uk3, rv3, ng3 = group_reduce(k, jnp.asarray(vh), reduce="sum", groups=G)
    ref16 = np.zeros(G, np.float64)
    np.add.at(ref16, k[live], vh[live].astype(np.float64))
    vmax16 = np.zeros(G, np.float64)
    np.maximum.at(vmax16, k[live], np.abs(vh[live]).astype(np.float64))
    got3 = np.asarray(rv3)[: int(ng3)].astype(np.float64)
    assert np.all(np.abs(got3 - ref16[ids])
                  <= cnt[ids] * 2.0**-23 * vmax16[ids])


def test_histogram_weighted_route(rng):
    # f32-weighted histogram: one f32 scatter-add per bin
    from radix_sorting.stats import histogram
    x = rng.standard_normal(60_000).astype(np.float32)
    w = rng.standard_normal(60_000).astype(np.float32)
    c, edges = histogram(jnp.asarray(x), bins=12, range=(-2, 2),
                         weights=jnp.asarray(w))
    ce, _ = np.histogram(x, bins=12, range=(-2, 2),
                         weights=w.astype(np.float64))
    assert np.allclose(np.asarray(c), ce, rtol=2e-4, atol=2e-3)
    # edge-array bins (non-uniform) take the same scatter-add
    eb = np.array([-2.0, -0.5, 0.0, 0.25, 1.0, 2.0])
    c2, _ = histogram(jnp.asarray(x), bins=eb, weights=jnp.asarray(w))
    ce2, _ = np.histogram(x, bins=eb, weights=w.astype(np.float64))
    assert np.allclose(np.asarray(c2), ce2, rtol=2e-4, atol=2e-3)
