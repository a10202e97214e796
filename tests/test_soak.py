"""Randomized soak: every public op against oracles over many seeds.

Gated behind ``RST_SOAK=1`` (slow by design — run it before releases or on
hardware changes): ``RST_SOAK=1 pytest tests/test_soak.py``.
The regular suites cover the same surfaces with fixed seeds; this sweeps the
input space wider.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp

import radix_sorting as rst

pytestmark = pytest.mark.skipif(os.environ.get("RST_SOAK") != "1",
                                reason="set RST_SOAK=1 to run the soak suite")

_DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
           np.int32, np.int64, np.float16, np.float32, np.float64,
           jnp.bfloat16, jnp.float8_e4m3fn, jnp.float8_e5m2]


def _gen(r, dtype, n):
    from oracles import is_float_dtype
    if is_float_dtype(dtype):
        raw = r.integers(0, 1 << (8 * np.dtype(dtype).itemsize), size=n,
                         dtype=np.dtype(f"u{np.dtype(dtype).itemsize}"))
        x = raw.view(np.dtype(dtype))
        return x  # numpy: jnp.asarray would downcast 64-bit without x64
    info = np.iinfo(dtype)
    return r.integers(info.min, info.max, size=n, dtype=dtype, endpoint=True)


from oracles import kdf_key as _key  # shared KDF total-order oracle


@pytest.mark.parametrize("seed", range(50))
def test_soak_sort_and_rank(seed):
    r = np.random.Generator(np.random.PCG64(seed))
    dtype = _DTYPES[seed % len(_DTYPES)]
    n = int(r.integers(2, 100_000))
    x = _gen(r, dtype, n)
    descending = bool(seed % 2)
    cfg = rst.SortConfig(descending=descending,
                         dynamic_probe=bool(seed % 3 == 0))
    k = _key(x)
    order = np.argsort(np.where(descending, ~k, k), kind="stable")
    oracle = x[order]

    out = np.asarray(rst.sort(x if np.dtype(dtype).itemsize == 8 else jnp.asarray(x),
                              config=cfg), dtype=dtype)
    assert np.array_equal(out.view(f"u{x.dtype.itemsize}"),
                          oracle.view(f"u{x.dtype.itemsize}")), (seed, dtype, n)

    perm = np.asarray(rst.argsort(x if np.dtype(dtype).itemsize == 8 else jnp.asarray(x),
                                  config=cfg))
    assert np.array_equal(perm, order.astype(np.uint32)), (seed, dtype, n)


@pytest.mark.parametrize("seed", range(20))
def test_soak_distributed(seed):
    import jax
    from radix_sorting.parallel import (distributed_sort_balanced,
                                            gather_sorted, make_sort_mesh)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh")
    r = np.random.Generator(np.random.PCG64(1000 + seed))
    mesh = make_sort_mesh(int(r.integers(2, 9)))
    n = int(r.integers(10, 50_000))
    style = seed % 4
    if style == 0:
        x = r.integers(0, 1 << 32, size=n, dtype=np.uint32)
    elif style == 1:
        x = r.integers(0, 3, size=n, dtype=np.uint32)          # few values
    elif style == 2:
        x = np.sort(r.integers(0, 1 << 32, size=n, dtype=np.uint32))
    else:
        x = np.full(n, r.integers(0, 1 << 32), np.uint32)      # all equal
    chunk = int(r.integers(1, max(2, n // 4)))
    sp, counts, ovf = distributed_sort_balanced(
        jnp.asarray(x), mesh, chunk=chunk)
    assert int(np.asarray(ovf).sum()) == 0
    out = gather_sorted(jnp.asarray(sp).view(jnp.uint32), counts, ovf)
    assert np.array_equal(out, np.sort(x)), (seed, n, chunk)


@pytest.mark.parametrize("seed", range(30))
def test_soak_differential_vs_reference_binary(seed, tmp_path):
    """Differential fuzz: random arrays/types/masks/orders, byte-exact vs the
    COMPILED reference radix_sort (the strongest oracle there is)."""
    import subprocess
    from tests.test_parity import DRIVER, _ensure_driver

    _ensure_driver()
    r = np.random.Generator(np.random.PCG64(7000 + seed))
    tname, dtype = [("u8", np.uint8), ("u16", np.uint16), ("u32", np.uint32),
                    ("u64", np.uint64), ("i32", np.int32), ("i64", np.int64),
                    ("f32", np.float32), ("f64", np.float64)][seed % 8]
    itemsize = np.dtype(dtype).itemsize
    n = int(r.integers(2, 200_000))
    style = seed % 4
    if style == 0:
        raw = r.integers(0, 1 << 32, size=-(-n * itemsize // 4),
                         dtype=np.uint32)
    elif style == 1:  # low entropy
        raw = r.integers(0, 7, size=-(-n * itemsize // 4), dtype=np.uint32)
    elif style == 2:  # presorted bytes
        raw = np.sort(r.integers(0, 1 << 32, size=-(-n * itemsize // 4),
                                 dtype=np.uint32))
    else:             # constant
        raw = np.full(-(-n * itemsize // 4), r.integers(0, 1 << 32),
                      np.uint32)
    keyfile = tmp_path / "keys.dat"
    raw.astype("<u4").tofile(keyfile)
    mask = (None if seed % 3 == 0
            else int(r.integers(1, 1 << 32)) | (1 if itemsize == 1 else 0))
    rev = bool(seed % 2)

    x = raw.view(np.uint8)[: n * itemsize].view(dtype).copy()
    vm = None
    if mask is not None:
        vm = mask & ((1 << (8 * itemsize)) - 1)
        u = x.view(f"u{itemsize}")
        x = (u & np.dtype(f"u{itemsize}").type(vm)).view(dtype)

    out = tmp_path / "ref.bin"
    subprocess.run(
        [str(DRIVER), str(keyfile), str(out), str(n), tname,
         f"{mask:X}" if mask is not None else "-",
         "rev" if rev else "fwd", "sort"], check=True)
    ref = np.fromfile(out, dtype=dtype, count=n)

    cfg = rst.SortConfig(descending=rev)
    mine = np.asarray(rst.sort(x if itemsize == 8 else jnp.asarray(x),
                               config=cfg, value_mask=vm))
    assert np.array_equal(mine.view(np.uint8), ref.view(np.uint8)), (
        seed, tname, n, mask, rev, style)


@pytest.mark.parametrize("seed", range(20))
def test_soak_device_probe(seed):
    """In-graph range-probe soak: clustered / skewed / wide inputs through
    `device_probe=True` over one- and two-word dtypes (both lax.cond
    branches and the u64 hi-plane probe)."""
    import jax
    r = np.random.Generator(np.random.PCG64(0xD0 + seed))
    dtype = [np.uint32, np.int32, np.float32,
             np.uint64, np.int64, np.float64][seed % 6]
    n = int(r.integers(2, 80_000))
    style = seed % 3
    if style == 0:        # clustered: narrow range at a random offset
        width = int(r.integers(1, 1 << int(r.integers(1, 14))))
        raw = r.integers(0, width, size=n, dtype=np.uint64)
        off = int(r.integers(0, 1 << 60))
        x = (raw + np.uint64(off)).astype(np.uint64)
    elif style == 1:      # skewed sparse: may overrun the regen window
        vals = r.integers(0, 1 << 62, size=max(1, n // 50), dtype=np.uint64)
        x = r.choice(vals, size=n).astype(np.uint64)
    else:                 # wide: full entropy
        x = r.integers(0, 1 << 64, size=n, dtype=np.uint64)
    bits = np.dtype(dtype).itemsize * 8
    x &= np.uint64((1 << bits) - 1)
    x = x.astype(np.uint32).view(dtype) if bits == 32 else x.view(dtype)
    cfg = rst.SortConfig(device_probe=True, descending=bool(seed % 2))
    k = _key(x)
    order = np.argsort(np.where(cfg.descending, ~k, k), kind="stable")
    oracle = x[order]
    out = np.asarray(rst.sort(x if bits == 8 * 8 else jnp.asarray(x),
                              config=cfg), dtype=dtype)
    assert np.array_equal(out.view(f"u{x.dtype.itemsize}"),
                          oracle.view(f"u{x.dtype.itemsize}")), (seed, dtype, n)
    jax.clear_caches()


@pytest.mark.parametrize("seed", range(15))
def test_soak_distributed_records(seed):
    """Distributed argsort/pairs soak: both partition methods, overlap mode,
    adversarial styles, stable-permutation oracle."""
    import jax
    from radix_sorting.parallel import (
        distributed_argsort, distributed_sort_pairs, gather_sorted,
        make_sort_mesh)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh")
    r = np.random.Generator(np.random.PCG64(9000 + seed))
    mesh = make_sort_mesh(int(r.integers(2, 9)))
    n = int(r.integers(10, 30_000))
    style = seed % 3
    if style == 0:
        x = r.integers(0, 1 << 32, size=n, dtype=np.uint32)
    elif style == 1:
        x = r.integers(0, 5, size=n, dtype=np.uint32)
    else:
        x = np.full(n, 0xFFFFFFFF, np.uint32)  # all-maximal (pad adversary)
    # seed-driven coverage of BOTH methods and overlap mode (a previous form
    # computed overlap from the same parity that selected the branch, so
    # overlap=True never ran — review finding)
    if seed % 2 == 0:
        method = "balanced"
        kw = {"chunk": int(r.integers(1, max(2, n // 4))),
              "overlap": bool(r.integers(0, 2))}
    else:
        method = "shuffle"
        kw = {"exact": True}
    expect = np.argsort(x, kind="stable").astype(np.uint32)
    if seed % 3 == 0:
        _, perm, counts, ovf = distributed_argsort(
            jnp.asarray(x), mesh, method=method, **kw)
        assert np.array_equal(gather_sorted(perm, counts, ovf), expect)
    else:
        payload = r.integers(0, 1 << 32, size=n, dtype=np.uint32)
        _, pv, counts, ovf = distributed_sort_pairs(
            jnp.asarray(x), payload, mesh, method=method, **kw)
        assert np.array_equal(gather_sorted(jnp.asarray(pv), counts, ovf),
                              payload[expect])


@pytest.mark.parametrize("seed", range(15))
def test_soak_searchsorted_bincount(seed):
    """Randomized sweep of the late-round-3 extras: searchsorted (both
    formulations, both sides) and bincount (dense + fallback) vs numpy."""
    from radix_sorting.extras import bincount, searchsorted
    r = np.random.Generator(np.random.PCG64(0x5EA + seed))
    n = int(r.integers(2, 60_000))
    q = int(r.integers(1, 30_000))
    side = "left" if seed % 2 else "right"
    style = seed % 3
    if style == 0:    # u32 binary-search path
        a = np.sort(r.integers(0, 1 << int(r.integers(3, 33)), size=n,
                               dtype=np.uint32))
        v = r.integers(0, max(2, int(a[-1]) + 1), size=q, dtype=np.uint32)
        got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(v),
                                      side=side))
        assert np.array_equal(got, np.searchsorted(a, v, side=side))
    elif style == 1:  # u64 union-sort path, duplicate-heavy
        base = r.integers(0, 1 << 64, size=max(1, n // 3), dtype=np.uint64)
        a = np.sort(r.choice(base, size=n))
        v = np.concatenate([r.choice(base, size=q // 2 + 1),
                            r.integers(0, 1 << 64, size=q // 2 + 1,
                                       dtype=np.uint64)])[:q]
        got = np.asarray(searchsorted(a, v, side=side))
        assert np.array_equal(got, np.searchsorted(a, v, side=side))
    else:             # bincount, random length (crosses the pow2 rounding)
        length = int(r.integers(2, 5000))
        # ~half the seeds mix in out-of-range values: they must DROP, not
        # alias mod the padded bin count (the drop_ge kernel regression)
        hi = length if seed % 2 else 4 * length
        x = r.integers(0, hi, size=n, dtype=np.uint32)
        got = np.asarray(bincount(jnp.asarray(x), length=length))
        assert np.array_equal(
            got, np.bincount(x[x < length], minlength=length))


@pytest.mark.parametrize("seed", range(8))
def test_soak_bytes_payload(seed):
    """Randomized byte-string payload fields through sort_pairs: random key
    dtype/width, random field width (crossing the 4-byte plane packing),
    numpy S and device u8/i8 matrix forms, duplicate-heavy keys."""
    import radix_sorting as rst
    r = np.random.Generator(np.random.PCG64(0xB17E5 + seed))
    n = int(r.integers(2, 40_000))
    kd = [np.uint8, np.uint16, np.uint32, np.int32][seed % 4]
    lo, hi = (np.iinfo(kd).min, np.iinfo(kd).max)
    k = r.integers(lo, max(lo + 1, hi // 97), size=n, dtype=kd)
    W = int(r.integers(1, 14))
    raw = r.integers(0, 256, size=(n, W), dtype=np.uint8)
    order = np.argsort(k, kind="stable")
    if seed % 2:
        names = np.frombuffer(raw.tobytes(), dtype=f"S{W}")
        _, pv = rst.sort_pairs(jnp.asarray(k), {"s": names})
        assert pv["s"].dtype == names.dtype
        assert np.array_equal(pv["s"], names[order])
    else:
        m = raw if seed % 4 else raw.view(np.int8)
        _, pv = rst.sort_pairs(jnp.asarray(k), {"m": jnp.asarray(m)})
        assert np.array_equal(np.asarray(pv["m"]), m[order])


@pytest.mark.parametrize("seed", range(12))
def test_soak_set_routines(seed):
    """Randomized sweep of sets.py: unique with every flag, one binary set
    op, and isin, vs the numpy oracles. Integer dtypes plus positive-finite
    f32 (numpy's unique/set ops collapse -0.0/+0.0 and NaNs where the KDF
    bitwise order keeps them distinct — covered by directed tests instead)."""
    from radix_sorting import sets
    r = np.random.Generator(np.random.PCG64(0x5E75 + seed))
    n = int(r.integers(2, 50_000))
    m = int(r.integers(1, 50_000))
    kd = [np.uint8, np.uint16, np.uint32, np.uint64,
          np.int16, np.int32, np.int64, np.float32][seed % 8]
    dom = 1 << int(r.integers(2, 20))

    def gen(k):
        if kd is np.float32:
            return (r.integers(0, dom, size=k).astype(np.float32)
                    * np.float32(0.5))
        info = np.iinfo(kd)
        lo = 0 if np.dtype(kd).kind == "u" else max(int(info.min), -(dom // 2))
        hi = min(lo + dom, int(info.max))
        return r.integers(lo, hi, size=k, dtype=kd, endpoint=True)

    a, b = gen(n), gen(m)
    aj = a if a.dtype.itemsize == 8 else jnp.asarray(a)
    bj = b if b.dtype.itemsize == 8 else jnp.asarray(b)

    res = sets.unique(aj, return_index=True, return_inverse=True,
                      return_counts=True)
    uq, idx, inv, cnt = np.unique(a, return_index=True, return_inverse=True,
                                  return_counts=True)
    k = len(uq)
    assert int(res.num_unique) == k
    assert np.array_equal(np.asarray(res.values)[:k].astype(a.dtype), uq)
    assert np.array_equal(np.asarray(res.index)[:k], idx)
    assert np.array_equal(np.asarray(res.inverse), inv)
    assert np.array_equal(np.asarray(res.counts)[:k], cnt)

    op, ref = [(sets.union1d, np.union1d), (sets.intersect1d, np.intersect1d),
               (sets.setdiff1d, np.setdiff1d), (sets.setxor1d, np.setxor1d)
               ][seed % 4]
    vals, c = op(aj, bj)
    want = ref(a, b)
    assert int(c) == len(want)
    assert np.array_equal(np.asarray(vals)[: len(want)].astype(a.dtype), want)

    got = np.asarray(sets.isin(aj, bj))
    assert np.array_equal(got, np.isin(a, b))
    gotv = np.asarray(sets.isin(aj, bj, invert=True))
    assert np.array_equal(gotv, ~got)

    if kd is np.float32:
        # equal_nan sweep: inject NaNs of random payloads, expect one run
        payloads = (r.integers(1, 1 << 22, size=4).astype(np.uint32)
                    | np.uint32(0x7F800000)).view(np.float32)
        an = np.concatenate([a, np.tile(payloads, 3)])
        r.shuffle(an)
        res = sets.unique(jnp.asarray(an), return_counts=True, equal_nan=True)
        kn = int(res.num_unique)
        want = np.unique(an[~np.isnan(an)])
        assert kn == len(want) + 1
        assert np.isnan(np.asarray(res.values)[kn - 1])
        assert int(np.asarray(res.counts)[kn - 1]) == 12


@pytest.mark.parametrize("seed", range(10))
def test_soak_distributed_group_reduce(seed):
    """Randomized distributed group-by: random mesh size D in [2, 8], random
    key cardinality (spanning-run pressure at low cardinality), random
    reduce, random chunking, vs the numpy oracle."""
    import jax
    from radix_sorting.parallel import (distributed_group_reduce,
                                            gather_sorted, make_sort_mesh)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh")
    r = np.random.Generator(np.random.PCG64(0x96D + seed))
    mesh = make_sort_mesh(int(r.integers(2, 9)))
    n = int(r.integers(2, 40_000))
    card = int(r.integers(1, [4, 1 << 16][seed % 2]))  # odd seeds: wide
    k = r.integers(0, card, size=n, dtype=np.uint32, endpoint=True)
    reduce = ["sum", "mean", "min", "max", "count"][seed % 5]
    v = r.integers(0, 1 << 20, size=n, dtype=np.int32)
    chunk = int(r.integers(1, max(2, n // 3)))
    uk, red, counts, ovf = distributed_group_reduce(
        jnp.asarray(k), None if reduce == "count" else jnp.asarray(v),
        mesh, reduce=reduce, chunk=chunk)
    assert int(np.asarray(ovf).sum()) == 0
    got_k = gather_sorted(jnp.asarray(uk), counts)
    got_r = gather_sorted(jnp.asarray(red), counts)
    uq, inv = np.unique(k, return_inverse=True)
    assert np.array_equal(got_k, uq), (seed, n, reduce)
    if reduce == "count":
        want = np.bincount(inv)
    elif reduce in ("sum", "mean"):
        want = np.zeros(len(uq), np.int64)
        np.add.at(want, inv, v.astype(np.int64))
        if reduce == "mean":
            want = (want.astype(np.float64) / np.bincount(inv))
    else:
        want = np.full(len(uq), v[0])
        want[:] = v.max() if reduce == "min" else v.min()
        (np.minimum if reduce == "min" else np.maximum).at(want, inv, v)
    if reduce == "mean":
        assert np.allclose(got_r, want, rtol=1e-6), (seed, n)
    else:
        assert np.array_equal(got_r.astype(np.int64), want), (seed, n, reduce)


@pytest.mark.parametrize("seed", range(12))
def test_soak_stats(seed):
    """Randomized sweep of stats.py: rankdata (every tie method), quantile
    (every numpy method), digitize (both monotonic orders x right), and
    histogram (uniform + edge arrays). Integer-valued data keeps the f32
    binning/lerp arithmetic exact against numpy's f64 oracles."""
    import scipy.stats as scipy_stats
    from radix_sorting import stats
    r = np.random.Generator(np.random.PCG64(0x57A7 + seed))
    n = int(r.integers(2, 60_000))
    kd = [np.uint8, np.uint16, np.uint32, np.uint64,
          np.int16, np.int32, np.int64, np.float32][seed % 8]
    dom = 1 << int(r.integers(1, 16))

    if kd is np.float32:
        x = r.integers(0, dom, size=n).astype(np.float32)
    else:
        info = np.iinfo(kd)
        lo = 0 if np.dtype(kd).kind == "u" else max(int(info.min), -(dom // 2))
        x = r.integers(lo, min(lo + dom, int(info.max)), size=n, dtype=kd,
                       endpoint=True)
    xj = x if x.dtype.itemsize == 8 else jnp.asarray(x)

    method = ["average", "min", "max", "dense", "ordinal"][seed % 5]
    got = np.asarray(stats.rankdata(xj, method=method))
    exp = scipy_stats.rankdata(x, method=method)
    assert np.array_equal(got.astype(np.float64), exp.astype(np.float64)), \
        (seed, n, method)

    qm = ["linear", "lower", "higher", "nearest", "midpoint"][seed % 5]
    qs = np.round(r.random(int(r.integers(1, 6))), 3).tolist()
    got = np.asarray(stats.quantile(xj, qs, method=qm)).astype(np.float64)
    exp = np.quantile(x.astype(np.float64), qs, method=qm)
    # integer-valued data: lerp of ints < 2^16 over f32 is exact unless the
    # fraction itself rounds — compare to f32-rounded tolerance
    assert np.allclose(got, exp, rtol=1e-6, atol=1e-3), (seed, qm)

    nb = int(r.integers(2, 40))
    edges = np.unique(r.integers(0, max(2, dom), size=nb)).astype(np.float64)
    if len(edges) >= 2:
        xf = x.astype(np.float32) if kd is not np.float32 else x
        right = bool(seed % 2)
        b = edges if seed % 4 < 2 else edges[::-1].copy()
        got = np.asarray(stats.digitize(jnp.asarray(xf),
                                        jnp.asarray(b, jnp.float32),
                                        right=right))
        assert np.array_equal(got, np.digitize(xf, b, right=right)), \
            (seed, right, len(b))
        c, _ = stats.histogram(jnp.asarray(xf), bins=edges)
        ce, _ = np.histogram(xf, bins=edges)
        assert np.array_equal(np.asarray(c), ce), (seed, len(edges))
    c, e = stats.histogram(jnp.asarray(x.astype(np.float32)),
                           bins=int(r.integers(1, 64)),
                           range=(0.0, float(max(1, dom))))
    ce, _ = np.histogram(x.astype(np.float32), bins=len(np.asarray(c)),
                         range=(0.0, float(max(1, dom))))
    assert np.array_equal(np.asarray(c), ce), (seed, len(e))


@pytest.mark.parametrize("seed", range(8))
def test_soak_distributed_stats(seed):
    """Randomized pod-scale order statistics: random mesh size, dtype,
    quantile method and probabilities, vs numpy; plus the global bincount.
    Integer-valued data keeps interpolating methods f32-exact."""
    import jax
    from radix_sorting.parallel import (distributed_bincount,
                                            distributed_quantile,
                                            make_sort_mesh)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh")
    r = np.random.Generator(np.random.PCG64(0xD157 + seed))
    mesh = make_sort_mesh(int(r.integers(2, 9)))
    n = int(r.integers(2, 60_000))
    kd = [np.uint32, np.float32, np.int64, np.uint16][seed % 4]
    if kd is np.float32:
        x = r.integers(0, 1 << 16, size=n).astype(np.float32)
    else:
        x = r.integers(0, min(1 << 16, np.iinfo(kd).max), size=n, dtype=kd)
    xj = x if x.dtype.itemsize == 8 else jnp.asarray(x)
    qm = ["linear", "lower", "higher", "nearest", "midpoint"][seed % 5]
    qs = np.round(r.random(int(r.integers(1, 5))), 3).tolist()
    got = np.asarray(distributed_quantile(xj, qs, mesh, method=qm)
                     ).astype(np.float64)
    exp = np.quantile(x.astype(np.float64), qs, method=qm)
    assert np.allclose(got, exp, rtol=1e-6, atol=1e-3), (seed, qm, n)

    xb = (x.astype(np.int64) % 997).astype(np.uint32)
    got = np.asarray(distributed_bincount(jnp.asarray(xb), mesh, 997))
    assert np.array_equal(got, np.bincount(xb, minlength=997)), (seed, n)


@pytest.mark.parametrize("seed", range(8))
def test_soak_distributed_top_k(seed):
    """Randomized pod-scale top-k: random mesh size, dtype, k, direction,
    tie density — must match extras.top_k (values AND stable indices)."""
    import jax
    from radix_sorting.extras import top_k
    from radix_sorting.parallel import distributed_top_k, make_sort_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh")
    r = np.random.Generator(np.random.PCG64(0x709C + seed))
    D = int(r.integers(2, 9))
    mesh = make_sort_mesh(D)
    n = int(r.integers(D, 50_000))
    n_local = -(-n // D)
    k = int(r.integers(1, max(2, min(n, n_local) // 1 + 1)))
    k = min(k, n_local, n)
    largest = bool(r.integers(0, 2))
    kd = [np.uint32, np.int32, np.float32, np.uint64][seed % 4]
    dom = [1 << 31, 17, 1 << 12, 1 << 60][seed % 4]  # seed%4==1: heavy ties
    if kd is np.float32:
        x = (r.integers(0, dom, size=n).astype(np.float32)
             - float(dom) / 2.0)
    else:
        x = r.integers(0, dom, size=n).astype(kd)
    xj = x if x.dtype.itemsize == 8 else jnp.asarray(x)
    vals, idx = distributed_top_k(xj, k, mesh, largest=largest)
    rv, ri = top_k(xj, k, largest=largest)
    assert np.array_equal(np.asarray(vals), np.asarray(rv)), (seed, D, n, k)
    assert np.array_equal(np.asarray(idx), np.asarray(ri)), (seed, D, n, k)


@pytest.mark.parametrize("seed", range(10))
def test_soak_group_reduce_dense(seed):
    """Randomized dense group-by tier (groups promise): random G / key and
    value dtypes / reduce / descending, mod-2^32 exactness vs an int64
    numpy oracle, plus agreement with the sort-native route."""
    from radix_sorting.extras import group_reduce
    from radix_sorting import SortConfig
    r = np.random.Generator(np.random.PCG64(0xDE45E + seed))
    n = int(r.integers(2, 50_000))
    G = int(r.integers(1, 1 << int(r.integers(1, 14))))
    kd = [np.uint32, np.int32, np.uint16, np.uint8][seed % 4]
    k = r.integers(0, min(G, np.iinfo(kd).max + 1), size=n).astype(kd)
    vd = [np.int32, np.uint32, np.int8, np.uint8, np.int16][seed % 5]
    v = r.integers(np.iinfo(vd).min, int(np.iinfo(vd).max) + 1,
                   size=n).astype(vd)
    red = ["sum", "mean"][seed % 2]
    cfg = SortConfig(descending=bool(seed % 3 == 0))
    uk, rv, ng = group_reduce(k, v, reduce=red, groups=G, config=cfg)
    m = int(ng)
    uq = np.unique(k)
    if cfg.descending:
        uq = uq[::-1]
    assert m == len(uq), (seed, m, len(uq))
    assert np.array_equal(np.asarray(uk)[:m].astype(np.int64), uq)
    sums = np.zeros(G, np.int64)
    np.add.at(sums, k.astype(np.int64), v.astype(np.int64))
    cnts = np.bincount(k.astype(np.int64), minlength=G)
    # both routes accumulate in 32 bits: wrap the int64 oracle to the
    # accumulator dtype first (sum AND mean share the wrap by contract)
    acc = np.uint32 if np.dtype(vd).kind == "u" else np.int32
    want32 = (sums & 0xFFFFFFFF).astype(np.uint32).astype(acc)
    if red == "sum":
        got = np.asarray(rv)[:m]
        assert np.array_equal(
            got.astype(np.uint32), want32[uq].astype(np.uint32)), (seed, kd, vd)
    else:
        want = want32[uq].astype(np.float32) / np.maximum(cnts[uq], 1)
        assert np.allclose(np.asarray(rv)[:m], want, rtol=1e-5,
                           atol=1e-3), (seed, kd, vd)
    # agreement with the sort-native route on the same inputs
    uk2, rv2, ng2 = group_reduce(k, v, reduce=red, size=m, config=cfg)
    assert int(ng2) == m
    assert np.array_equal(np.asarray(uk)[:m], np.asarray(uk2)[:m])
    if red == "mean":
        assert np.allclose(np.asarray(rv)[:m], np.asarray(rv2)[:m],
                           rtol=1e-5)
    else:
        assert np.array_equal(np.asarray(rv)[:m], np.asarray(rv2)[:m])


@pytest.mark.parametrize("seed", range(4))
def test_soak_searchsorted_chunked_large_q(seed):
    """q of the same order as n through the chunked (lax.map) query path —
    the guard for the q=40M worker fault — on both key widths."""
    import radix_sorting.extras as ex
    r = np.random.Generator(np.random.PCG64(0x40A0 + seed))
    old = ex._SEARCHSORTED_QBLOCK
    ex._SEARCHSORTED_QBLOCK = 1 << 12
    try:
        n = int(r.integers(10_000, 80_000))
        q = int(r.integers(n // 2, 2 * n))  # q ~ n
        side = "left" if seed % 2 else "right"
        if seed % 2:
            a = np.sort(r.integers(0, 1 << 30, size=n, dtype=np.uint32))
            v = r.integers(0, 1 << 30, size=q, dtype=np.uint32)
            got = np.asarray(ex.searchsorted(jnp.asarray(a), jnp.asarray(v),
                                             side=side))
        else:
            a = np.sort(r.integers(0, 1 << 62, size=n, dtype=np.uint64))
            v = r.integers(0, 1 << 62, size=q, dtype=np.uint64)
            got = np.asarray(ex.searchsorted(a, v, side=side))
        assert np.array_equal(got, np.searchsorted(a, v, side=side)), seed
    finally:
        ex._SEARCHSORTED_QBLOCK = old
