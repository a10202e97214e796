"""On-card smoke test: the public API at the reference's 40M-key scale.

Drives ``import radix_sorting as rst`` the way a user does, on one GPU,
and checks every result against an independent host oracle (numpy):

* ``sort``, ``argsort`` and ``sort_pairs`` on 40,000,000 u32 keys (the
  reference's dataset size, `Makefile:79-82`), with the sort kernel each
  became in the optimized HLO (CUB's radix sort or XLA's own sort);
* the counting tier (``value_mask=0xF0F00000``), u16 over the full domain,
  numpy u64 keys without x64, masked u64 keys with live bits in both planes
  (timed against the two-key sort of the raw planes), f32 with NaN and +-inf, bf16 and f16 with NaN
  payloads, int4/uint4, ``S16`` byte strings, ``sort_batched`` rows,
  ``group_reduce`` (i32 bit-exact; f32 within |err| <= count_g * 2^-23 *
  max|v| per group, since GPU atomics add in a run-dependent order),
  ``bincount``, the in-graph device probe, ``unique``, ``searchsorted`` and
  ``top_k``;
* the experiment CLI once, in-process;
* one profiler trace of the headline sort, reduced to its top device ops.

Every phase prints its warm time (median of 3 calls closed by
``block_until_ready``) and PASS/FAIL. The last line is one JSON object,
``{"ok": ..., "device": {"platform", "kind", "count"}}``; any failed phase
makes it ``"ok": false`` with a nonzero exit. Off the GPU the script stops
before any phase.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # only the distributed sorts on 4 cards

``--four`` runs ``parallel``'s distributed sorts on a 4-card mesh in this
one process, 2^25 keys per card, against numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
import traceback

import numpy as np

N = 40_000_000
N_SMALL = 1_000_000
N_SURFACES = 4_000_000
N_PER_CARD = 1 << 25
SEED = 0x5EED
TRACE_DIR = os.path.join("chiprun_out", "chip_smoke_trace")


def _block(out):
    import jax

    return jax.block_until_ready(out)


def _warm(fn, *args, reps: int = 3):
    """(result of the first call, median ms of ``reps`` warm calls)."""
    out = _block(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(ts)


def _sort_kernels(fn, *args) -> str:
    """Which sort kernels the optimized HLO of ``fn(*args)`` holds."""
    import jax

    txt = jax.jit(fn).lower(*args).compile().as_text()
    cub = sorted(set(re.findall(r'custom_call_target="([^"]*[Ss]ort[^"]*)"',
                                txt)))
    own = len(re.findall(r"\ssort\(", txt))
    return f"custom-call sorts {cub or 'none'}; XLA sort ops {own}"


def _bits(x):
    """Host view of an array's raw bits as the unsigned type of its width."""
    a = np.asarray(x)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _float_order_oracle(u: np.ndarray, width: int) -> np.ndarray:
    """Raw float bits sorted by the KDF total order, in numpy: negative
    values (sign bit set) invert every bit, the rest set the sign bit, and
    the derived keys sort as unsigned integers (-NaN < -inf < ... < +inf <
    +NaN, each NaN by payload)."""
    sign = u.dtype.type(1 << (width - 1))
    key = np.where(u & sign, ~u, u | sign)
    key.sort()
    return np.where(key & sign, key ^ sign, ~key)


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            ok, ms, detail = fn()
        except Exception:  # recorded as a failed phase; the run exits nonzero
            ok, ms, detail = False, None, traceback.format_exc(limit=4)
        if not ok:
            self.failed.append(name)
        ms_txt = "n/a" if ms is None else f"{ms:.3f}"
        print(f"phase {name}: {'PASS' if ok else 'FAIL'} warm_ms={ms_txt} "
              f"total_s={time.perf_counter() - t0:.1f} {detail}", flush=True)


def _drive_surfaces(n: int) -> list:
    """The surfaces ``run_single`` has no phase for, at ``n`` keys against
    numpy; returns the names of the checks that failed."""
    import jax.numpy as jnp

    import radix_sorting as rst
    from radix_sorting.extras import merge_sorted
    from radix_sorting.parallel import (
        distributed_select,
        distributed_sort_balanced_u32,
        distributed_unique_sorted,
        gather_sorted,
        make_sort_mesh,
    )

    rng = np.random.default_rng(0xD1CE)
    failed = []

    def check(name, cond):
        if not bool(cond):
            failed.append(name)

    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    xj = jnp.asarray(x)

    perm = np.asarray(rst.argsort(jnp.asarray(x % 1000)))
    check("stable rank sort (heavy ties)",
          np.array_equal(perm, np.argsort(x % 1000, kind="stable")))

    v = rng.standard_normal(n).astype(np.float32)

    # byte-string payload field (numpy S in -> numpy S out; packed u32
    # planes — verifies the pack/unpack lowering on the card)
    nb = min(n, 200_000)
    names = np.array([f"k{i:06d}".encode() for i in range(nb)], dtype="S7")
    kb = (x[:nb] % 50).astype(np.uint32)
    _, svb = rst.sort_pairs(jnp.asarray(kb), {"name": names})
    check("record sort (byte-string field)",
          np.array_equal(svb["name"], names[np.argsort(kb, kind="stable")]))

    x64 = rng.integers(0, 1 << 64, size=n // 4, dtype=np.uint64)

    # dynamic probe: unpromised u64 keys with 12 varying bits across both
    # planes, measured on the host and sorted as one compacted operand
    xlow = ((rng.integers(0, 64, size=n).astype(np.uint64) << np.uint64(40))
            | (rng.integers(0, 64, size=n).astype(np.uint64) << np.uint64(9)))
    cfg = rst.SortConfig(dynamic_probe=True)
    out = np.asarray(rst.sort(xlow, config=cfg), dtype=np.uint64)
    check("dynamic probe (unpromised low-entropy u64)",
          np.array_equal(out, np.sort(xlow)))

    # masked-u64 pairs through plane compaction (2 sorter operands)
    cmask = (0xFF << 32) | 0x0000F000
    k64 = (x64 & np.uint64(cmask)) if n >= 4 else x64
    pay = np.arange(k64.size, dtype=np.uint32)
    sk, sv = rst.sort_pairs(k64, jnp.asarray(pay), value_mask=cmask)
    order = np.argsort(k64, kind="stable")
    check("masked-u64 pairs (plane compaction)",
          np.array_equal(np.asarray(sv), pay[order])
          and np.array_equal(np.asarray(sk, dtype=np.uint64), k64[order]))

    # packed lexsort: four u8 columns as one operand
    from radix_sorting.extras import lexsort, segmented_sort
    cols = [(x >> np.uint32(8 * i)).astype(np.uint8) for i in range(4)]
    perm = np.asarray(lexsort([jnp.asarray(c) for c in cols]))
    check("packed lexsort (4x u8)",
          np.array_equal(perm, np.lexsort(tuple(cols)).astype(np.uint32)))

    # packed segmented sort, keys-descending in place
    seg = (x % np.uint32(37)).astype(np.uint8)
    k16 = (x >> np.uint32(11)).astype(np.uint16)
    sk2, sid = segmented_sort(jnp.asarray(k16), jnp.asarray(seg),
                              config=rst.SortConfig(descending=True))
    order = np.lexsort((np.uint16(0xFFFF) - k16, seg))
    check("packed segmented sort (desc keys)",
          np.array_equal(np.asarray(sid), seg[order])
          and np.array_equal(np.asarray(sk2), k16[order]))

    a = np.sort(x[: n // 2])
    b = np.sort(x[n // 2:])
    out = np.asarray(merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    check("merge_sorted", np.array_equal(out, np.sort(x)))

    # searchsorted: binary-search (u32) + tagged-union (u64) formulations
    from radix_sorting.extras import searchsorted
    q = x[: max(4, n // 8)]
    got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(q), side="right"))
    check("searchsorted u32", np.array_equal(got, np.searchsorted(a, q, side="right")))
    a64 = np.sort(x64)
    q64 = x64[: max(4, x64.size // 8)]
    got = np.asarray(searchsorted(a64, q64))
    check("searchsorted u64 (union sort)",
          np.array_equal(got, np.searchsorted(a64, q64)))
    # chunked query path: force the lax.map blocks at this scale by
    # shrinking the block size
    import radix_sorting.extras as _ex
    _old_qb = _ex._SEARCHSORTED_QBLOCK
    _ex._SEARCHSORTED_QBLOCK = max(1024, n // 8)
    try:
        qc = x[: max(8, n // 2)]
        got = np.asarray(searchsorted(jnp.asarray(a), jnp.asarray(qc)))
        check("searchsorted chunked queries (lax.map blocks)",
              np.array_equal(got, np.searchsorted(a, qc)))
    finally:
        _ex._SEARCHSORTED_QBLOCK = _old_qb
    # sorter= (numpy parity): unsorted keys + a sorting permutation
    au = x[: n // 2]
    srt = np.argsort(au, kind="stable")
    got = np.asarray(searchsorted(jnp.asarray(au), jnp.asarray(q),
                                  side="right", sorter=jnp.asarray(srt)))
    check("searchsorted sorter=",
          np.array_equal(got, np.searchsorted(au, q, side="right",
                                              sorter=srt)))

    # intersect1d return_indices: first-occurrence positions ride the fused
    # sort as the lowest composite key
    from radix_sorting.sets import intersect1d
    ia = (x[: n // 4] & np.uint32(0x3FFF)).astype(np.uint32)
    ib = (x[n // 4: n // 2] & np.uint32(0x3FFF)).astype(np.uint32)
    vals, c1, c2, cnt = intersect1d(jnp.asarray(ia), jnp.asarray(ib),
                                    return_indices=True)
    wv, w1, w2 = np.intersect1d(ia, ib, return_indices=True)
    k = len(wv)
    check("intersect1d return_indices (first occurrences)",
          int(cnt) == k
          and np.array_equal(np.asarray(vals)[:k], wv)
          and np.array_equal(np.asarray(c1)[:k], w1)
          and np.array_equal(np.asarray(c2)[:k], w2))

    # unique axis=0: rows as one composite multi-operand sort
    from radix_sorting.sets import unique as _uniq
    rows = np.stack([(x[: n // 4] & np.uint32(0xFF)),
                     (x[n // 4: n // 2] & np.uint32(0xF))], axis=1)
    ur = _uniq(jnp.asarray(rows), axis=0, return_counts=True)
    wv, wc = np.unique(rows, axis=0, return_counts=True)
    uk = len(wv)
    check("unique axis=0 (rows as composite sort keys)",
          int(ur.num_unique) == uk
          and np.array_equal(np.asarray(ur.values)[:uk], wv)
          and np.array_equal(np.asarray(ur.counts)[:uk], wc))

    # bincount: 12-bit values against length=1000 (values >= 1000 dropped)
    from radix_sorting.extras import bincount
    xb8 = (x & np.uint32(0xFFF)).astype(np.uint32)
    got = np.asarray(bincount(jnp.asarray(xb8), length=1000))
    check("bincount (out-of-range drop)",
          np.array_equal(got, np.bincount(xb8, minlength=1000)[:1000]))

    # float8 keys: KDF-only extension over a 256-value domain
    from radix_sorting.ops import kdf
    f8 = jnp.asarray((x & np.uint32(0xFF)).astype(np.uint8)).view(
        jnp.dtype("float8_e4m3fn"))
    sf8 = rst.sort(f8)
    kx = np.asarray(kdf.encode(f8)[0])
    check("float8 sort",
          np.array_equal(np.asarray(kdf.encode(sf8)[0]), np.sort(kx)))

    # set routines: unique with the full flag surface + one merged-run set op
    # + isin (three distinct sort formulations: rank sort, side-flag merge,
    # searchsorted membership)
    from radix_sorting.sets import intersect1d, isin, unique
    xs = (x & np.uint32(0x3FFF)).astype(np.uint32)
    r = unique(jnp.asarray(xs), return_index=True, return_inverse=True,
               return_counts=True, size=1 << 14)
    uq, uidx, uinv, ucnt = np.unique(xs, return_index=True,
                                     return_inverse=True, return_counts=True)
    k = len(uq)
    check("unique (index/inverse/counts)",
          int(r.num_unique) == k
          and np.array_equal(np.asarray(r.values)[:k], uq)
          and np.array_equal(np.asarray(r.index)[:k], uidx)
          and np.array_equal(np.asarray(r.inverse), uinv)
          and np.array_equal(np.asarray(r.counts)[:k], ucnt))
    sa, sb = xs[: n // 2], (x[n // 2:] & np.uint32(0x3FFF)).astype(np.uint32) | 0x2000
    vals, cnt = intersect1d(jnp.asarray(sa), jnp.asarray(sb), size=1 << 14)
    want = np.intersect1d(sa, sb)
    check("intersect1d (side-flag merged sort)",
          int(cnt) == len(want)
          and np.array_equal(np.asarray(vals)[: len(want)], want))
    got = np.asarray(isin(jnp.asarray(sa[:100_000]), jnp.asarray(sb[:100_000])))
    gotv = np.asarray(isin(jnp.asarray(sa[:100_000]), jnp.asarray(sb[:100_000]),
                           invert=True))
    check("isin (membership via searchsorted)",
          np.array_equal(got, np.isin(sa[:100_000], sb[:100_000]))
          and np.array_equal(gotv, ~got))

    # group-by reduction: one unstable (key, value) composite sort
    from radix_sorting.extras import group_reduce
    gk = (x & np.uint32(0x3FF)).astype(np.uint32)
    gv = (x >> np.uint32(10)).astype(np.int32) & 0xFFFF
    uk, tot, ng = group_reduce(jnp.asarray(gk), jnp.asarray(gv), reduce="sum")
    uq, inv = np.unique(gk, return_inverse=True)
    want = np.zeros(len(uq), np.int64)
    np.add.at(want, inv, gv.astype(np.int64))
    check("group_reduce sum (composite sort, cumsum-diff)",
          int(ng) == len(uq)
          and np.array_equal(np.asarray(uk)[: len(uq)], uq)
          and np.array_equal(np.asarray(tot)[: len(uq)].astype(np.int64),
                             want))

    from radix_sorting.extras import value_counts
    vcv, vcc, vcn = value_counts(jnp.asarray(gk), groups=1 << 10)
    check("value_counts dense tier",
          int(vcn) == len(uq)
          and np.array_equal(np.asarray(vcv)[: len(uq)], uq)
          and np.array_equal(np.asarray(vcc)[: len(uq)],
                             np.bincount(gk, minlength=1 << 10)[uq]))

    # order statistics / ranking: tie-aware ranks (boundary algebra +
    # inverse-permutation restore), exact quantiles off the dispatched
    # sort, histogram through the dense bincount + group_reduce routes
    from radix_sorting.stats import digitize, histogram, quantile, rankdata
    rk = (x & np.uint32(0x7F)).astype(np.uint32)  # heavy ties
    got = np.asarray(rankdata(jnp.asarray(rk), method="average"))
    srt = np.argsort(rk, kind="stable")
    rmin = np.empty(n, np.int64); rmax = np.empty(n, np.int64)
    isnew = np.concatenate([[True], rk[srt][1:] != rk[srt][:-1]])
    rid = np.cumsum(isnew) - 1
    starts = np.flatnonzero(isnew)
    lens = np.diff(np.concatenate([starts, [n]]))
    rmin[srt] = starts[rid]; rmax[srt] = starts[rid] + lens[rid] - 1
    want_avg = (rmin + rmax) / 2.0 + 1.0
    check("rankdata average (tie algebra)",
          np.array_equal(got.astype(np.float64), want_avg))
    got = np.asarray(quantile(jnp.asarray(v), [0.01, 0.5, 0.99]))
    want = np.quantile(v.astype(np.float64), [0.01, 0.5, 0.99])
    check("quantile (sorted-take lerp)", np.allclose(got, want, rtol=1e-5))
    # grid-aligned data: stats.py's f32 uniform binning matches numpy's
    # f64 oracle bit-for-bit only away from the ~1-ulp edge band (the
    # documented precision contract; tests/test_stats.py verifies the raw
    # f32 arithmetic itself)
    vh = np.round(v, 2).astype(np.float32)
    hc, he = histogram(jnp.asarray(vh), bins=64, range=(-4.0, 4.0))
    wc, _ = np.histogram(vh, bins=64, range=(-4.0, 4.0))
    check("histogram uniform (dense bincount)",
          np.array_equal(np.asarray(hc), wc))
    hw, _ = histogram(jnp.asarray(vh), bins=16, range=(-2.0, 2.0),
                      weights=jnp.asarray(np.abs(v)))
    ww, _ = np.histogram(vh, bins=16, range=(-2.0, 2.0),
                         weights=np.abs(v).astype(np.float64))
    check("histogram weighted (group_reduce densify)",
          np.allclose(np.asarray(hw), ww, rtol=1e-3, atol=1e-2))
    dedges = np.array([3.0, 1.0, 0.0, -1.0, -3.0], np.float32)
    got = np.asarray(digitize(jnp.asarray(v), jnp.asarray(dedges)))
    check("digitize (decreasing bins)",
          np.array_equal(got, np.digitize(v, dedges)))

    mesh = make_sort_mesh(1)
    sp, counts, ovf = distributed_sort_balanced_u32(xj, mesh)
    check("distributed balanced (1-device mesh)",
          np.array_equal(gather_sorted(sp, counts, ovf), np.sort(x)))

    ranks = [0, n // 2, n - 1]
    got = np.asarray(distributed_select(xj, ranks, mesh))
    check("distributed_select", np.array_equal(got, np.sort(x)[ranks]))

    xu = rng.integers(0, 5000, size=n, dtype=np.uint32)
    vals, counts, ovf = distributed_unique_sorted(jnp.asarray(xu), mesh)
    check("distributed_unique_sorted",
          np.array_equal(gather_sorted(vals, counts, ovf), np.unique(xu)))

    from radix_sorting.parallel import distributed_group_reduce
    gk = (xu % 211).astype(np.uint32)
    gvv = (xu >> 4).astype(np.int32)
    uk, red, counts, ovf = distributed_group_reduce(
        jnp.asarray(gk), jnp.asarray(gvv), mesh, reduce="sum")
    uq, inv = np.unique(gk, return_inverse=True)
    want = np.zeros(len(uq), np.int64)
    np.add.at(want, inv, gvv.astype(np.int64))
    check("distributed_group_reduce (1-device mesh)",
          np.array_equal(gather_sorted(uk, counts, ovf), uq)
          and np.array_equal(
              gather_sorted(red, counts, ovf).astype(np.int64), want))
    # dense tier: per-shard scatter-adds + one psum
    uk, red, counts, ovf = distributed_group_reduce(
        jnp.asarray(gk), jnp.asarray(gvv), mesh, reduce="sum", groups=211)
    check("distributed_group_reduce dense tier (1-device mesh)",
          np.array_equal(gather_sorted(uk, counts, ovf), uq)
          and np.array_equal(
              gather_sorted(red, counts, ovf).astype(np.int64), want))

    from radix_sorting.parallel import (distributed_bincount,
                                            distributed_quantile)
    got = np.asarray(distributed_quantile(xj, [0.25, 0.5, 0.75], mesh,
                                          method="lower"))
    check("distributed_quantile (1-device mesh)",
          np.array_equal(got, np.quantile(x, [0.25, 0.5, 0.75],
                                          method="lower").astype(np.uint32)))
    got = np.asarray(distributed_bincount(jnp.asarray(xu), mesh, 5000))
    check("distributed_bincount (1-device mesh)",
          np.array_equal(got, np.bincount(xu, minlength=5000)))

    from radix_sorting.extras import top_k as local_top_k
    from radix_sorting.parallel import distributed_top_k
    tv, ti = distributed_top_k(xj, 64, mesh)
    rv, ri = local_top_k(xj, 64)
    check("distributed_top_k (1-device mesh)",
          np.array_equal(np.asarray(tv), np.asarray(rv))
          and np.array_equal(np.asarray(ti), np.asarray(ri)))

    return failed


def run_single(n: int, trace_dir: str = TRACE_DIR) -> list:
    """All one-card phases at ``n`` keys; returns the failed phase names."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import radix_sorting as rst
    from radix_sorting.utils import timing

    P = Phases()
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(SEED), 3)
    x = jax.random.bits(k0, (n,), jnp.uint32)
    x2 = jax.random.bits(k1, (n,), jnp.uint32)
    xh, x2h = np.asarray(x), np.asarray(x2)

    def headline():
        out, ms = _warm(rst.sort, x)
        ok = np.array_equal(np.asarray(out), np.sort(xh))
        return ok, ms, _sort_kernels(rst.sort, x)

    def argsort():
        out, ms = _warm(rst.argsort, x)
        ok = np.array_equal(np.asarray(out),
                            np.argsort(xh, kind="stable").astype(np.uint32))
        return ok, ms, _sort_kernels(rst.argsort, x)

    def pairs():
        keys = x >> np.uint32(12)                   # ~38 keys per value
        pay = {"id": jnp.arange(n, dtype=jnp.uint32),
               "v": jax.random.normal(k2, (n,), jnp.float32)}
        (sk, sv), ms = _warm(rst.sort_pairs, keys, pay)
        kh = np.asarray(keys)
        order = np.argsort(kh, kind="stable")
        ok = (np.array_equal(np.asarray(sk), kh[order])
              and np.array_equal(np.asarray(sv["id"]), order.astype(np.uint32))
              and np.array_equal(_bits(sv["v"]),
                                 _bits(pay["v"])[order]))
        return ok, ms, _sort_kernels(rst.sort_pairs, keys, pay)

    def masked():
        mask = 0xF0F00000
        xm = x & np.uint32(mask)
        out, ms = _warm(lambda a: rst.sort(a, value_mask=mask), xm)
        return np.array_equal(np.asarray(out), np.sort(np.asarray(xm))), ms, ""

    def u16():
        x16 = (x & np.uint32(0xFFFF)).astype(jnp.uint16)
        out, ms = _warm(rst.sort, x16)
        return np.array_equal(np.asarray(out), np.sort(np.asarray(x16))), ms, ""

    def u64_numpy():
        h = (xh.astype(np.uint64) << np.uint64(32)) | x2h.astype(np.uint64)
        out, ms = _warm(rst.sort, h)
        ok = isinstance(out, np.ndarray) and out.dtype == np.uint64 \
            and np.array_equal(out, np.sort(h))
        return ok, ms, f"x64={jax.config.jax_enable_x64}"

    def u64_mask_two_plane():
        # 16 live bits, 8 in each plane: the public route compacts them into
        # ONE u32 operand (the library sort); timed against the two-key sort
        # of the raw (hi, lo) planes (XLA's own kernel) that compaction avoids
        mask = (0x0F0F << 32) | 0xF0F0_0000
        h = ((xh.astype(np.uint64) << np.uint64(32)) | x2h.astype(np.uint64)) \
            & np.uint64(mask)
        want = np.sort(h)
        ok = np.array_equal(np.asarray(rst.sort(h, value_mask=mask),
                                       dtype=np.uint64), want)
        from radix_sorting.ops import kdf

        def two_key(k):
            return kdf.decode(lax.sort(kdf.encode(k), num_keys=2,
                                       is_stable=False), k.dtype)

        routes = {
            "public": jax.jit(lambda k: rst.sort(k, value_mask=mask)),
            "public_noguard": jax.jit(lambda k: rst.sort(
                k, value_mask=mask,
                config=rst.SortConfig(detect_presorted=False))),
            "two_key_raw_planes": jax.jit(two_key),
        }
        details, ms = [], {}
        with jax.enable_x64(True):
            k = jnp.asarray(h)
            for name, fn in routes.items():
                out, ms[name] = _warm(fn, k)
                good = np.array_equal(np.asarray(out), want)
                ok &= good
                details.append(f"{name} {ms[name]:.3f}ms "
                               f"{'ok' if good else 'WRONG'} "
                               f"[{_sort_kernels(fn, k)}]")
        return ok, ms["public"], "; ".join(details)

    def f32_special():
        u = x2h.copy()
        u[:8] = [0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001,
                 0x7F800001, 0x00000000, 0x80000000, 0x7FFFFFFF]
        f = lax.bitcast_convert_type(jnp.asarray(u), jnp.float32)
        out, ms = _warm(rst.sort, f)
        nans = int(np.sum((u & 0x7F800000) == 0x7F800000) - 2)
        ok = np.array_equal(_bits(out), _float_order_oracle(u, 32))
        return ok, ms, f"nan_inputs={nans}"

    def half(dtype, name):
        def phase():
            u = (x2 & np.uint32(0xFFFF)).astype(jnp.uint16)
            h = lax.bitcast_convert_type(u, dtype)
            out, ms = _warm(rst.sort, h)
            uh = np.asarray(u)
            ok = np.array_equal(_bits(out), _float_order_oracle(uh, 16))
            # NaN payloads survive the round trip through the card bit for bit
            back = np.asarray(lax.bitcast_convert_type(h, jnp.uint16))
            return ok and np.array_equal(back, uh), ms, f"{name} bit-exact"
        return phase

    def subbyte():
        import ml_dtypes
        details, ok, mst = [], True, 0.0
        for dt, lo, hi in ((ml_dtypes.int4, -8, 8), (ml_dtypes.uint4, 0, 16)):
            v = (xh % np.uint32(hi - lo)).astype(np.int16) + lo
            host = v.astype(dt)
            dev = jnp.asarray(host)           # a concrete sub-byte device array
            out, ms = _warm(rst.sort, dev)
            good = np.array_equal(np.asarray(out).astype(np.int16), np.sort(v))
            ok &= good
            mst += ms
            details.append(f"{np.dtype(dt).name}:{'ok' if good else 'WRONG'}")
        return ok, mst, " ".join(details)

    def bytes16():
        rng = np.random.default_rng(SEED)
        raw = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
        raw[: n // 2, 8:] = 0                 # ties on the first 8 bytes
        s = raw.view("S16").reshape(-1)
        out, ms = _warm(rst.sort, s)
        be = raw.view(">u8").reshape(n, 2)
        want = raw[np.lexsort((be[:, 1], be[:, 0]))]
        got = np.ascontiguousarray(out).view(np.uint8).reshape(n, 16)
        return np.array_equal(got, want), ms, ""

    def batched():
        rows = (n // 4096)
        xb = x[: rows * 4096].reshape(rows, 4096)
        out, ms = _warm(rst.sort_batched, xb)
        ok = np.array_equal(np.asarray(out),
                            np.sort(xh[: rows * 4096].reshape(rows, 4096), -1))
        return ok, ms, f"shape=({rows}, 4096); " + _sort_kernels(
            rst.sort_batched, xb)

    gk = x & np.uint32(1023)
    gkh = np.asarray(gk)

    def group_i32():
        gv = lax.bitcast_convert_type(x2, jnp.int32)
        (uk, tot, ng), ms = _warm(
            lambda k, v: rst.group_reduce(k, v, reduce="sum", groups=1024),
            gk, gv)
        vh = np.asarray(gv).astype(np.int64)
        # exact int64 sums from two 16-bit halves (float64 bincount is exact
        # below 2^53), then the i32 wrap the device accumulator has
        lo = np.bincount(gkh, weights=vh & 0xFFFF, minlength=1024)
        hi = np.bincount(gkh, weights=vh >> 16, minlength=1024)
        want = (lo.astype(np.int64) + (hi.astype(np.int64) << 16))
        want = ((want + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
        present = np.flatnonzero(np.bincount(gkh, minlength=1024))
        m = len(present)
        ok = (int(ng) == m
              and np.array_equal(np.asarray(uk)[:m], present)
              and np.array_equal(np.asarray(tot)[:m], want[present]))
        return ok, ms, "bit-exact"

    def group_f32():
        gv = jax.random.normal(k2, (n,), jnp.float32) * 100
        (uk, tot, ng), ms = _warm(
            lambda k, v: rst.group_reduce(k, v, reduce="sum", groups=1024),
            gk, gv)
        vh = np.asarray(gv).astype(np.float64)
        want = np.bincount(gkh, weights=vh, minlength=1024)
        cnt = np.bincount(gkh, minlength=1024)
        order = np.argsort(gkh, kind="stable")
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        present = np.flatnonzero(cnt)
        vmax = np.maximum.reduceat(np.abs(vh[order]), starts[present])
        bound = cnt[present] * 2.0 ** -23 * vmax
        err = np.abs(np.asarray(tot)[: len(present)].astype(np.float64)
                     - want[present])
        ok = (int(ng) == len(present)
              and np.array_equal(np.asarray(uk)[: len(present)], present)
              and bool(np.all(err <= bound)))
        return ok, ms, (f"max err/bound {float(np.max(err / bound)):.3g} "
                        "(|err| <= count_g*2^-23*max|v| per group)")

    def bincount():
        xb = x & np.uint32(0xFFF)
        out, ms = _warm(lambda a: rst.bincount(a, length=1000), xb)
        want = np.bincount(np.asarray(xb), minlength=4096)[:1000]
        return np.array_equal(np.asarray(out), want), ms, "values >= 1000 dropped"

    def device_probe():
        xn = (x % np.uint32(5000)) + np.uint32(2_000_000_000)
        cfg = rst.SortConfig(device_probe=True)
        out, ms = _warm(lambda a: rst.sort(a, config=cfg), xn)
        ok = np.array_equal(np.asarray(out), np.sort(np.asarray(xn)))
        # two-word keys are what the in-graph probe dispatches on: clustered
        # u64 (constant hi plane, narrow lo) takes its one-operand branch
        xc = (np.uint64(0xABCD_0000_4000_0000)
              + (xh % np.uint32(4000)).astype(np.uint64))
        out = np.asarray(rst.sort(xc, config=cfg), dtype=np.uint64)
        good = np.array_equal(out, np.sort(xc))
        return ok and good, ms, (f"u32 narrow range timed; clustered u64 "
                                 f"{'ok' if good else 'WRONG'}")

    m = min(n, N_SMALL)

    def unique_flags():
        xs = x[:m] & np.uint32(0x3FFF)
        r, ms = _warm(lambda a: rst.unique(
            a, return_index=True, return_inverse=True, return_counts=True,
            size=1 << 14), xs)
        uq, ui, uinv, uc = np.unique(np.asarray(xs), return_index=True,
                                     return_inverse=True, return_counts=True)
        k = len(uq)
        ok = (int(r.num_unique) == k
              and np.array_equal(np.asarray(r.values)[:k], uq)
              and np.array_equal(np.asarray(r.index)[:k], ui)
              and np.array_equal(np.asarray(r.inverse), uinv)
              and np.array_equal(np.asarray(r.counts)[:k], uc))
        return ok, ms, f"n={m}"

    def searchsorted():
        a = jnp.sort(x[:m])
        q = x2[:m]
        out, ms = _warm(lambda s, t: rst.searchsorted(s, t, side="right"), a, q)
        want = np.searchsorted(np.asarray(a), np.asarray(q), side="right")
        return np.array_equal(np.asarray(out), want), ms, f"n={m}"

    def top_k():
        (v, i), ms = _warm(lambda a: rst.top_k(a, 10), x[:m])
        order = np.argsort(-xh[:m].astype(np.int64), kind="stable")[:10]
        ok = (np.array_equal(np.asarray(v), xh[:m][order])
              and np.array_equal(np.asarray(i), order.astype(np.uint32)))
        return ok, ms, f"n={m}"

    def cli_in_process():
        from radix_sorting import cli
        t0 = time.perf_counter()
        rc = cli.main([str(n), "u32", "0xF0F00000"])
        return rc == 0, None, f"rc={rc} wall_s={time.perf_counter() - t0:.1f}"

    def trace():
        _block(rst.sort(x))
        with timing.trace(trace_dir):
            _block(rst.sort(x))
        rows = timing.device_op_table(trace_dir)
        top = "; ".join(f"{r['op'][:72]} {r['total_us']:.1f}us x{r['calls']}"
                        for r in rows[:5])
        return bool(rows), None, f"top device ops: {top}"

    P.run("sort_u32_40M", headline)
    P.run("argsort_u32_40M", argsort)
    P.run("sort_pairs_u32_id_f32", pairs)
    P.run("counting_mask_F0F00000", masked)
    P.run("u16_full_domain", u16)
    P.run("u64_numpy_no_x64", u64_numpy)
    P.run("u64_mask_two_plane", u64_mask_two_plane)
    P.run("f32_nan_inf", f32_special)
    P.run("bf16_nan_payloads", half(jnp.bfloat16, "bf16"))
    P.run("f16_nan_payloads", half(jnp.float16, "f16"))
    P.run("int4_uint4_concrete", subbyte)
    P.run("bytes_S16", bytes16)
    P.run("sort_batched_rows", batched)
    P.run("group_reduce_i32_1024", group_i32)
    P.run("group_reduce_f32_1024", group_f32)
    P.run("bincount_1000", bincount)
    P.run("device_probe_narrow_range", device_probe)
    P.run("unique_all_flags", unique_flags)
    P.run("searchsorted", searchsorted)
    P.run("top_k", top_k)

    def surfaces():
        failed = _drive_surfaces(N_SURFACES)
        return not failed, None, (f"n={N_SURFACES}; failed: {failed}"
                                  if failed else f"n={N_SURFACES}; all ok")

    P.run("other_surfaces", surfaces)
    P.run("cli_in_process", cli_in_process)
    P.run("trace_headline", trace)
    return P.failed


def run_four(n_per_card: int) -> list:
    """The distributed sorts on a 4-device mesh; returns failed phases."""
    import jax
    import jax.numpy as jnp

    from radix_sorting.parallel import (
        distributed_argsort, distributed_sort_balanced, distributed_sort_pairs,
        distributed_sort_u32, gather_sorted, make_sort_mesh)

    P = Phases()
    mesh = make_sort_mesh(4)
    n = 4 * n_per_card
    k0, k1 = jax.random.split(jax.random.PRNGKey(SEED))
    x = jax.random.bits(k0, (n,), jnp.uint32)
    xh = np.asarray(x)
    want = np.sort(xh)

    def balanced(overlap):
        def phase():
            (sp, c, o), ms = _warm(lambda a: distributed_sort_balanced(
                a, mesh, overlap=overlap), x)
            return np.array_equal(gather_sorted(sp, c, o), want), ms, ""
        return phase

    def shuffle():
        (sp, c, o), ms = _warm(lambda a: distributed_sort_u32(a, mesh), x)
        return np.array_equal(gather_sorted(sp, c, o), want), ms, ""

    def shuffle_skew():
        # half the keys equal: one top-digit bucket exceeds a peer's capacity
        xs = jnp.where(jnp.arange(n) % 2 == 0, jnp.uint32(7), x)
        _, _, o = _block(distributed_sort_u32(xs, mesh))
        flagged = int(np.asarray(o)[0]) != 0
        (sp, c, o2), ms = _warm(
            lambda a: distributed_sort_u32(a, mesh, exact=True), xs)
        ok = flagged and np.array_equal(gather_sorted(sp, c, o2),
                                        np.sort(np.asarray(xs)))
        return ok, ms, f"overflow flagged={flagged}; exact=True warm_ms shown"

    def argsort():
        keys = x >> np.uint32(8)
        (sv, perm, c, o), ms = _warm(lambda a: distributed_argsort(a, mesh),
                                     keys)
        kh = np.asarray(keys)
        order = np.argsort(kh, kind="stable").astype(np.uint32)
        ok = (np.array_equal(gather_sorted(perm, c, o), order)
              and np.array_equal(gather_sorted(sv, c, o), kh[order]))
        return ok, ms, ""

    def pairs():
        keys = x >> np.uint32(8)
        pay = jax.random.bits(k1, (n,), jnp.uint32)
        (sk, sv, c, o), ms = _warm(
            lambda a, p: distributed_sort_pairs(a, p, mesh), keys, pay)
        kh = np.asarray(keys)
        order = np.argsort(kh, kind="stable")
        ok = (np.array_equal(gather_sorted(sk, c, o), kh[order])
              and np.array_equal(gather_sorted(sv, c, o),
                                 np.asarray(pay)[order]))
        return ok, ms, ""

    print(f"mesh: {mesh.shape} over {[d.id for d in mesh.devices.flat]}; "
          f"{n_per_card} keys per card", flush=True)
    P.run("balanced_overlap_false", balanced(False))
    P.run("balanced_overlap_true", balanced(True))
    P.run("shuffle_u32", shuffle)
    P.run("shuffle_skew_overflow_then_exact", shuffle_skew)
    P.run("argsort", argsort)
    P.run("sort_pairs", pairs)
    return P.failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed sorts on a 4-card mesh")
    args = ap.parse_args(argv)

    from radix_sorting.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    import jax

    from radix_sorting.utils.gpu import NoGPUError, card_name_power, \
        require_gpu

    try:
        dev = require_gpu()
        card = card_name_power()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    count = len(jax.devices())
    print(f"nvidia-smi: {card}")
    print(f"jax device_kind: {dev.device_kind}; devices: {count}; "
          f"jax {jax.__version__}", flush=True)
    if args.four:
        if count < 4:
            print(f"chip_smoke --four: needs 4 devices, found {count}",
                  file=sys.stderr)
            print(json.dumps({"ok": False, "error": "fewer than 4 devices"}))
            return 1
        failed = run_four(N_PER_CARD)
    else:
        failed = run_single(N)
    ok = not failed
    if failed:
        print(f"failed phases: {failed}", flush=True)
    print(json.dumps({"ok": ok, "device": {"platform": dev.platform,
                                           "kind": dev.device_kind,
                                           "count": count}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
