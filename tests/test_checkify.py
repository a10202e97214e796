"""Sanitizer-analog pass: checkify NaN/OOB/div checks over the hot paths.

The reference offers an opt-in valgrind wrapper — ``MEMCHECK=1 make test``
(`Makefile:14-16` of the reference) — as its memory-safety net. The JAX
equivalent (SURVEY §5 race-detection row): run the engines at small sizes
under `jax.experimental.checkify` with the full error set, so every traced
gather/scatter index is bounds-checked and every float op is NaN/Inf-checked.
Cheap (tiny inputs), always on in CI.

Notes:
* `float_checks` flags *generated* NaN/Inf. Float KDF paths legitimately
  CARRY NaN payloads through bitcasts (never arithmetic), so float inputs
  here include specials to prove the pipelines don't trip the checker.
* checkify instruments what it can under jit; index_checks is the load-
  bearing part for a sort library (every engine is gather/dynamic-slice
  heavy).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import checkify

import radix_sorting as rst

CHECKS = checkify.index_checks | checkify.float_checks | checkify.div_checks

def _run_checked(fn, *args):
    """checkify + jit the callable, assert no error fired, return the value."""
    err, out = jax.jit(checkify.checkify(fn, errors=CHECKS))(*args)
    err.throw()
    return out


def test_checkify_sort_all_dtypes(rng):
    n = 2048
    for dtype in (np.uint8, np.uint16, np.uint32, np.int32, np.float32):
        x = rng.integers(0, 1 << 16, size=n).astype(dtype)
        out = _run_checked(rst.sort, jnp.asarray(x))
        assert np.array_equal(np.asarray(out), np.sort(x))


def test_checkify_sort_float_specials(rng):
    # KDF total order: -inf < -2.5 < -0.0 < +0.0 < 1.5 < inf < nan
    x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.5] * 64,
                 np.float32)
    out = np.asarray(_run_checked(rst.sort, jnp.asarray(x)))
    expect = np.repeat(
        np.array([-np.inf, -2.5, -0.0, 0.0, 1.5, np.inf, np.nan], np.float32),
        64)
    assert np.array_equal(out.view(np.uint32), expect.view(np.uint32))


def test_checkify_argsort_and_pairs(rng):
    n = 1024
    x = rng.integers(0, 64, size=n, dtype=np.uint32)  # heavy ties
    perm = np.asarray(_run_checked(rst.argsort, jnp.asarray(x)))
    assert np.array_equal(perm, np.argsort(x, kind="stable"))
    payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    sk, pl = _run_checked(rst.sort_pairs, jnp.asarray(x), jnp.asarray(payload))
    order = np.argsort(x, kind="stable")
    assert np.array_equal(np.asarray(sk), x[order])
    assert np.array_equal(np.asarray(pl), payload[order])


def test_checkify_counting_and_masked(rng):
    n = 4096
    x = rng.integers(0, 256, size=n).astype(np.uint8)
    out = np.asarray(_run_checked(rst.sort, jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))
    xm = rng.integers(0, 1 << 32, size=n, dtype=np.uint32) & np.uint32(0xF0F00000)
    out = np.asarray(_run_checked(
        lambda a: rst.sort(a, value_mask=0xF0F00000), jnp.asarray(xm)))
    assert np.array_equal(out, np.sort(xm))


def test_checkify_lsd_engine(rng):
    # the scatter-form engine is the gather-heaviest path: index_checks
    # covers its per-pass permutation arithmetic
    from radix_sorting.config import SortConfig, Strategy
    n = 1024
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    cfg = SortConfig(strategy=Strategy.LSD)
    out = np.asarray(_run_checked(
        lambda a: rst.sort(a, config=cfg), jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))


def test_checkify_extras(rng):
    from radix_sorting import extras
    n = 512
    x = rng.integers(0, 32, size=n, dtype=np.uint32)
    vals, count = _run_checked(lambda a: extras.unique_sorted(a), jnp.asarray(x))
    k = int(count)
    assert np.array_equal(np.asarray(vals)[:k], np.unique(x))
    topv, topi = _run_checked(lambda a: extras.top_k(a, 7), jnp.asarray(x))
    assert np.array_equal(np.asarray(topv), np.sort(x)[::-1][:7])


def test_checkify_batched_and_segmented(rng):
    # (checkify's error-state gather does not compose with shard_map's
    # sharded outputs, so the distributed paths are exercised by their own
    # suites; like the reference's MEMCHECK, this pass covers the
    # single-device engines.)
    from radix_sorting import extras
    x = rng.integers(0, 1 << 32, size=(16, 256), dtype=np.uint32)
    out = np.asarray(_run_checked(lambda a: rst.sort_batched(a, axis=1),
                                  jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x, axis=1))
    seg = np.repeat(np.arange(8, dtype=np.int32), 64)
    v = rng.integers(0, 1 << 32, size=512, dtype=np.uint32)
    sv, sids = _run_checked(
        lambda a, s: extras.segmented_sort(a, s), jnp.asarray(v),
        jnp.asarray(seg))
    expect = np.concatenate([np.sort(v[seg == i]) for i in range(8)])
    assert np.array_equal(np.asarray(sv), expect)
    assert np.array_equal(np.asarray(sids), seg)
