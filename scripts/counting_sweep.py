"""Counting-tier sweep on the GPU: which keys-only formulation wins, and where.

For a dense domain ``c < bins`` of ``n`` u32 keys, times on the card:

  (a) ``lax.sort`` — the library sort XLA picks;
  (b) the blocked n x bins compare form (one-hot compare-reduce histogram,
      compare-reduce regeneration) — run only up to 2^10 bins, since it costs
      O(n * bins) compares;
  (c) scatter-add histogram (``jnp.bincount``) then
      ``jnp.repeat(arange(bins), hist, total_repeat_length=n)``;

and, beside (b) and (c), each one's histogram alone. A last row times the
whole masked counting pipeline (PEXT, histogram, regeneration, PDEP) for
``value_mask=0xF0F00000`` against ``lax.sort`` of the same keys, jitted, and
the public ``rst.sort(x, value_mask=...)`` call as a user makes it, jitted
and not. Each entry is the median of ``--reps``
warm calls closed by ``block_until_ready``. Every result is checked against
``np.sort`` on the first call. Prints one JSON line per bin count and writes
them all to ``--out``.

    python scripts/counting_sweep.py [--n 40000000] [--reps 7] [--out FILE]

Refuses to run off the GPU: a CPU time is not a device number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np


def regenerate(hist, n: int):
    """Sorted keys from a histogram: ``b`` repeated ``hist[b]`` times."""
    import jax.numpy as jnp

    bins = int(hist.shape[0])
    return jnp.repeat(jnp.arange(bins, dtype=jnp.uint32), hist,
                      total_repeat_length=n)


def _median_ms(fn, x, reps):
    fn(x).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(x).block_until_ready()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=40_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--min-bits", type=int, default=4)
    ap.add_argument("--max-bits", type=int, default=17)
    ap.add_argument("--out", default="chiprun_out/counting_sweep.jsonl")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from jax import lax

    from radix_sorting.utils.gpu import NoGPUError, device_record

    try:
        device = device_record()
    except NoGPUError as e:
        print(f"counting_sweep: {e}", file=sys.stderr)
        return 1
    card = device["nvidia_smi"]
    print(f"card: {card}; device_kind: {device['kind']}")

    n = args.n
    raw = jax.jit(lambda: jax.random.bits(jax.random.PRNGKey(7), (n,),
                                          jnp.uint32))()

    block = 1 << 20
    nb = -(-n // block)

    def onehot_hist(c, bins):
        # blocked one-hot compare-reduce: a (block, bins) compare per block
        binv = jnp.arange(bins, dtype=jnp.uint32)
        cpad = jnp.concatenate(
            [c, jnp.full((nb * block - n,), bins, jnp.uint32)])

        def body(i, acc):
            chunk = lax.dynamic_slice(cpad, (i * block,), (block,))
            return acc + jnp.sum((chunk[:, None] == binv[None, :])
                                 .astype(jnp.int32), axis=0, dtype=jnp.int32)

        return lax.fori_loop(0, nb, body, jnp.zeros((bins,), jnp.int32))

    def compare_form(c, bins):
        cum = jnp.cumsum(onehot_hist(c, bins), dtype=jnp.int32)

        def regen(jblk):
            return jnp.sum((cum[None, :] <= jblk[:, None]).astype(jnp.uint32),
                           axis=1, dtype=jnp.uint32)

        jpad = jnp.arange(nb * block, dtype=jnp.int32)
        return lax.map(regen, jpad.reshape(nb, block)).reshape(-1)[:n]

    rows = []
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for bits in range(args.min_bits, args.max_bits + 1):
        bins = 1 << bits
        c = jax.jit(lambda r: r & np.uint32(bins - 1))(raw)
        want = np.sort(np.asarray(c))
        cands = {
            "a_lax_sort": jax.jit(lambda v: lax.sort(
                (v,), dimension=0, is_stable=False, num_keys=1)[0]),
            "c_bincount_repeat": jax.jit(
                lambda v: regenerate(jnp.bincount(v, length=bins), n)),
        }
        if bits <= 10:
            cands["b_compare"] = jax.jit(lambda v: compare_form(v, bins))
            cands["b_hist_only"] = jax.jit(lambda v: onehot_hist(v, bins))
        row = {"bins": bins, "n": n, "card": card}
        want_hist = np.bincount(np.asarray(c), minlength=bins)
        for name, fn in cands.items():
            ref = want_hist if name.endswith("hist_only") else want
            try:
                ok = bool(np.array_equal(np.asarray(fn(c)), ref))
                row[name + "_ms"] = _median_ms(fn, c, args.reps)
            except Exception as e:  # a candidate that does not compile
                ok = False
                row[name + "_error"] = f"{type(e).__name__}: {e}"[:300]
            row[name + "_ok"] = ok
        hist_c = jax.jit(lambda v: jnp.bincount(v, length=bins))
        row["c_hist_only_ok"] = bool(np.array_equal(np.asarray(hist_c(c)),
                                                    want_hist))
        row["c_hist_only_ms"] = _median_ms(hist_c, c, args.reps)
        print(json.dumps(row), flush=True)
        rows.append(row)
    rows.append(_masked_row(raw, card, args.reps))
    print(json.dumps(rows[-1]), flush=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    bad = [r["bins"] for r in rows
           if not all(v for k, v in r.items() if k.endswith("_ok"))]
    if bad:
        print(f"counting_sweep: wrong results at bins {bad}", file=sys.stderr)
        return 1
    return 0


def _masked_row(raw, card, reps):
    """The whole masked counting path against ``lax.sort`` of the keys."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import radix_sorting as rst
    from radix_sorting.ops import probes

    mask = 0xF0F00000
    n = int(raw.shape[0])
    xm = jax.jit(lambda r: r & np.uint32(mask))(raw)
    want = np.sort(np.asarray(xm))

    def counting(v):
        c = probes.compact_word_planes((v,), (mask,))
        s = regenerate(jnp.bincount(c, length=256), n)
        return probes.expand_word_planes(s, (v,), (mask,))[0]

    cands = {
        "a_lax_sort": jax.jit(lambda v: lax.sort(
            (v,), dimension=0, is_stable=False, num_keys=1)[0]),
        "c_counting_bincount": jax.jit(counting),
        "public_jit": jax.jit(lambda v: rst.sort(v, value_mask=mask)),
        "public_eager": lambda v: rst.sort(v, value_mask=mask),
    }
    row = {"masked": f"0x{mask:08X}", "n": n, "card": card}
    for name, fn in cands.items():
        try:
            row[name + "_ok"] = bool(np.array_equal(np.asarray(fn(xm)), want))
            row[name + "_ms"] = _median_ms(fn, xm, reps)
        except Exception as e:  # a candidate that does not compile
            row[name + "_ok"] = False
            row[name + "_error"] = f"{type(e).__name__}: {e}"[:300]
    return row


if __name__ == "__main__":
    sys.exit(main())
