"""Scaling-efficiency harness for the distributed sorts (BASELINE target #3).

Times the distributed exchange paths at D in {1,2,4,...} GPUs of one host and
emits keys/s, keys/s/device, and scaling efficiency vs D=1:

    python bench_scaling.py --n-per-device 33554432 --out report

2^25 keys per device is the per-device size of the four-card check in
``chip_smoke.py --four``. Every row names the card (platform, device kind and
count, ``nvidia-smi`` name and power limit). Off the GPU the script exits
nonzero before measuring.

Modes:
  * weak scaling (default): n = n_per_device * D; efficiency =
    keys/s/device at D over keys/s/device at D=1 (the BASELINE phrasing).
  * strong scaling (--strong): fixed n; efficiency = rate(D) / (D * rate(1)).
  * multi-controller (--processes N): relaunches itself as N coordinated
    processes on localhost, each pinned to its own card
    (``CUDA_VISIBLE_DEVICES``), and benches the GLOBAL mesh — the worker
    invocation a cluster launcher issues (pass
    --process-id/--num-processes/--coordinator yourself there). Several JAX
    processes that each see every card would each reserve most of every
    card's memory.

Methodology matches bench.py: the op loops inside one jit with a
multiplicative-scramble data dependence; timing closes with a host readback.
"""

from __future__ import annotations

import argparse
import datetime
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def steady_ms(fn, x, reps):
    import jax
    import jax.numpy as jnp
    from jax import lax

    def outer(a):
        def body(i, c):
            r = fn(c)
            # sharding-friendly full-output dependence (single-element slices
            # of sharded arrays are not implemented; a max reduce is, and
            # consumes every shard of the result)
            dep = jnp.max(r) & np.uint32(1)
            return c * np.uint32(2654435761) + dep
        return lax.fori_loop(0, reps, body, a)

    g = jax.jit(outer)
    np.asarray(jnp.max(g(x)))  # compile + warm; scalar readback syncs
    best = 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        r = g(x)
        np.asarray(jnp.max(r))
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e3


def _launch_processes(args, argv) -> int:
    """Multi-controller launcher: respawn this script as N coordinated
    processes on localhost, worker i pinned to card i — the same worker
    invocation a cluster launcher issues with its own coordinator address.
    The launcher itself never imports JAX, so it holds no card."""
    from radix_sorting.utils.gpu import NoGPUError, gpu_count
    from radix_sorting.utils.mpharness import free_port, worker_env

    try:
        cards = gpu_count()
    except NoGPUError as e:
        print(f"bench_scaling: {e}", file=sys.stderr)
        return 1
    if args.processes > cards:
        print(f"bench_scaling: --processes {args.processes} needs one card "
              f"per process, found {cards}", file=sys.stderr)
        return 1
    port = free_port()
    base, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--processes":
            skip = True          # drop the flag AND its value
        elif a.startswith("--processes="):
            pass
        else:
            base.append(a)
    procs = []
    for pid in range(args.processes):
        cmd = [sys.executable, __file__, *base,
               "--process-id", str(pid), "--num-processes",
               str(args.processes), "--coordinator", f"127.0.0.1:{port}"]
        env = worker_env(extra={"JAX_PLATFORMS": "cuda",
                                "CUDA_VISIBLE_DEVICES": str(pid)})
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=None if pid == 0 else subprocess.DEVNULL,
            stderr=None if pid == 0 else subprocess.DEVNULL))
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-per-device", type=int, default=1 << 25,
                    help="keys per device (weak scaling)")
    ap.add_argument("--strong", action="store_true",
                    help="fixed total n = n_per_device * max_D instead")
    ap.add_argument("--devices", default=None,
                    help="comma-separated D list (default 1,2,4,... up to "
                         "the device count)")
    ap.add_argument("--methods", default="balanced,overlap,shuffle",
                    help="comma list: balanced, overlap, shuffle")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="report directory")
    ap.add_argument("--processes", type=int, default=0,
                    help="launch N coordinated processes on localhost, one "
                         "card each, and run over the GLOBAL mesh")
    # worker-mode flags (a cluster launcher passes these directly)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args()

    if args.processes:
        return _launch_processes(args, sys.argv[1:])

    from radix_sorting.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()

    import jax

    if args.process_id is not None:
        jax.distributed.initialize(coordinator_address=args.coordinator,
                                   num_processes=args.num_processes,
                                   process_id=args.process_id)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radix_sorting.parallel import (
        distributed_sort_balanced_u32, distributed_sort_u32, make_sort_mesh)
    from radix_sorting.utils.gpu import NoGPUError, device_record

    try:
        device = device_record()
    except NoGPUError as e:
        print(f"bench_scaling: {e}", file=sys.stderr)
        return 1

    ndev = len(jax.devices())
    multiproc = args.process_id is not None
    pid0 = args.process_id in (None, 0)
    if multiproc and args.devices is None:
        # every process must drive the same (full) mesh; per-D baselines come
        # from separate launches
        args.devices = str(ndev)
    if args.devices:
        dlist = [int(d) for d in args.devices.split(",")]
    else:
        dlist, d = [], 1
        while d <= ndev:
            dlist.append(d)
            d *= 2
    max_d = max(dlist)
    rng = np.random.Generator(np.random.PCG64(0x5EED))

    methods = {}
    for name in args.methods.split(","):
        if name == "balanced":
            methods[name] = lambda x, mesh: distributed_sort_balanced_u32(
                x, mesh)[0]
        elif name == "overlap":
            methods[name] = lambda x, mesh: distributed_sort_balanced_u32(
                x, mesh, overlap=True)[0]
        elif name == "shuffle":
            methods[name] = lambda x, mesh: distributed_sort_u32(x, mesh)[0]
        else:
            raise SystemExit(f"unknown method {name!r}")

    rows = []
    base_rate_per_dev = {}
    for D in dlist:
        mesh = make_sort_mesh(D)
        n = args.n_per_device * (max_d if args.strong else D)
        n -= n % (D * D * (args.num_processes or 1))
        x_np = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        if multiproc:
            # multi-controller: each process ships only its local slice
            # (process-contiguous shards match the default device order)
            npr = args.num_processes
            lo = args.process_id * (n // npr)
            x = jax.make_array_from_process_local_data(
                NamedSharding(mesh, P("shards")),
                x_np[lo: lo + n // npr], (n,))
        else:
            x = jax.device_put(
                jnp.asarray(x_np), NamedSharding(mesh, P("shards")))
        for name, fn in methods.items():
            ms = steady_ms(lambda c, _f=fn, _m=mesh: _f(c, _m), x, args.reps)
            rate = n / (ms / 1e3)
            per_dev = rate / D
            if D == dlist[0]:
                base_rate_per_dev[name] = per_dev
            if args.strong:
                eff = rate / (D * base_rate_per_dev[name] * dlist[0])
            else:
                eff = per_dev / base_rate_per_dev[name]
            rows.append({
                "method": name, "D": D, "n": n, "ms": round(ms, 3),
                "Mkeys_per_s": round(rate / 1e6, 1),
                "Mkeys_per_s_per_device": round(per_dev / 1e6, 1),
                "efficiency": round(eff, 3), "device": device,
                **({"processes": args.num_processes} if multiproc else {}),
            })
            if pid0:
                print(json.dumps(rows[-1]), flush=True)

    if args.out and not pid0:
        args.out = None  # only process 0 writes the report
    if args.out:
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True).stdout.strip() or "nogit"
        dev = device["kind"].replace(" ", "-")
        stamp = datetime.date.today().isoformat()
        path = outdir / f"scaling-{dev}-x{ndev}-{stamp}-{sha}.json"
        path.write_text(json.dumps({
            "uname": platform.uname()._asdict(),
            "sha": sha,
            "device": device,
            "jax": jax.__version__,
            "mode": "strong" if args.strong else "weak",
            "n_per_device": args.n_per_device,
            "rows": rows,
        }, indent=2))
        print(f"# wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
