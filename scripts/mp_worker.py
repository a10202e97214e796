"""Multi-process (multi-controller) worker for the distributed sort surface.

Runs the distributed surfaces across N real processes with jax.distributed +
gloo CPU collectives — the structural stand-in for a multi-host cluster
(SURVEY §4's "multi-host testing") — catching single-controller assumptions:
non-addressable-shard reads, host materialization of global arrays, local-vs-
global shape confusion.

Each process: build its LOCAL slice of a seeded global input, assemble the
global array (`make_array_from_process_local_data`), run the surface on the
GLOBAL mesh, verify against the host oracle — reading only addressable or
replicated data. Prints "MP_OK <pid>" on success, exits nonzero on failure.

Launched by tests/test_multiprocess.py (RST_MULTIPROC=1) or by hand:
  python scripts/mp_worker.py <process_id> <num_processes> <port>
"""

import os
import sys


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    local_dev = int(os.environ.get("RST_MP_LOCAL_DEVICES", "4"))

    from radix_sorting.utils.mpharness import init_worker
    init_worker(pid, nproc, f"127.0.0.1:{port}", local_devices=local_dev)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from radix_sorting.parallel import (
        distributed_argsort_balanced_u32,
        distributed_select,
        distributed_sort_balanced_u32,
        distributed_sort_u32,
        distributed_unique_sorted,
    )

    D = len(jax.devices())
    assert D == nproc * local_dev, (D, nproc, local_dev)
    mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("shards",))
    sh = NamedSharding(mesh, P("shards"))

    def make_global(x_np):
        """Every process holds the SAME full oracle input; ship only the
        local slice to the runtime (the multi-controller contract)."""
        n = x_np.shape[0]
        assert n % nproc == 0
        lo = pid * (n // nproc)
        return jax.make_array_from_process_local_data(
            sh, x_np[lo: lo + n // nproc], (n,))

    def replicated_np(arr):
        """Host view of a global array via an explicit replication reshard —
        the only legal full-array read in multi-controller mode."""
        rep = jax.jit(lambda a: a,
                      out_shardings=NamedSharding(mesh, P()))(arr)
        return np.asarray(rep)

    rng = np.random.default_rng(0xD15C0)   # same seed on every process
    failures = []

    def check(name, ok):
        print(f"[{pid}] {name}: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)

    n = 1 << 17
    x_np = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    oracle = np.sort(x_np)
    xg = make_global(x_np)

    # 1) balanced sort, +/- overlap: static counts = ceil(n/D) per shard
    for overlap in (False, True):
        sp, counts, ovf = distributed_sort_balanced_u32(
            xg, mesh, overlap=overlap)
        c = replicated_np(counts)
        flat = replicated_np(sp).reshape(D, -1)
        got = np.concatenate([flat[d, : c[d]] for d in range(D)])
        check(f"balanced overlap={overlap}",
              np.array_equal(got, oracle) and int(replicated_np(ovf)[0]) == 0)

    # 2) the sharded-consumption pattern gather_sorted's docstring promises:
    #    each process verifies ONLY its addressable shards (global ranks
    #    [d*cap, d*cap + counts[d]) of the sorted sequence) — no host ever
    #    materializes the full result
    sp, counts, _ = distributed_sort_balanced_u32(xg, mesh)
    c = replicated_np(counts)
    cap = sp.shape[0] // D
    starts = np.concatenate([[0], np.cumsum(c)])
    ok = True
    seen = 0
    for shard in sp.addressable_shards:
        d = shard.index[0].start // cap
        rows = np.asarray(shard.data)[: c[d]]
        ok = ok and np.array_equal(rows, oracle[starts[d]: starts[d + 1]])
        seen += 1
    check("addressable-shard consumption", ok and seen == local_dev)

    # 3) shuffle path (single-collective exchange), uniform + skewed/exact
    sp, counts, ovf = distributed_sort_u32(xg, mesh)
    c = replicated_np(counts)
    flat = replicated_np(sp).reshape(D, -1)
    got = np.concatenate([flat[d, : c[d]] for d in range(D)])
    check("shuffle uniform",
          np.array_equal(got, oracle) and int(replicated_np(ovf)[0]) == 0)

    skew_np = np.concatenate([
        np.full(n // 2, 0x0000BEEF, np.uint32),
        rng.integers(0, 1 << 32, size=n // 2, dtype=np.uint32)])
    rng.shuffle(skew_np)
    sg = make_global(skew_np)
    sp, counts, ovf = distributed_sort_u32(sg, mesh, exact=True)
    c = replicated_np(counts)
    flat = replicated_np(sp).reshape(D, -1)
    got = np.concatenate([flat[d, : c[d]] for d in range(D)])
    check("shuffle skewed exact", np.array_equal(got, np.sort(skew_np)))

    # 4) balanced argsort: stable global permutation
    sk, perm, counts, _ = distributed_argsort_balanced_u32(xg, mesh)
    c = replicated_np(counts)
    pf = replicated_np(perm).reshape(D, -1)
    got_perm = np.concatenate([pf[d, : c[d]] for d in range(D)])
    check("balanced argsort",
          np.array_equal(got_perm, np.argsort(x_np, kind="stable")))

    # 5) exact selection: replicated output, O(bits) psums, no exchange
    ranks = [0, 1, n // 2, n - 1]
    sel = distributed_select(xg, ranks, mesh)
    check("select", np.array_equal(np.asarray(sel), oracle[ranks]))

    # 6) pod-scale uniques
    small_np = rng.integers(0, 5000, size=n, dtype=np.uint32)
    ug = make_global(small_np)
    vals, counts, _ = distributed_unique_sorted(ug, mesh)
    c = replicated_np(counts)
    vf = replicated_np(vals).reshape(D, -1)
    got = np.concatenate([vf[d, : c[d]] for d in range(D)])
    check("unique_sorted", np.array_equal(got, np.unique(small_np)))

    # 7) pod-scale group-by: edge-summary all_gather + carry scan across
    #    PROCESSES (the collective path a single controller cannot exercise)
    from radix_sorting.parallel import distributed_group_reduce
    gk = (small_np % 97).astype(np.uint32)
    gv = (small_np >> 5).astype(np.int32)
    uk, red, counts, _ = distributed_group_reduce(
        make_global(gk), make_global(gv), mesh, reduce="sum")
    c = replicated_np(counts)
    kf = replicated_np(uk).reshape(D, -1)
    rf = replicated_np(red).reshape(D, -1)
    got_k = np.concatenate([kf[d, : c[d]] for d in range(D)])
    got_r = np.concatenate([rf[d, : c[d]] for d in range(D)])
    uq, inv = np.unique(gk, return_inverse=True)
    want = np.zeros(len(uq), np.int64)
    np.add.at(want, inv, gv.astype(np.int64))
    check("group_reduce", np.array_equal(got_k, uq)
          and np.array_equal(got_r.astype(np.int64), want))

    # 8) pod-scale quantiles (selection psums across processes) and the
    #    dense global bincount (local histograms + one cross-process psum)
    from radix_sorting.parallel import (distributed_bincount,
                                            distributed_quantile)
    qv = np.asarray(distributed_quantile(xg, [0.25, 0.75], mesh,
                                         method="lower"))
    bc = np.asarray(distributed_bincount(ug, mesh, 5000))
    check("quantile+bincount",
          np.array_equal(qv, np.quantile(x_np, [0.25, 0.75],
                                         method="lower").astype(np.uint32))
          and np.array_equal(bc, np.bincount(small_np, minlength=5000)))

    # 9) pod-scale top-k: the all_gather of local top-k candidates crosses
    #    process boundaries here
    from radix_sorting.extras import top_k
    from radix_sorting.parallel import distributed_top_k
    tv, ti = distributed_top_k(xg, 32, mesh)
    rv, ri = top_k(jnp.asarray(x_np), 32)
    check("top_k", np.array_equal(np.asarray(tv), np.asarray(rv))
          and np.array_equal(np.asarray(ti), np.asarray(ri)))

    if failures:
        print(f"[{pid}] FAILURES: {failures}", flush=True)
        return 1
    print(f"MP_OK {pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
