"""Multi-controller (multi-process) harness utilities.

One copy of the CPU/gloo multi-process launch recipe shared by
``bench_scaling.py --processes``, ``tests/test_multiprocess.py`` and
``scripts/mp_worker.py``, so a worker-contract change lands in one place.

The contract a cluster launcher (srun, mpirun) also follows:

* the coordinator address is a free localhost port in simulation;
* workers run the CPU platform with a forced host-device count — which MUST
  land in ``XLA_FLAGS`` before jax is first imported;
* each worker calls :func:`jax.distributed.initialize` with its
  (process_id, num_processes, coordinator) triple.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

__all__ = ["free_port", "worker_env", "ensure_host_device_count",
           "init_worker"]


def free_port() -> int:
    """An OS-assigned free TCP port on localhost (the sim coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(local_devices: Optional[int] = None,
               extra: Optional[dict] = None) -> dict:
    """Scrubbed environment for a spawned CPU worker process.

    Forces ``JAX_PLATFORMS=cpu`` (an inherited platform would put every
    worker on the accelerator; the old per-site copies kept the ambient
    value). Launchers of accelerator workers pass their platform and
    ``CUDA_VISIBLE_DEVICES`` via ``extra``. Also drops inherited
    ``XLA_FLAGS`` so the worker's own device-count flag governs.
    """
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    if local_devices is not None:
        env["RST_MP_LOCAL_DEVICES"] = str(local_devices)
    if extra:
        env.update(extra)
    return env


def ensure_host_device_count(n: int) -> None:
    """Force ``n`` virtual host-platform devices (BEFORE jax is imported)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()


def init_worker(process_id: int, num_processes: int, coordinator: str,
                local_devices: Optional[int] = None) -> None:
    """Worker-side setup: env, then ``jax.distributed.initialize``.

    Must run before any other jax-importing code in the worker.
    """
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if local_devices is not None:
        ensure_host_device_count(local_devices)
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
