"""Two-process multi-controller validation (opt-in: RST_MULTIPROC=1).

The distributed layer's cross-host assumptions — jax.distributed init, gloo
CPU collectives, addressable-shard consumption, no single-controller reads —
executed across REAL processes. Gated like the soak (subprocess
launcher; ~1-2 min) so the default suite stays fast:

  RST_MULTIPROC=1 python -m pytest tests/test_multiprocess.py -q
"""

import os
import subprocess
import sys

import pytest

from radix_sorting.utils.mpharness import free_port, worker_env

pytestmark = pytest.mark.skipif(
    os.environ.get("RST_MULTIPROC") != "1",
    reason="multi-process validation is opt-in (set RST_MULTIPROC=1)",
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(nproc: int, local_devices: int, timeout: int = 600):
    port = free_port()
    env = worker_env(local_devices=local_devices, extra={
        "PYTHONPATH": _REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    })
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_REPO, "scripts", "mp_worker.py"),
             str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_REPO)
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return procs, outs


@pytest.mark.parametrize("nproc,local_devices", [(2, 4), (4, 2)])
def test_multiprocess_distributed_surface(nproc, local_devices):
    procs, outs = _launch(nproc, local_devices)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MP_OK {pid}" in out, f"worker {pid} output:\n{out[-4000:]}"
