"""D=16 virtual-mesh case.

The default suite runs on an 8-device mesh (conftest); shape logic at D > 8
— the balanced path's per-round chunk shapes, the shuffle splitter
assignment — was otherwise untested. One
subprocess with its own 16-device XLA host platform covers the property
tests that depend on D; everything else is D-independent algebra already
covered at D=8.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import numpy as np
import jax.numpy as jnp
from radix_sorting.parallel import (distributed_sort_balanced_u32,
                                        distributed_sort_u32, gather_sorted,
                                        make_sort_mesh)
mesh = make_sort_mesh(16)
rng = np.random.Generator(np.random.PCG64(16))
n = (1 << 13) + 311  # ragged over 16 shards
x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
xs = np.concatenate([np.full(n // 2, 0xBEEF, np.uint32), x[n // 2:]])  # skew
for name, (fn, arg, kw) in {
    "shuffle": (distributed_sort_u32, x, {}),
    "balanced-skew": (distributed_sort_balanced_u32, xs, {}),
    "balanced-overlap": (distributed_sort_balanced_u32, xs,
                         {"overlap": True}),
    "balanced-multiround": (distributed_sort_balanced_u32, x,
                            {"chunk": 64}),
}.items():
    sp, counts, ovf = fn(jnp.asarray(arg), mesh, **kw)
    out = gather_sorted(sp, counts, ovf)
    assert np.array_equal(out, np.sort(arg)), name
    print("ok", name, flush=True)
print("MESH16_OK")
"""


def test_distributed_paths_on_16_device_mesh():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=16",
        "PYTHONPATH": _REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    p = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=_REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0 and "MESH16_OK" in p.stdout, (
        f"stdout:\n{p.stdout[-4000:]}\nstderr:\n{p.stderr[-4000:]}")
