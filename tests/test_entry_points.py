"""The GPU-only entry points refuse the CPU, and the trace reduction reads
GPU device planes.

``chip_smoke.py``, ``bench.py``, ``bench_suite.py`` and ``bench_scaling.py``
measure the card: here (CPU only) each must exit nonzero before measuring,
and the ones that print a JSON line print ``"ok": false``.
``utils.timing.device_op_table`` is checked on small synthetic perfetto
traces laid out the way ``jax.profiler`` writes a GPU trace.
"""

import gzip
import json
import os
import shutil
import subprocess
import sys

import pytest

from radix_sorting.utils import gpu, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, env_extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"],
                                  ["bench.py"]])
def test_json_entry_points_refuse_cpu(args):
    p = _run(args)
    assert p.returncode != 0
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and "GPU" in last["error"]
    assert "phase" not in p.stdout          # no phase ran


@pytest.mark.parametrize("args", [["bench_suite.py", "--quick"],
                                  ["bench_scaling.py"]])
def test_bench_scripts_refuse_cpu(args):
    p = _run(args)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_require_gpu_raises_on_cpu():
    with pytest.raises(gpu.NoGPUError, match="needs a GPU"):
        gpu.require_gpu()
    with pytest.raises(gpu.NoGPUError):
        gpu.device_record()


def test_card_query_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(gpu.NoGPUError, match="nvidia-smi"):
        gpu.card_name_power()
    with pytest.raises(gpu.NoGPUError):
        gpu.gpu_count()


# ---------------------------------------------------------------------------
# device_op_table on synthetic GPU-layout traces


def _write_trace(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "perfetto_trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _meta(pid, pname, threads):
    ev = [{"ph": "M", "name": "process_name", "pid": pid,
           "args": {"name": pname}}]
    ev += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": tname}} for tid, tname in threads.items()]
    return ev


def _op(pid, tid, name, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": 0,
            "dur": dur}


def test_device_op_table_xla_ops_thread(tmp_path):
    ev = (_meta(1, "/host:CPU", {10: "python"})
          + _meta(2, "/device:GPU:0", {20: "XLA Ops", 21: "Stream #13"})
          + _meta(3, "/device:GPU:1", {30: "XLA Ops"}))
    ev += [_op(1, 10, "host_work", 999.0),          # host: ignored
           _op(2, 20, "sort.1", 100.0), _op(2, 20, "sort.1", 50.0),
           _op(2, 20, "fusion.2", 30.0),
           _op(2, 21, "cub_kernel", 140.0),          # same time, other line
           _op(3, 30, "sort.1", 25.0)]
    rows = timing.device_op_table(_write_trace(tmp_path, ev))
    assert rows == [{"op": "sort.1", "total_us": 175.0, "calls": 3},
                    {"op": "fusion.2", "total_us": 30.0, "calls": 1}]


def test_device_op_table_stream_threads(tmp_path):
    # no "XLA Ops" line: kernels on the stream lines are the ops
    ev = (_meta(2, "/device:GPU:0", {21: "Stream #13(Compute)",
                                    22: "Stream #14(MemcpyD2D)",
                                    23: "Launch Stats"}))
    ev += [_op(2, 21, "DeviceRadixSortOnesweepKernel", 800.0),
           _op(2, 22, "MemcpyD2D", 109.0),
           _op(2, 23, "not_an_op", 5.0)]
    rows = timing.device_op_table(_write_trace(tmp_path, ev))
    assert [r["op"] for r in rows] == ["DeviceRadixSortOnesweepKernel",
                                       "MemcpyD2D"]


def test_device_op_table_no_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        timing.device_op_table(str(tmp_path))
