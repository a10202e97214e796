"""CLI smoke tests (subprocess, CPU backend) — the integration tests,
exactly as the reference treats its `radix` binary (SURVEY §4)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(*args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "radix_sorting.cli", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    return out


@pytest.mark.parametrize("args", [
    ("20000", "u32"),
    ("20000", "u32", "0xFF000000"),
    ("20000", "0", "0", "i32"),
    ("10000", "f32"),
    ("10000", "u64"),
    ("10000", "u64", "0x0000F0F000000000"),  # 64-bit mask -> counting path
    ("10000", "i64", "0x800000000000FF00"),  # sign-bit-live 64-bit mask
])
def test_cli_verifies(args):
    out = _run_cli(*args)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["verified"] is True
    assert rec["n"] == int(args[0])


def test_cli_bad_type():
    out = _run_cli("100", "q7")
    assert out.returncode != 0
    assert "unknown type" in out.stderr


def test_cli_mmap_flag_native_read(capsys):
    # use_mmap=1 routes the host read through the native mmap loader
    # (provenance printed like `radix_experiment.cpp:59-69`); result identical
    from radix_sorting import cli
    assert cli.main(["5000", "1", "0", "u32"]) == 0
    out = capsys.readouterr().out
    assert "# allocation:" in out
