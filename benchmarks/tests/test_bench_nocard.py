"""Without a card the benchmark fails and prints no result (it never falls
back to the CPU); so it does in a checkout that holds the benchmark alone;
and its check of loaded modules compares whole top-level names."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    CELL = json.load(_fh)["workloads"][0]["name"]
ARGS = ["--workload", CELL, "--seed", "3000000001", "--seconds", "1",
        "--trace", "0"]


def no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmarks/run.py", *ARGS],
                         cwd=ROOT, env=no_card_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmarks/run.py", *ARGS],
                         cwd=tmp_path, env=no_card_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def run_module():
    spec = importlib.util.spec_from_file_location(
        "bench_run_module", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_modules_by_whole_name(run_module, monkeypatch):
    for name in ("jax", "rxmd_tpu"):
        for m in [m for m in sys.modules if m.partition(".")[0] == name]:
            monkeypatch.delitem(sys.modules, m)
    assert run_module.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rxmd_tpu_torch.md", object())
    monkeypatch.setitem(sys.modules, "rxmd_tpu_x", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert run_module.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rxmd_tpu.md", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run_module.forbidden_modules() == ["jax", "rxmd_tpu"]
