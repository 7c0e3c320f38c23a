"""What a run of benchmarks/run.py loads: whole runs of every cell on the
CPU (the harness's look for a card skipped) load no module whose top-level
name is jax, jaxlib, flax or rxmd_tpu; the reference loads nothing of the
port."""
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

RUN = r"""
import importlib.util, json, sys
sys.path[:0] = [{bench!r}, {tests!r}]
spec = importlib.util.spec_from_file_location("run", {run!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
import bench_small
from harness import spec
for w in spec.benchmark()["workloads"]:
    cell = bench_small.small_cell(w["name"])
    run.run_cell(cell, 4000000007, 0.5, False, bench_small.CPU)
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""

REF = r"""
import json, sys
sys.path.insert(0, {bench!r})
import numpy as np
from reference import evaluate
ff, pos, types, H = evaluate.load_deck({bench!r} + "/data/chon168.xyz",
                                       {bench!r} + "/data/ffield_chon_synth",
                                       (1, 1, 1))
evaluate.Evaluator(ff, types, H).evaluate(pos)
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN.format(bench=BENCH, tests=os.path.join(BENCH, "tests"),
                              run=os.path.join(BENCH, "run.py")))
    assert "rxmd_tpu_torch" in names and "reference" in names
    assert not names & {"jax", "jaxlib", "flax", "rxmd_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    names = loaded(REF.format(bench=BENCH))
    assert "reference" in names
    assert not names & {"rxmd_tpu_torch", "rxmd_tpu", "jax", "jaxlib",
                        "flax", "harness"}
