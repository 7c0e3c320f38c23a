"""A short run of a cell on the card: the result line's keys, the device,
`correct`, and the checks last (skips without a card: the decision is made
in the fixture)."""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "rdx_qeq_8k_ell.md_exl", "--seed", "6000000013", "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "breakdown" in line
