"""Helpers of the benchmark's CPU tests: a cell cut to a deck that a test
run holds, run through the harness on the CPU (the port's plain versions
of its kernels; no chip)."""
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

import torch  # noqa: E402

from harness import judge, runs, spec  # noqa: E402

CPU = torch.device("cpu")


def small_cell(name, mc=(1, 1, 1)):
    """The cell `name` on the CHON cell replicated `mc`, with a warm-up,
    chunks and a traced sub-window that a CPU run holds."""
    cell = spec.cell(name)
    cell.config["deck"]["replicate"] = list(mc)
    cell.traffic.update(warmup_steps=20, chunk_steps=10, trace_steps=10)
    return cell


def run(cell, seed, seconds=1.0, control=False):
    """(correct, numbers, control numbers) of one run on the CPU."""
    r = runs.KINDS[cell.traffic["kind"]](cell, seed, seconds, False, CPU,
                                         time.perf_counter())
    nums, ctl = runs.check(r, CPU, control=control)
    return judge.verdict(nums, cell.limits)[0], nums, ctl
