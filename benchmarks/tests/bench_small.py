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


def sharded_cell(mesh=(2, 2, 1), mc=(4, 4, 2), dtype="float32",
                 qeq_tol=None):
    """A test cell of the kind md_sharded: md_exl's configuration, mix and
    limits on the CHON cell replicated `mc` over `mesh`, one rank a
    domain, with a warm-up, chunks and a traced sub-window of two steps;
    in `dtype` (float64 on the reference's closed-form nonbond), the QEq
    CG to `qeq_tol` where given."""
    cell = small_cell("rdx_qeq_8k_ell.md_exl", mc)
    cell.name = "rdx_qeq_test.md_exl_sharded"
    cell.config["mesh"] = list(mesh)
    cell.config["run_config"].update(dtype=dtype, nonbond_closed_form=True)
    if qeq_tol is not None:
        cell.config["run_config"]["QEq_tol"] = qeq_tol
    cell.chips = mesh[0] * mesh[1] * mesh[2]
    cell.traffic = spec.load_json(os.path.join(BENCH, "traffic",
                                               "md_exl_sharded.json"))
    cell.traffic.update(warmup_steps=2, chunk_steps=2, trace_steps=2)
    return cell


def run(cell, seed, seconds=1.0, control=False):
    """(correct, numbers, control numbers) of one run on the CPU."""
    r = runs.KINDS[cell.traffic["kind"]](cell, seed, seconds, False, CPU,
                                         time.perf_counter())
    nums, ctl = runs.check(r, CPU, control=control)
    return judge.verdict(nums, cell.limits)[0], nums, ctl
