#!/usr/bin/env python3
"""A run of the md_sharded test cell on the CPU (bench_small.sharded_cell),
as benchmarks/run.py runs a cell on several cards: without the launch's
variables this process is the launcher and starts one rank per domain, each
running this script again (gloo, no card).  A mesh of one domain runs in
this process.

    python3 benchmarks/tests/sharded_rank.py --seed N [--mesh 2,2,1]
        [--dtype float32|float64] [--qeq-tol T] [--fault raise|kill|hang]
        [--allowance S] [--dump PATH]

--fault plants a fault in rank 1: it raises, or kills itself, as its
window starts (after the warm-up), or it hangs before joining the group.
--dump has rank 0 pickle what it checked: the gathered snapshots, the
ranks' artifacts, the numbers and the control's (the reference in
bfloat16).  --allowance sets the launcher's set-up allowance [s].
"""
import argparse
import importlib.util
import os
import pickle
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_small  # noqa: E402

import torch  # noqa: E402

from harness import drive, launch, runs  # noqa: E402

THREADS = 2         # a rank's: ranks share the test machine's cores


def load_run():
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(bench_small.BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plant(fault):
    """The fault in rank 1's window (hang: at once)."""
    if fault == "hang":
        time.sleep(3600)
    orig = drive.md_window

    def window(*a, **k):
        if fault == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if fault == "raise":
            raise RuntimeError("a fault planted in rank 1")
        return orig(*a, **k)
    drive.md_window = window


def dump_checks(path):
    """runs.check, also pickling its inputs and numbers, with the
    control's, to `path`."""
    orig = runs.check

    def check(r, device, control=False):
        nums, ctl = orig(r, device, control=True)
        with open(path, "wb") as fh:
            pickle.dump(dict(snaps=r["snaps"], values=r["values"],
                             ranks=r["art"]["ranks"], numbers=nums,
                             control=ctl, H=r["inputs"].H), fh)
        return nums, ctl
    runs.check = check


def main():
    if launch.is_rank():
        launch.die_with_launcher()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--mesh", default="2,2,1")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--qeq-tol", type=float)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--fault", choices=("raise", "kill", "hang"))
    p.add_argument("--allowance", type=float, default=900.0)
    p.add_argument("--dump")
    args = p.parse_args()
    mesh = tuple(int(k) for k in args.mesh.split(","))
    torch.set_num_threads(THREADS if mesh != (1, 1, 1) else 2 * THREADS)
    cell = bench_small.sharded_cell(
        mesh, dtype=args.dtype, qeq_tol=args.qeq_tol)
    launch.SETUP_ALLOWANCE_S = args.allowance
    if args.fault and os.environ.get("RXMD_PROCESS_ID") == "1":
        plant(args.fault)
    if args.dump and os.environ.get("RXMD_PROCESS_ID", "0") == "0":
        dump_checks(args.dump)
    run = load_run()
    ns = argparse.Namespace(seed=args.seed, seconds=args.seconds, trace=0)
    return run.serve(cell, ns, [sys.executable, os.path.abspath(__file__),
                                *sys.argv[1:]], device="cpu")


if __name__ == "__main__":
    sys.exit(main())
