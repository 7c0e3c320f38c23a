#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmarks/calibrate.py --workload <cell> --seeds 12 \\
        --control 3 --seconds 3 [--first-seed N] [--out FILE]

For each of --seeds seeds (N, N+1, ...) one run of the cell at its own
sizes and load, with a window of --seconds (the benchmark's flow, from
harness/runs.py), and its numbers against the float64 reference: the
program's readings.  For the first --control seeds also the control's: the
same reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place.  Prints one JSON line
a seed (also to --out), then for each number the largest program reading
(the lower reading) and the smallest control reading (the upper reading).
A limit lies between the two (PERF.md gives both and the limit).  Needs a
CUDA card.
"""
import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=7_000_000_000)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [BENCH, os.path.dirname(BENCH)]
    import torch
    from harness import runs, spec
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    prog, ctl = [], []
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        r = runs.KINDS[cell.traffic["kind"]](cell, seed, args.seconds, False,
                                             device, t0)
        nums, cnums = runs.check(r, device, control=i < args.control)
        prog.append(nums)
        if cnums:
            ctl.append(cnums)
        line = json.dumps(dict(workload=cell.name, seed=seed, program=nums,
                               control=cnums, values=r["values"],
                               captures=r["art"]["captures"],
                               seconds=time.perf_counter() - t0))
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
        del r
        runs.free(device)
    for k in prog[0]:
        lo = max(n[k] for n in prog)
        hi = min(n[k] for n in ctl) if ctl else None
        print(f"{cell.name} {k}: lower (program, max of {len(prog)}) "
              f"{lo!r}; upper (control, min of {len(ctl)}) {hi!r}")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
