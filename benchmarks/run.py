#!/usr/bin/env python3
"""The benchmark of rxmd_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell's inputs from the seed (harness/deck.py), sets the port up
and warms it until its programs are captured (setup_s: from this process's
start to the window's), drives the window for --seconds on the port's own
entry points (harness/drive.py), then checks what the window produced
against the plain reference (harness/judge.py, reference/), and prints, as
its last line, one JSON object: correct, attempted, failed, metrics,
device, with --trace 1 breakdown, setup_parts (the set-up's seconds by
part: imports, inputs, CUDA context, engine, warm-up), and last the
checks, each number beside its limit (also the last lines on standard
error).  --trace 0 reports the cell's end-to-end metrics; --trace 1 its
per-layer metrics, read by metrics/<name>.py from a run with its host
reads counted and a profiled sub-window after the window.

A cell on more than one card runs as one process per card (harness/
launch.py): this process starts them as ranks of one process group, each
runs the cell's kind on its own card (harness/sharded.py), and rank 0
checks the gathered result and prints the line, which this process prints
as its own once every rank has exited 0 (`device.count` the cell's cards,
`memory_peak_bytes` the fullest card's, `busy_s` and `window_s` rank 0's,
each rank's under `device.ranks`).  A rank that fails, or a group not done
by the deadline (--seconds plus a set-up allowance), ends the run: every
rank is killed, no result is printed, the exit code is not 0.

It needs a CUDA card (as many as the cell asks): without one it exits with
code 2 and prints no result; it never falls back to the CPU.  It exits with
code 3 and prints no result if jax, jaxlib, flax or rxmd_tpu (the JAX
package; compared by whole top-level module names) is loaded once the
window has closed, in any of its processes.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "rxmd_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def _metrics(cell, values, art=None):
    """The cell's end-to-end metrics from `values`, or (with `art`) its
    per-layer metrics, each read by its own reader; a reader that finds
    nothing leaves its metric out."""
    from harness import spec
    out = {}
    if art is None:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = spec.reader(m["name"])(art)
        if v is None:
            continue
        extra = {}
        if isinstance(v, tuple):
            v, extra = v
        out[m["name"]] = {"value": v, "unit": m["unit"], **extra}
    return out


def run_cell(cell, seed, seconds, trace, device, t0=T0):
    """One run of `cell` on `device`: the result line's dict, with its
    peak memory (`peak`), profile (`prof`), the ranks' devices (`ranks`,
    a cell on several cards) and, last, its `checks`; None on a rank
    other than 0.  `t0`: the run's start, from which set-up counts."""
    from harness import judge, runs
    r = runs.KINDS[cell.traffic["kind"]](cell, seed, seconds, trace, device,
                                         t0)
    if r is None:
        return None
    numbers, _ = runs.check(r, device)
    correct, checks = judge.verdict(numbers, cell.limits)
    out = dict(correct=correct, attempted=r["attempted"], failed=0,
               metrics=_metrics(cell, r["values"],
                                r["art"] if trace else None))
    if r["prof"] is not None:
        out["breakdown"] = {"device_ops": r["prof"]["device_ops"],
                            "idle_gaps": r["prof"]["idle_gaps"]}
    out["setup_parts"] = r["setup_parts"]
    out["peak"], out["prof"], out["ranks"] = r["peak"], r["prof"], \
        r.get("ranks")
    out["checks"] = checks
    return out


def clean():
    """Whether this process holds no forbidden module (else says which)."""
    bad = forbidden_modules()
    if bad:
        print("loaded in this process, which the benchmark forbids: "
              + ", ".join(bad), file=sys.stderr)
    return not bad


def report(cell, res, device):
    """Print `res` (run_cell's) as the result line, its checks last on
    standard error too; the exit code."""
    import torch
    if not clean():
        return 3
    if res is None:
        return 0
    cuda = torch.device(device).type == "cuda"
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=cell.chips, memory_peak_bytes=res.pop("peak"),
               nvidia_smi=nvidia_smi())
    prof = res.pop("prof")
    if prof is not None:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    ranks = res.pop("ranks")
    if ranks is not None:
        dev["ranks"] = ranks
    checks = res.pop("checks")
    line = dict(res, device=dev, checks=checks)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def serve(cell, args, command, device="cuda"):
    """One run of `cell`: in this process on one card; on more, as the
    launcher of `cell.chips` ranks, each running `command` (which comes
    back here and, first of all, calls launch.die_with_launcher), or as
    one of those ranks.  The exit code."""
    from harness import launch
    if cell.chips > 1 and not launch.is_rank():
        code, line = launch.launch(
            cell.chips, command, launch.deadline_s(args.seconds), T0)
        if not clean():
            return 3
        if code == 0:
            print(line, flush=True)
        return code
    import torch
    if cell.chips == 1:
        if torch.device(device) == torch.device("cuda"):
            device = torch.device("cuda", 0)
        return report(cell, run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), device), device)
    try:
        code = report(cell, run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), device,
                                     launch.start_time()), device)
    except BaseException:
        traceback.print_exc()
        code = 1
    # a rank's interpreter may wait forever at its exit on a communicator
    # that a failed collective left behind
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def main(argv=None, cell=None):
    """The benchmark's entry; `cell` (a spec.Cell) in place of the
    workload's, for tests."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    sys.path[:0] = [BENCH, ROOT]
    from harness import launch, spec
    if launch.is_rank():
        launch.die_with_launcher()
    cell = cell or spec.cell(args.workload)
    if cell.chips > 1 and not launch.is_rank():
        have = launch.cards()
    else:
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine shows {have}: no run", file=sys.stderr)
        return 2
    return serve(cell, args, [sys.executable, os.path.abspath(__file__),
                              *argv])


if __name__ == "__main__":
    sys.exit(main())
