#!/usr/bin/env python3
"""Compare the QEq kernels and the steps of two or more trees of this repo
on one CUDA card, in turns (e.g. parent, change, change, parent):

    python3 scripts/qeq_kernels_ab.py TREE [TREE ...]

Each TREE is a checkout of the repo (its rxmd_tpu_torch is imported, its
kernels built into TREE/build); each runs in a process of its own on the
CHON deck replicated (4, 4, 3), 8,064 atoms, float32, the sweep engine:
the QEq build and apply on the engine's own list, device time (each
kernel's launches captured into one CUDA graph, its replay timed by CUDA
events: 10 builds, 50 applies), then md.Engine.run as chip_smoke.py's
phase 5 runs it (isQEq=1 and 2: 20 steps to warm up and capture, then 20
steps timed by the host clock, with their CG iterations a step: the
kernels' summation order moves the float32 CG's stops, and an iteration
is ~0.3 ms of a step), and for isQEq=1 five optimizer probes
after the first two (`Engine.probe` as a CUDA graph), wall ms each.
Prints one JSON line per tree with nvidia-smi's name and power limit.
"""
import json
import os
import subprocess
import sys
import time

CHILD = r'''
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, TREE)
from rxmd_tpu_torch import config, ffield, md, system
from rxmd_tpu_torch.ops import pairsweep as ps

def graph_ms(fn, reps):
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record(); g.replay(); b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

def engine(isq):
    data = TREE + "/tests/data"
    ff = ffield.parse_ffield(data + "/ffield_chon_synth")
    frac, types, cell = system.read_geninit_xyz(data + "/chon168.xyz",
                                                ff.name_to_type)
    frac, types, cell = system.replicate(frac, types, cell, (4, 4, 3))
    H = system.box_matrix(*cell)
    st = system.make_state(frac @ H.T, types, H, dtype=torch.float64,
                           device="cpu")
    return md.Engine(ff, st, config.RunConfig(dtype="float32", isQEq=isq,
                                              pstep=5), device="cuda")

ps.build()
out = {"tree": TREE}
e = engine(1)
e._rebuild(e.state)
s = e.state
ops = e._make_pair_ops(s.pos, s.H, s.types, e._slotmap)
walk, n = ops.walk, s.n
rng = np.random.default_rng(0)
X = torch.as_tensor(rng.normal(size=(n, 2)), dtype=torch.float32,
                    device="cuda")
q = torch.as_tensor(rng.normal(scale=0.2, size=n), dtype=torch.float32,
                    device="cuda")
planes = ops.qeq_planes()
build = lambda: ps.qeq_build(e.pairk, walk, planes, e._qeq_fn, ops.own, n,
                             e._qcap)
lst = build()
if "hs" in ps.qeq_apply.__code__.co_varnames[:3]:
    hs, ht = X[:, 0], X[:, 1]
    apply = lambda: ps.qeq_apply(lst, walk, hs, ht, q)
else:
    apply = lambda: ps.qeq_apply(lst, walk, X, q)
out["qeq_build_ms"] = graph_ms(build, 10)
out["qeq_apply_ms"] = graph_ms(apply, 50)
del lst
for isq in (1, 2):
    eng = e if isq == 1 else engine(2)
    eng.init_velocity(seed=0)
    eng.prepare()
    eng.run(20, log=None)
    it0 = int(eng.cg_iters)
    wall = eng.run(20, log=None)
    out[f"isQEq{isq}_ms_per_step"] = wall / 20 * 1e3
    out[f"isQEq{isq}_cg_iters_per_step"] = (int(eng.cg_iters) - it0) / 20
    if isq == 1:
        pos = eng.state.pos
        for _ in range(2):
            eng.probe(pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            eng.probe(pos)
        torch.cuda.synchronize()
        out["probe_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    del eng
print("AB " + json.dumps(out), flush=True)
'''


def main(trees):
    import torch
    if not torch.cuda.is_available() or not trees:
        print("qeq_kernels_ab: needs a CUDA device and one or more trees",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for tree in trees:
        tree = os.path.abspath(tree)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", f"TREE = {tree!r}\n" + CHILD],
            capture_output=True, text=True, timeout=900, cwd=tree)
        line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        if res.returncode or not line:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(line[0][3:])
        rec["seconds"] = round(time.perf_counter() - t0, 1)
        rec["card"] = smi
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
