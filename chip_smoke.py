#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rxmd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--mc 4 4 3] [--steps 20] [--seed 0]

Drives the port's main path, `md.Engine` on the in-repo CHON deck
(tests/data, 168-atom cell replicated --mc, 8,064 atoms by default) in
float32.  Each phase checks its results and raises on a failed check; the
first failure ends the run with a non-zero exit code and no result line.

  1. device: torch's name for card 0, and nvidia-smi's name and power limit;
  2. build: nvcc compiles rxmd_tpu_torch/csrc/pairsweep.cu for sm_90a and
     prints ptxas's registers and spills per kernel;
  3. kernels: on the deck's real slot layout and the engine's walk, each
     CUDA kernel against its plain PyTorch version on the card (nonbond;
     qeq_build: the same offsets and counts per row, the same sources in
     each row's records in walk order and h within 1e-5 of max|h|;
     qeq_apply on the same list and (n, 2) state, with q and without
     it), build + apply and the nonbond
     kernel on the engine's walk against `gather_rows` of `sweep_plain`,
     each timed by CUDA events beside its plain version and its bound;
     the apply with q and without timed in turns in one call, and the
     apply beside torch.sparse.mm over the same list, with their ratio;
     then the hydrogen-bond kernel (csrc/hbond.cu, `phase_hbond`) on the
     pair-list engine's lists at --mc against hbond_plain, timed beside
     its bound, its plain version and the autograd grid it replaced, and
     launched by the pair-list steps and by a probe of the sweep; then the
     torsion kernel (csrc/torsion.cu, `phase_torsion`) the same way,
     against torsion_plain and the grid's list under autograd; then the
     pair list's nonbond kernel (csrc/nonbond_list.cu,
     `phase_nonbond_list`) at --mc and its (2, 2, 2) replica against
     nonbond_list_plain, timed beside its bound and the (n, knb) planes it
     replaced, launched by the pair-list steps and not by a sweep probe;
  4. slice: prepare + --steps NVE steps with full-CG QEq (isQEq=1), PRINTE
     lines (every step, so each step is a single-step dispatch, a CUDA
     graph after its key's first use); launch counts: nonbond once a step,
     qeq_build once per QEq solve, qeq_apply once per matvec (the
     gradient's and qeq.CG_CHUNK per chunk of CG iterations); total energy
     against the same steps run with the plain versions; and on the
     168-atom cell, 5 steps on the card against the float64 CPU run of the
     plain versions;
  5. timing, printed and never checked: atom-steps/s for isQEq=1 and 2, ms
     per step by phase (the port's device marks under a profiler session,
     `session_ms`);
  6. program: the port as users run it, at --mc: tools.geninit writes DAT/,
     then `__main__.main` (tests/data/rxmd_chon.in with CLI overrides) runs
     mdmode 5 from rxff.bin with frames in all four formats, restarts from
     rxff.npz (NVE), runs mdmode 7 with an electric field and springs, and
     opt.conjugate_gradient takes two iterations (each probe the engine's
     probe program, a CUDA graph after its first uses); each run's launch
     counts (as in phase 4), its PRINTE lines and files are checked, and
     its atom-steps/s, summary() table and optimizer seconds printed; the
     .xyz writer it ran (traj.write_xyz: the port's csrc/trajio.cpp,
     built by the host C++ compiler, through ctypes) against the Python
     formatting on one frame, ms each and bytes equal, and the
     trajectory output's share of the first run's loop;
  7. pair paths: the engines besides the sweep at --mc, each asserting
     `Engine.pair_engine` and that no sweep kernel ran, prepare + 5 steps
     timed by phase beside the sweep's own: (a) the dense forms and (b)
     the pair list (with and without the dense QEq fold), at isQEq=1 and
     2, each step's PE components against the sweep run's; (c) the deck
     in a triclinic cell: 168 atoms in float32 on the card against float64
     on the CPU, then --mc for 20 steps at isQEq=1 and 2 (chunked brute
     neighbor build, 27 images); (d) float64, the default config (the
     table pair list): 168 atoms on the card against the CPU, then --mc;
  8. pqeq lg: PQEq (tests/data/pqeq_chon.par) and ReaxFF-lg
     (tests/data/ffield_chon_synth_lg), which no sweep kernel takes: (a)
     PQEq in float32 at --mc, isQEq=1 and 2, prepare + 5 steps timed by
     phase with peak device memory, on the pair list, shells relaxed;
     (b) PQEq at 168 atoms, float64 on the card against the CPU (CG
     capped at 8) and float32 against that; (c) LG in float32 at --mc on
     the dense forms and on the pair list, each step's PE components
     against each other, and LG's float64 table engine at 168 atoms on
     the card against the CPU; (d) the program at --mc: `main` with
     tests/data/rxmd_chon_pqeq.in from geninit's rxff.bin, a restart from
     its rxff.npz with the shells read back, and a run with --lg;
  9. sharded: the domain-decomposed engine (parallel.ShardedEngine), which
     runs no sweep kernel: at --mc in float32 on the closed-form pair list,
     as one NCCL rank on mesh (1, 1, 1) (the halo as periodic self-images,
     every reduction an NCCL all-reduce), prepare + 5 steps at isQEq=1
     and 2, each step's total PE against md.Engine's pair-list run (its
     CG on the list too) from the same start within TOL_TE, timed by phase
     (halo and all-reduce spans inside the others) with peak device
     memory; after the isQEq=1 run the engine's rows against rxmd_tpu's
     every-row layout on the same domain (row_layout_cost); with two
     or more cards, dryrun.run over min(count, 8) NCCL ranks at --mc held
     the same way, else one line saying that needs a second card;
 10. graphs: the step program (md.Engine's blocks and single steps as
     CUDA graphs, graphs.py) at --mc in float32 on the sweep, NVE,
     isQEq=2 then 1, GRAPH_STEPS steps in blocks of GRAPH_BLOCK with
     graphs (the default) and eagerly (Engine.graphs off) from one start:
     the same block, step and rebuild counts with a block or more, each
     PRINTE's total PE within TOL_GRAPH_PE, the launch counts as in phase
     4, and one step replayed right after a rebuild against the eager
     step; printed, never checked: ms/step and atom-steps/s of both,
     captures and capture ms, steps in blocks, peak memory, and the device
     idle share of 10 more steps by torch.profiler, and in the isQEq=1
     graphs run each QEq kernel's device ms per step and share of the
     steps' device time;
 11. graph paths: the step program of every other configuration at --mc,
     each from one start with graphs and eagerly under the same schedule
     (GRAPH_PATH_STEPS steps, blocks of GRAPH_BLOCK): the pair list at
     isQEq=1 (its QEq folded dense), the dense forms at isQEq=2, float64's
     tables at isQEq=2, a triclinic cell at isQEq=2, uncached terms at
     isQEq=2 and tighten_lists at isQEq=1 (both on the pair list), PQEq
     at isQEq=1 and 2, and LG (the dense forms) at isQEq=2.  Each holds
     `uses_graphs()`, a capture and a replay or more, the same block,
     step and rebuild counts, each PRINTE's total PE within TOL_GRAPH_PE
     of the eager run's (TOL_GRAPH_PE_F64 in float64), no capacity
     overflow at the block ends, no sweep kernel, and one step replayed
     right after a rebuild against the eager step; printed, never
     checked: ms/step and atom-steps/s of both modes, captures and
     capture ms, the device idle share of 10 more steps by
     torch.profiler with the captures and replays inside them, and peak
     memory;
 12. optimizer program: the optimizer's probes (md.Engine.probe, the
     probe program `_probe_fn`, as CUDA graphs in a cache of their own)
     at --mc in float32 on the sweep: OPT_ITERS iterations of
     opt.conjugate_gradient with graphs and eagerly (Engine.graphs off)
     from one start, each with PE that does not rise, nonbond and
     qeq_build launched once a probe, and with graphs every probe a
     replay but each key's first use and the first probe (which sizes
     the QEq list); then the graph probe against the eager probe on one
     engine at five positions the run recorded (TOL_PROBE_PE, _F, _Q),
     and three probes each of the pair list, the dense forms, float64's
     tables (TOL_GRAPH_PE_F64), a triclinic cell, PQEq and LG dense,
     graphs against eager, no sweep kernel; printed, never checked:
     seconds and probes per iteration, captures, capture ms, replays,
     peak memory, the device idle share of one more iteration by
     torch.profiler with the captures and replays inside it and its
     kernels with the most device time, a graph probe's device ms by
     phase (`session_ms`) and an eager one's aten ops with the most device
     time, and
     each configuration's ms per probe.

 13. sharded graphs: the sharded engine's programs (ShardedEngine's
     steps, blocks, prepare and optimizer probes through graphs.GraphCache,
     their NCCL all-reduces inside the captures) as one NCCL rank on mesh
     (1, 1, 1) at --mc in float32, which runs no sweep kernel: isQEq=2
     then 1, GRAPH_PATH_STEPS steps in blocks of GRAPH_BLOCK with graphs
     and eagerly (ShardedEngine.graphs off) from one start: the same
     block, step and rebuild counts with a block or more, each PRINTE's
     total PE within TOL_GRAPH_PE, a capture or more and every dispatch
     after each key's first use a replay, and a step replayed right after
     a rebuild within the window's buckets against the eager step (10
     steps more, then 10 profiled); then
     OPT_ITERS iterations of opt.conjugate_gradient each way, PE not
     rising, every probe after each key's first use a replay, and graph
     probes against eager ones at three recorded positions at phase 12's
     bars; printed, never checked: ms/step and atom-steps/s of both modes,
     captures and capture ms, the device idle share of 10 more steps by
     torch.profiler, peak memory, and the optimizer's seconds per
     iteration and per probe.  With two or more cards the multi-rank dry
     run (dryrun.run, its steps captured with their sends and receives);
     else a line saying it needs them.
 14. rebuild programs: the rebuild as a device program (md.Engine's and
     ShardedEngine's `_rebuild_fn`, a CUDA graph in a cache of its own,
     read once a rebuild), checked inside phases 10, 11 and 13 on each
     graphs run's engine, for the sweep at isQEq 2 and 1, every
     configuration of phase 11 and the sharded engine at isQEq 2 and 1:
     in each run a drift rebuild, and every rebuild but each key's first
     use a replay (none eagerly), so the runs' PE bars hold the graph
     rebuilds against eager ones; then from one state a rebuild as a
     graph and eagerly, one host read each (dryrun.HostReadGuard
     counting), the lists, slot map, positions, QEq list capacity and
     buckets (the sharded: the migrated state, window, buckets and cell
     depth) equal entry for entry, and ms of each by CUDA events and
     wall; phase 13's optimizer also holds each `cg_resync` to one host
     read, a program after its first use.  The phase prints the table
     and checks every configuration was covered.

The last three lines are the kernels' JSON record, nvidia-smi's name and
power limit, and {"ok": true, "device": {...}}.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
FFIELD = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
RXMD_IN = os.path.join(DATA, "rxmd_chon.in")
FFIELD_LG = os.path.join(DATA, "ffield_chon_synth_lg")
PQEQ_PAR = os.path.join(DATA, "pqeq_chon.par")
RXMD_PQEQ_IN = os.path.join(DATA, "rxmd_chon_pqeq.in")
SOURCE = "rxmd_tpu_torch/csrc/pairsweep.cu"
REPLACES = "rxmd_tpu/ops/pairsweep.py:289"
KERNELS = ("nonbond", "qeq_build", "qeq_apply")
HB_SOURCE = "rxmd_tpu_torch/csrc/hbond.cu"
TOR_SOURCE = "rxmd_tpu_torch/csrc/torsion.cu"
NBL_SOURCE = "rxmd_tpu_torch/csrc/nonbond_list.cu"

# kernel vs plain sweep, float32, same candidate pairs, other summation
# order: the bars of tests/test_pairsweep.py (energy sums 2e-3 relative,
# forces 2e-4 of max|f|, virial sums 2e-3 of max|W|, QEq rows 3e-4 of max)
TOL_E, TOL_F, TOL_W, TOL_Q = 2e-3, 2e-4, 2e-3, 3e-4
# the QEq list of the kernel against the plain build: the same pairs (both
# gate on the same float32 distance), h within 1e-5 of max|h| (float32
# taper and powf against PyTorch's, ~1e-6 of max|h| apart)
TOL_H = 1e-5
# the card's peak rates for the bounds: float32 outside the tensor cores
# and HBM3 (the H100 SXM data sheet, at 700 W)
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# operations per pair that passes the gates, counted from csrc/pairsweep.cu
# (each +, -, *, / and each sqrtf, powf, expf as one): nonbond_kernel's
# pair body; the hessian element of qeq_build_kernel; qeq_apply_kernel's
# three products and sums and the image weight
OPS_NONBOND, OPS_QEQ_BUILD, OPS_QEQ_APPLY = 101, 27, 7
# operations per (donor, H, acceptor) entry of csrc/hbond.cu's inner body,
# counted the same way (the energy, dE/dBO0 and the three gradients)
OPS_HBOND = 100
# the hydrogen-bond kernel against hbond_plain, float32 on the card: the
# same entries (both gate on the same rounded distance), summed in another
# order and with atomics
TOL_HB = 1e-4
# operations per torsion of csrc/torsion.cu's torsion_one and its sums,
# counted the same way (both energies and their gradients)
OPS_TORSION = 420
# the torsion kernel against torsion_plain, float32 on the card: the same
# torsions (both gate on the same float32 products), cos 2w and cos 3w as
# polynomials against arccos, summed in another order and with atomics
TOL_TOR = 1e-4
# operations per pair that passes the gates of csrc/nonbond_list.cu's pair
# body, counted the same way (the distance, the taper and its derivative,
# vdW, Coulomb, their r-derivatives, the force and the virial products)
OPS_NONBOND_LIST = 99
# the pair list's nonbond kernel against nonbond_list_plain, float32 on the
# card, at the QEq charges of the engine's start: the same pairs, each term
# a few ulp apart (the kernel's float32 powers, exponential, cube root and
# divisions are the special-function unit's), summed in another order
# (a warp's lanes, then rows, against PyTorch's reductions over the
# planes): each energy within TOL_NBL_E of itself, the forces within
# TOL_NBL_F of their rms, the virial within TOL_NBL_W of its largest entry
TOL_NBL_E, TOL_NBL_F, TOL_NBL_W = 1e-5, 1e-4, 1e-5
# per-step total energy of the kernel run against the plain-sweep run on
# the card: both float32, so they part only through summation order and
# CG stops; at 1e-4 relative that is ~10x above the float32 noise of a
# 20-step run and far below any wrong pair term
TOL_TE = 1e-4
# 168-atom cell, float32 on the card against float64 on the CPU, 5 steps:
# float32 CG stops at relative Est change 2.4e-6 (the 20-ulp floor), so
# charges differ by ~1e-4 e and PE components by ~1e-5 of |PE|
TOL_SMALL_PE = 1e-4
TOL_SMALL_POS = 1e-4     # [A]
# the dense and ELL engines against the sweep at --mc, float32, the same
# start and 5 steps: the same closed-form physics summed in other orders.
# Each PE component within TOL_PATH_PE of |PE|, except Eclmb and Echarge:
# full CG stops at the float32 floor (relative Est change 2.4e-6) at other
# iterates in other summation orders, which moves ~2e-4 of |PE| between
# the two and leaves their sum, the energy QEq minimizes, in place (CPU
# rehearsal, 1,344 atoms); so their sum is held to TOL_PATH_PE and each
# alone to TOL_QEQ_SPLIT
TOL_PATH_PE = 1e-4
TOL_QEQ_SPLIT = 1e-3
# float64 on the card against float64 on the CPU, per PE component
# relative, with the CG capped so both take the same iterations
TOL_F64_CARD = 1e-8
# PQEq at 168 atoms, float64 on the card against the CPU: the shells
# within TOL_SPOS [A] (1e-3 A steps of float64 values)
TOL_SPOS = 1e-10
# lattice angles (alpha, beta, gamma) of the triclinic deck: the CHON
# cell's fractional coordinates in a sheared cell
TRICLINIC = (95.0, 100.0, 105.0)
# phase 10: the steps run as CUDA graphs against the same steps run
# eagerly from one start (float32; the same kernels, but index_add_'s
# atomics sum in another order each run, which the CG carries into the
# charges): each PRINTE's total PE within TOL_GRAPH_PE of |PE|, and one
# step replayed right after a rebuild within TOL_GRAPH_PE of the eager
# step's PE and TOL_GRAPH_POS [A] of its positions
TOL_GRAPH_PE = 1e-5
TOL_GRAPH_POS = 1e-5
GRAPH_STEPS = 40
GRAPH_BLOCK = 4          # steps per block: the hot deck's drift budget
                         # leaves room for blocks this short
# phase 11: float64's graphs against its eager run (the same kernels in
# float64: only index_add_'s atomics reorder, ~1e-16 relative a sum)
TOL_GRAPH_PE_F64 = 1e-9
GRAPH_PATH_STEPS = 20
# phase 12: a probe as a CUDA graph against the same probe run eagerly on
# the same engine and inputs (float32: index_add_'s atomics reorder the
# sums, which a full CG carries into the charges): PE within TOL_PROBE_PE
# of |PE|, forces within TOL_PROBE_F of max|f|, charges within
# TOL_PROBE_Q e; float64 within TOL_GRAPH_PE_F64 each
TOL_PROBE_PE, TOL_PROBE_F, TOL_PROBE_Q = 1e-5, 1e-4, 1e-4
OPT_ITERS = 2
DEVICE = "cuda"          # the slice's device; main() requires a card


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def load_deck(mc, dtype, device, angles=None, lg=False):
    """The CHON deck replicated mc; with `angles` (alpha, beta, gamma) its
    fractional coordinates in a triclinic cell of those lattice angles;
    with `lg` the LG force field."""
    from rxmd_tpu_torch import ffield, system
    ff = ffield.parse_ffield(FFIELD_LG if lg else FFIELD, lg=lg)
    frac, types, cell = system.read_geninit_xyz(CELL, ff.name_to_type)
    if angles is not None:
        cell = cell[:3] + tuple(angles)
    frac, types, cell = system.replicate(frac, types, cell, mc)
    H = system.box_matrix(*cell)
    st = system.make_state(frac @ H.T, types, H, dtype=dtype, device=device)
    return ff, st


def make_engine(mc, device, dtype="float32", angles=None, lg=False, **cfg):
    from rxmd_tpu_torch import config, md
    ff, st = load_deck(mc, torch.float64, "cpu", angles, lg)
    kw = dict(dtype=dtype, isQEq=1, pstep=5)
    kw.update(cfg)
    return md.Engine(ff, st, config.RunConfig(**kw), device=device)


# the phases the port marks on the device (md.Engine, parallel/engine.py,
# parallel/comm.py's collectives)
PHASES = ("pairs", "qeq", "nonbond", "bonded", "rebuild", "halo",
          "allreduce")


def session_ms(fn):
    """fn() under a torch.profiler session (CPU activity): (its value, the
    device ms and counts of each of PHASES in it, over every program) from
    the port's record of the session (rxmd_tpu_torch.utils.timers.
    last_session: the device's own marks, inside the CUDA graphs as well).
    fn ends on a read of the port's (a run's end, a rebuild's or a probe's
    read), after which the marks are read; a wall time fn takes itself
    leaves out the profiler's start and stop."""
    from torch.profiler import ProfilerActivity, profile
    from rxmd_tpu_torch.utils import timers
    with profile(activities=[ProfilerActivity.CPU]):
        val = fn()
    out = {}
    for (_, name), (ns, n) in timers.last_session()["phases"].items():
        if name in PHASES:
            ms, c = out.get(name, (0.0, 0))
            out[name] = (ms + ns * 1e-6, c + n)
    return val, out


def fresh_peak(device=None):
    """Free what earlier engines left (an engine in a reference cycle
    lives until the garbage collector runs) and restart the count of peak
    device memory."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps launches, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps):
    """Mean device ms of fn() over reps launches captured into one CUDA
    graph, by CUDA events around a replay: the kernels back to back with
    no host work between them (cuda_ms's loop pays the wrapper's host time
    per launch, which a kernel shorter than it does not hide)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def bound(nbytes, nops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move nbytes and do nops float32 operations."""
    tb, to = nbytes / PEAK_BYTES, nops / PEAK_F32
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def max_rel(got, ref):
    """Largest |got - ref| of each row over that row's max(1, max|ref|)."""
    err = (got.double() - ref.double()).abs().amax(dim=1)
    return err / ref.double().abs().amax(dim=1).clamp(min=1.0)


def check_nonbond(name, got, ref):
    g, r = got.double().cpu().numpy(), ref.double().cpu().numpy()
    check(np.isfinite(g).all(), f"{name}: non-finite kernel rows")
    for k in (0, 1):
        check(abs(g[k].sum() - r[k].sum()) <= TOL_E * max(
            1.0, abs(r[k].sum())), f"{name} energy row {k}")
    check(np.abs(g[2:5] - r[2:5]).max() <= TOL_F * np.abs(
        r[2:5]).max(), f"{name} forces")
    w, wr = g[5:].sum(1), r[5:].sum(1)
    check(np.abs(w - wr).max() <= TOL_W * max(
        1.0, np.abs(wr).max()), f"{name} virial")
    return float(np.abs(g - r).max())


def check_qeq_rows(name, got, ref):
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite rows")
    rel = max_rel(got, ref)
    check(bool((rel <= TOL_Q).all()), f"{name}: rows within {TOL_Q} of max "
          f"(got {rel.tolist()})")
    return float((got.double() - ref.double()).abs().max())


def phase_kernels(engine, seed):
    """Each CUDA kernel against its plain version on the deck's slot layout
    and the engine's walk (the path `Engine.step` runs), then build + apply
    and the nonbond kernel on that walk against `sweep_plain`.  Returns
    {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms)}."""
    from rxmd_tpu_torch.ops import pairsweep as ps
    e = engine
    e._rebuild(e.state)
    s = e.state
    ops = e.pairs.data(s.pos, s, None, e._layout)
    rng = np.random.default_rng(seed)
    n = s.n
    q = rng.normal(scale=0.2, size=n)
    q -= q.mean()
    hs, ht = rng.normal(size=(2, n))
    t = lambda a: torch.as_tensor(a, dtype=e.dtype, device=e.device)
    q, hs, ht = t(q), t(hs), t(ht)
    grid, walk, own = ops.grid, ops.walk, ops.own
    nb_fn, qeq_fn = ops.nb_fn, ops.fn
    nb_planes, qeq_planes = ops.nonbond_planes(q), ops.qeq_planes()
    # the filled slots lead walk.slots (its padding is never read)
    T, M = walk.tslot.shape[0], int(walk.cell_start[-1])
    # what every walk kernel must read besides its planes: the filled
    # slots, the cell prefix sums and the target slots (padded slots
    # never reach a result, so planes count over the M filled slots only)
    walk_bytes = 4 * M + 4 * walk.cell_start.shape[0] + 4 * T
    res = {}

    # the work of this layout: the old block sweep's slot tests, the walk's
    # filled-slot candidates, and the pairs within the taper radius
    blocks = grid.tc_n[0] * grid.tc_n[1] * grid.n_zb
    old = blocks * grid.C * len(grid.cols) * (
        grid.block_zc + 2 * grid.zreach) * grid.ccap
    cand = int(ps.walk_candidates(grid, walk))
    i, tsl, src = ps.walk_pairs_plain(grid, walk, qeq_planes[:3], qeq_fn.rc2)
    d, ok, *_ = ps._pair_geometry(nb_fn, nb_planes[:, tsl], nb_planes[:, src])
    n_nb = int((ok & (nb_planes[4, tsl] != nb_planes[4, src])).sum())
    del i, tsl, src, d, ok
    log(f"sweep work: {T} targets, {M} of {grid.nslots} slots filled; "
        f"{old:.4e} slot tests of the PR 1 block "
        f"sweep, {cand:.4e} filled-slot candidates of the walk "
        f"({old / cand:.1f}x fewer); {n_nb} nonbond pairs pass the gates")
    # the PR 1 block sweep's bounds: its (K, nslots) planes in, (out_k,
    # n_targets) rows out; the QEq sweep did the build's and the apply's
    # operations on every pair
    for name, K, out_k, ops_pair in (
            ("nonbond", 6, 11, OPS_NONBOND),
            ("qeq", 8, 3, OPS_QEQ_BUILD + OPS_QEQ_APPLY)):
        bms, by = bound(4 * (K * grid.nslots + out_k * grid.n_targets),
                        n_nb * ops_pair)
        log(f"PR 1 {name} sweep bound: {bms * 1e3:.3f} us ({by})")

    # nonbond: kernel against nonbond_plain on the engine's walk
    got = ps.nonbond(grid, walk, nb_planes, nb_fn)
    torch.cuda.synchronize()
    ref = ps.nonbond_plain(grid, walk, nb_planes, nb_fn)
    check(got.shape == ref.shape == (11, n), f"nonbond rows {got.shape}")
    err = check_nonbond("nonbond", got, ref)
    eager = {"nonbond": cuda_ms(lambda: ps.nonbond(grid, walk, nb_planes,
                                                   nb_fn), 20)}
    ms = graph_ms(lambda: ps.nonbond(grid, walk, nb_planes, nb_fn), 20)
    plain_ms = cuda_ms(lambda: ps.nonbond_plain(grid, walk, nb_planes, nb_fn),
                       3)
    # 6 planes and the rows' targets in, 11 rows out
    nbytes = 4 * 6 * M + walk_bytes + 4 * T + 4 * 11 * n
    bms, by = bound(nbytes, n_nb * OPS_NONBOND)
    res["nonbond"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=None)

    # qeq_build: the kernel's list against qeq_build_plain's, both at the
    # engine's fixed capacity (the main path's form: no host read)
    cap = ops.cap
    lst = ps.qeq_build(grid, walk, qeq_planes, qeq_fn, own, n, cap)
    torch.cuda.synchronize()
    ref = ps.qeq_build_plain(grid, walk, qeq_planes, qeq_fn, own, n, cap)
    need, E = int(lst.need), int(ref.count.sum())
    check(torch.equal(lst.start, ref.start) and torch.equal(lst.count,
                                                            ref.count)
          and need == int(ref.need) == cand <= cap,
          f"qeq_build: entries per row (kernel {int(lst.count.sum())}, "
          f"plain {E}; need {need}, candidates {cand}, capacity {cap})")
    live = live_records(ref)
    check(torch.equal(lst.code[live], ref.code[live]),
          "qeq_build: the same sources per row, in walk order")
    hmax = float(ref.h[live].abs().max())
    err = float((lst.h[live] - ref.h[live]).abs().max())
    check(bool(torch.isfinite(lst.h[live]).all()) and err <= TOL_H * hmax,
          f"qeq_build: h within {TOL_H} of max|h| ({err:.3e} of {hmax:.3e})")
    eager["qeq_build"] = cuda_ms(lambda: ps.qeq_build(
        grid, walk, qeq_planes, qeq_fn, own, n, cap), 20)
    ms = graph_ms(lambda: ps.qeq_build(grid, walk, qeq_planes, qeq_fn, own, n,
                                       cap), 10)
    plain_ms = cuda_ms(lambda: ps.qeq_build_plain(grid, walk, qeq_planes,
                                                  qeq_fn, own, n, cap), 3)
    # 5 planes and the owners in, the offsets in, the counts and the
    # list's records out
    nbytes = 4 * 6 * M + walk_bytes + 4 * (T + 1) + 4 * T + 8 * E
    bms, by = bound(nbytes, E * OPS_QEQ_BUILD)
    res["qeq_build"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=None)
    blocks, threads, smem = ps.qeq_build_occupancy(grid, qeq_fn)
    sizes = walk.qblocks[:, 1] - walk.qblocks[:, 0]
    log(f"qeq_build: {blocks} blocks of {threads} threads resident an SM, "
        f"{smem / 1024:.1f} KB of shared memory a block; "
        f"{int((sizes > 0).sum())} blocks hold targets (at most "
        f"{ps.BUILD_TARGETS} of one column, {int(sizes.max())} the largest) "
        f"of {sizes.shape[0]} launched")
    log(f"QEq list: {E} entries, {8 * E / 1e6:.1f} MB, in a layout of "
        f"{need} records (the walk's candidates) of a capacity of {cap} "
        f"(padded so)")

    # qeq_apply: the kernel against qeq_apply_plain on the kernel's list,
    # on an (n, 2) state as the CG passes it
    X = torch.stack([hs, ht], dim=1)
    got = ps.qeq_apply(lst, walk, X, q)
    torch.cuda.synchronize()
    ref = ps.qeq_apply_plain(lst, walk, X, q)
    check(got.shape == ref.shape == (3, n), f"qeq_apply rows {got.shape}")
    err = check_qeq_rows("qeq_apply", got, ref)
    grad = ps.qeq_apply(lst, walk, X)
    check_qeq_rows("qeq_apply without q", grad[:2], ref[:2])
    check(not bool(grad[2].any()), "qeq_apply without q: an Est row of 0")
    eager["qeq_apply"] = cuda_ms(lambda: ps.qeq_apply(lst, walk, X, q), 50)
    ms = graph_ms(lambda: ps.qeq_apply(lst, walk, X, q), 50)
    plain_ms = cuda_ms(lambda: ps.qeq_apply_plain(lst, walk, X, q), 10)
    # (start, count) and the rows' targets in, the records of the rows'
    # entries, the (n, 2) state and q in, 3 rows out
    nbytes = 8 * T + 8 * E + 4 * T + 4 * 3 * n + 4 * 3 * n
    bms, by = bound(nbytes, E * OPS_QEQ_APPLY)
    res["qeq_apply"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by,
                            library_ms=library_apply_ms(lst, walk, X, live))
    # with q and without (the CG's gradient) in turns, device time
    # (graph_ms), beside torch.sparse.mm
    forms = {"with q": lambda: ps.qeq_apply(lst, walk, X, q),
             "no q": lambda: ps.qeq_apply(lst, walk, X)}
    order = list(forms) + list(forms)[::-1]
    times = [(k, graph_ms(forms[k], 50)) for k in order]
    log("qeq_apply us per launch in turns, device time: " + ", ".join(
        f"{k} {t * 1e3:.2f}" for k, t in times) + f" (bound "
        f"{bms * 1e3:.2f} us)")
    if res["qeq_apply"]["library_ms"] is not None:
        log(f"qeq_apply / torch.sparse.mm over the same list: "
            f"{ms / res['qeq_apply']['library_ms']:.3f}")

    # build + apply (the engine's sweep3) and the nonbond kernel on the
    # engine's walk against sweep_plain over the TPU kernel's target
    # layout (every filled target, ghosts included), rows gathered
    okf = (e._layout.sm.slot_src >= 0).to(e.dtype)
    packed = torch.cat([qeq_planes,
                        torch.stack([hs, ht, q])[:, own.long()] * okf])
    slot_of_atom = e._layout.sm.slot_of_atom
    got = torch.stack(ops.sweep3(X, q))
    check_qeq_rows("sweep3 (build + apply)", got, ps.gather_rows(
        grid, ps.sweep_plain(grid, packed, qeq_fn), slot_of_atom))
    check_nonbond("nonbond on the walk vs sweep_plain",
                  ps.nonbond(grid, walk, nb_planes, nb_fn),
                  ps.gather_rows(grid, ps.sweep_plain(grid, nb_planes, nb_fn),
                                 slot_of_atom))
    for name in KERNELS:
        r = res[name]
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.1f} us")
        log(f"kernel {name}: max_abs_err {r['max_abs_err']:.3e}; "
            f"{r['ms'] * 1e3:.1f} us/launch device time (graph_ms), "
            f"{eager[name] * 1e3:.1f} us/launch eagerly (cuda_ms, the "
            f"wrapper's host time included), plain {r['plain_ms'] * 1e3:.1f} "
            f"us/call, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it), library {lib}")
    return res


def phase_hbond(mc, smi):
    """The hydrogen-bond kernel (csrc/hbond.cu) at the main path's shapes:
    the pair-list engine with uncached terms at --mc in float32 (the
    benchmark's pair-list cells; every probe runs the same term).  Its
    ptxas report; the kernel against hbond_plain on the card with dE/dH
    (the MD step's form) and without (the probe's): energy, dE/dpos,
    dE/dBO0 and dE/dH within TOL_HB of their largest magnitude; device ms
    of each form (graph_ms) beside the bound, the plain version, and the
    autograd grid it replaced (reax.e_hbond over the pair context: its
    forward as a step ran it, and forward + backward beside the kernel's
    forward + backward); then 3 steps of that engine and one probe of the
    sweep engine, each launching the kernel.  Returns the kernel's
    record."""
    from rxmd_tpu_torch import native, reax, units
    from rxmd_tpu_torch.ops import hbond as hb
    from rxmd_tpu_torch.ops import pairsweep as ps
    so, secs, msgs = native.build(hb._SRC, force=True, verbose=True)
    log(f"build: nvcc {HB_SOURCE} -> {os.path.relpath(so, REPO)} in "
        f"{secs:.1f} s")
    for line in msgs.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "stack frame")):
            log(f"  ptxas: {line.strip()}")
    e = make_engine(mc, DEVICE, term_cache=False, dense_direct_max=0)
    check(e.pair_engine == "ell", f"pair list engine ({e.pair_engine})")
    e._rebuild(e.state)
    s, nbrs, img, ffd = e.state, e.nbrs, e.img, e.ffd
    n, N = nbrs.center_rows, s.n
    amask = torch.ones(N, dtype=torch.bool, device=s.pos.device)
    bo = reax.bond_order(s.pos, s.H, s.types, img, nbrs, ffd)
    tab, hcnt = reax.hbond_tables(s.pos, s.types, img, nbrs, bo, amask, ffd,
                                  e.caps["kh"])
    bo0 = bo.bo[:n, :, 0].contiguous()
    n0 = hb.launches["hbond"]
    got = hb.hbond(s.pos, s.H, bo0, tab, want_dh=True)
    torch.cuda.synchronize()
    check(hb.launches["hbond"] == n0 + 1, "hbond: one launch")
    ref = hb.hbond_plain(s.pos, s.H, bo0, tab, want_dh=True)
    err = abs(float(got[0] - ref[0])) / abs(float(ref[0]))
    check(err <= TOL_HB, f"hbond energy within {TOL_HB} ({err:.3e})")
    for a, b, what in zip(got[1:], ref[1:], ("dE/dpos", "dE/dBO", "dE/dH")):
        rel = float((a - b).abs().max() / b.abs().max())
        check(bool(torch.isfinite(a).all()) and rel <= TOL_HB,
              f"hbond {what} within {TOL_HB} of its max ({rel:.3e})")
        err = max(err, rel)

    # the work: donors with a hydrogen, (donor, H, acceptor) entries
    # that pass the gates (j != k left out: an upper count), and the
    # bytes each input and output needs once
    knb, kb = tab.idxnb.shape[1], tab.hmask.shape[1]
    k = tab.idxnb.clamp(min=0)
    d = s.pos[:n, None, :] - (s.pos[k % tab.nown] + tab.shift[k] @ s.H.T)
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[
        ..., 2]
    acc = ((tab.idxnb >= 0) & (r2 < units.RCHB2) & (tab.inxn3hb[
        tab.types[:n, None], tab.h_type, tab.types[k % tab.nown]] >= 0))
    donors = tab.hmask.any(dim=1)
    nd, nh = int(donors.sum()), int(tab.hmask.sum())
    entries = int((acc.sum(dim=1) * hcnt).sum())
    ext = tab.idxnb[donors]
    uniq = int(torch.unique(ext[ext >= 0]).numel())
    del d, r2, acc, k, ext
    nbytes = (8 * knb * nd + n * kb + (8 + 4) * nh + (4 * 3 + 8) * N
              + 4 * 3 * uniq + 4 * n + 4 * 3 * N + 4 * n * kb)
    bms, by = bound(nbytes, entries * OPS_HBOND)
    log(f"hbond work: {n} donor rows, {nd} with a hydrogen ({nh} "
        f"donor-H pairs, at most {int(hcnt.max())} a donor), {entries} "
        f"entries within rchb; bytes: {8 * knb * nd} of the donors' "
        f"nonbonded rows (knb {knb}), {nbytes} in all")

    ms = graph_ms(lambda: hb.hbond(s.pos, s.H, bo0, tab, want_dh=True), 20)
    ms_probe = graph_ms(lambda: hb.hbond(s.pos, s.H, bo0, tab), 20)
    plain_ms = cuda_ms(lambda: hb.hbond_plain(s.pos, s.H, bo0, tab, True), 3)
    ctx = reax.nb_ctx(s.pos, None, s.H, s.types, img, nbrs, s.gid, amask,
                      ffd)
    p = s.pos.detach().requires_grad_(True)
    bo_g = reax.bond_order(p, s.H, s.types, img, nbrs, ffd)

    def grid_forward():
        with torch.enable_grad():
            return reax.e_hbond(p, s.H, s.types, img, nbrs, bo_g, amask, ffd,
                                kh=tab.kh, ctx=ctx)
    grid_ms = cuda_ms(grid_forward, 5)
    bo_l = bo._replace(bo=bo.bo.detach().requires_grad_(True))
    leaf0 = bo0.detach().requires_grad_(True)

    def grid_both():
        with torch.enable_grad():
            return torch.autograd.grad(reax.e_hbond(
                p, s.H, s.types, img, nbrs, bo_l, amask, ffd, kh=tab.kh,
                ctx=ctx), (p, bo_l.bo))

    def kernel_both():
        with torch.enable_grad():
            return torch.autograd.grad(hb.HBondEnergy.apply(
                p, s.H, leaf0, tab), (p, leaf0))
    grid_both_ms = cuda_ms(grid_both, 5)
    kernel_both_ms = cuda_ms(kernel_both, 20)
    log(f"kernel hbond: max rel err {err:.3e}; {ms * 1e3:.1f} us/launch "
        f"device time with dE/dH (the MD step's form), {ms_probe * 1e3:.1f} "
        f"without (the probe's) (graph_ms, the zeroed buffer and the "
        f"energy's sum included), bound {bms * 1e3:.2f} us ({by}, "
        f"{nbytes} bytes, {entries * OPS_HBOND} operations; "
        f"{bms / ms:.1%} of it); plain {plain_ms:.3f} ms; the autograd "
        f"grid's forward {grid_ms:.3f} ms, forward + backward "
        f"{grid_both_ms:.3f} ms against the kernel's {kernel_both_ms:.3f} "
        f"ms (cuda_ms) | {smi}")

    # the kernel on the engines' paths
    zero = dict(hb.launches)
    e.init_velocity(seed=1)
    e.prepare()
    e.run(3, log=None)
    torch.cuda.synchronize()
    md_launches = hb.launches["hbond"] - zero["hbond"]
    check(md_launches > 0, "hbond launched by the pair-list steps")
    sw = make_engine(mc, DEVICE)
    sw.prepare()
    zero = dict(hb.launches)
    sw.probe(sw.state.pos.clone())
    torch.cuda.synchronize()
    probe_launches = hb.launches["hbond"] - zero["hbond"]
    check(probe_launches > 0, "hbond launched by a probe of the sweep")
    log(f"hbond launches: {md_launches} in prepare + 3 steps of the pair "
        f"list (graphs: counted at eager runs and captures), "
        f"{probe_launches} in a probe of the sweep")
    del e, sw
    torch.cuda.empty_cache()
    return dict(max_rel_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=grid_ms)


def phase_torsion(mc, smi):
    """The torsion and 4-body conjugation kernel (csrc/torsion.cu) at the
    main path's shapes: the pair-list engine with uncached terms at --mc in
    float32 (the benchmark's pair-list cells; every probe runs the same
    term).  Its ptxas report; the kernel against torsion_plain on the card
    (the engine's capacities): both energies and each one's gradients with
    respect to BO0, the pi BO, drb and delta within TOL_TOR of their
    largest magnitude, the same count of torsions; device ms (graph_ms)
    beside the bound, the plain version, and the grid it replaced
    (reax.build_torsion_list's list and reax.torsion_energy under
    autograd: its forward as a step ran it, and forward + backward beside
    the kernel's); then 3 steps of that engine and one probe of the sweep
    engine, each launching the kernel.  Returns the kernel's record."""
    from rxmd_tpu_torch import native, reax, units
    from rxmd_tpu_torch.ops import pairsweep as ps
    from rxmd_tpu_torch.ops import torsion as tor
    so, secs, msgs = native.build(tor._SRC, force=True, verbose=True)
    log(f"build: nvcc {TOR_SOURCE} -> {os.path.relpath(so, REPO)} in "
        f"{secs:.1f} s")
    for line in msgs.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "stack frame")):
            log(f"  ptxas: {line.strip()}")
    e = make_engine(mc, DEVICE, term_cache=False, dense_direct_max=0)
    check(e.pair_engine == "ell", f"pair list engine ({e.pair_engine})")
    e._rebuild(e.state)
    s, nbrs, img, ffd, caps = e.state, e.nbrs, e.img, e.ffd, e.caps
    N = s.n
    amask = torch.ones(N, dtype=torch.bool, device=s.pos.device)
    bo = reax.bond_order(s.pos, s.H, s.types, img, nbrs, ffd)
    tab = tor.TorsionTables(
        types=s.types, gid=s.gid, amask=amask, maskb=bo.mask.contiguous(),
        img=img._replace(shift=img.shift.to(s.pos.dtype)), nbrs=nbrs,
        ffd=ffd, ks=caps["ks"], cap=caps["tor"], rowcap=caps["tor_row"])
    x = (bo.bo[..., 0].contiguous(), bo.bo[..., 2].contiguous(),
         bo.drb.contiguous(), bo.delta.contiguous())
    n0 = tor.launches["torsion"]
    got = tor.torsion(*x, tab)
    torch.cuda.synchronize()
    check(tor.launches["torsion"] == n0 + 1, "torsion: one launch")
    ref = tor.torsion_plain(*x, tab)
    ntor = int(ref[3])
    check(int(got[3]) == ntor > 0, f"torsion count: kernel {int(got[3])}, "
          f"plain {ntor}")
    err = 0.0
    for k, what in ((0, "E_tors"), (1, "E_conj")):
        rel = abs(float(got[k] - ref[k])) / abs(float(ref[k]))
        check(rel <= TOL_TOR, f"torsion {what} within {TOL_TOR} ({rel:.3e})")
        err = max(err, rel)
    kb = tab.maskb.shape[1]
    for k, what in ((0, "E_tors"), (1, "E_conj")):
        for a, b, name in zip(tor.split(got[2][k], N, kb),
                              tor.split(ref[2][k], N, kb),
                              ("BO0", "pi", "drb", "delta")):
            scale = float(b.abs().max())
            if scale == 0.0:                       # E_conj: no pi, no delta
                check(float(a.abs().max()) == 0.0, f"d{what}/d{name} zero")
                continue
            rel = float((a - b).abs().max()) / scale
            check(bool(torch.isfinite(a).all()) and rel <= TOL_TOR,
                  f"torsion d{what}/d{name} within {TOL_TOR} of its max "
                  f"({rel:.3e})")
            err = max(err, rel)

    # the work: the torsions the list build keeps (an upper count of those
    # the energy sums), and the bytes each input and output needs once:
    # the candidate slots' BO0, pi BO, drb and ext index, the live-slot
    # mask, the ext entries' shifts, the per-atom tables, and both
    # energies' parts and gradients
    cand = int((tab.maskb & (x[0] > units.CUTOF2_ESUB)).sum())
    n = nbrs.center_rows
    nbytes = (cand * (4 + 4 + 12 + 8 + 12) + N * kb + N * (8 + 8 + 4 + 1)
              + 2 * 4 * (n + 5 * N * kb + N))
    bms, by = bound(nbytes, ntor * OPS_TORSION)
    log(f"torsion work: {n} centers, {cand} candidate bonds (kb {kb}), "
        f"{ntor} torsions; bytes: {nbytes}")

    ms = graph_ms(lambda: tor.torsion(*x, tab), 20)
    plain_ms = cuda_ms(lambda: tor.torsion_plain(*x, tab), 3)
    leaf = bo._replace(bo=bo.bo.detach().requires_grad_(True),
                       drb=bo.drb.detach().requires_grad_(True),
                       delta=bo.delta.detach().requires_grad_(True))

    def grid_forward():
        with torch.enable_grad():
            tl = reax.build_torsion_list(s.types, s.gid, img, nbrs, leaf,
                                         amask, ffd, cap=caps["tor"],
                                         ks=caps["ks"],
                                         rowcap=caps["tor_row"])
            return reax.torsion_energy(tl, leaf.bo[..., 0], leaf.bo[..., 2],
                                       leaf.drb, leaf.delta, s.types, ffd)

    def grid_both():
        et, ec = grid_forward()
        return torch.autograd.grad(et + ec, (leaf.bo, leaf.drb, leaf.delta))

    xl = tuple(t.detach().requires_grad_(True) for t in x)

    def kernel_both():
        with torch.enable_grad():
            et, ec, _ = tor.TorsionEnergy.apply(*xl, tab)
            return torch.autograd.grad(et + ec, xl)
    grid_ms = cuda_ms(grid_forward, 5)
    grid_both_ms = cuda_ms(grid_both, 5)
    kernel_both_ms = cuda_ms(kernel_both, 20)
    log(f"kernel torsion: max rel err {err:.3e}; {ms * 1e3:.1f} us/launch "
        f"device time (graph_ms, the zeroed buffer, the energies' sums and "
        f"the count included), bound {bms * 1e3:.2f} us ({by}, {nbytes} "
        f"bytes, {ntor * OPS_TORSION} operations; {bms / ms:.1%} of it); "
        f"plain {plain_ms:.3f} ms; the grid's forward {grid_ms:.3f} ms, "
        f"forward + backward {grid_both_ms:.3f} ms against the kernel's "
        f"{kernel_both_ms:.3f} ms (cuda_ms) | {smi}")

    # the kernel on the engines' paths
    zero = dict(tor.launches)
    e.init_velocity(seed=1)
    e.prepare()
    e.run(3, log=None)
    torch.cuda.synchronize()
    md_launches = tor.launches["torsion"] - zero["torsion"]
    check(md_launches > 0, "torsion launched by the pair-list steps")
    sw = make_engine(mc, DEVICE)
    sw.prepare()
    zero = dict(tor.launches)
    sw.probe(sw.state.pos.clone())
    torch.cuda.synchronize()
    probe_launches = tor.launches["torsion"] - zero["torsion"]
    check(probe_launches > 0, "torsion launched by a probe of the sweep")
    log(f"torsion launches: {md_launches} in prepare + 3 steps of the pair "
        f"list (graphs: counted at eager runs and captures), "
        f"{probe_launches} in a probe of the sweep")
    del e, sw
    torch.cuda.empty_cache()
    return dict(max_rel_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=grid_ms)


def phase_nonbond_list(mcs, smi):
    """The pair list's closed-form nonbond kernel (csrc/nonbond_list.cu) at
    the pair-list cells' shapes: the engine with uncached terms at each of
    `mcs` in float32 (8,064 and 64,512 atoms by default), at the charges of
    its start (prepare's QEq).  Its ptxas report; for each size the kernel
    against nonbond_list_plain on the card with the virial (the MD step's
    form) and without: energies within TOL_NBL_E of themselves, forces
    within TOL_NBL_F of their rms, the virial within TOL_NBL_W of its
    largest entry; device ms (graph_ms) beside its bound, the plain version
    (the pair context and the closed form over it) and the closed form
    alone over a built context (what the step's "nonbond" phase ran before
    the kernel); then 3 steps of the first engine launch the kernel and a
    probe of the sweep does not.  Returns the first size's record."""
    from rxmd_tpu_torch import native, reax
    from rxmd_tpu_torch.ops import nonbond_list as nbl
    so, secs, msgs = native.build(nbl._SRC, force=True, verbose=True)
    log(f"build: nvcc {NBL_SOURCE} -> {os.path.relpath(so, REPO)} in "
        f"{secs:.1f} s")
    for line in msgs.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "stack frame")):
            log(f"  ptxas: {line.strip()}")
    res = []
    for mc in mcs:
        fresh_peak()
        e = make_engine(mc, DEVICE, term_cache=False, dense_direct_max=0)
        check(e.pair_engine == "ell", f"pair list engine ({e.pair_engine})")
        e.prepare()
        s, nbrs, ffd = e.state, e.nbrs, e.ffd
        N = s.n
        n, knb = nbrs.idxnb.shape
        amask = torch.ones(N, dtype=torch.bool, device=s.pos.device)
        ctx = reax.nb_ctx(s.pos, None, s.H, s.types, e.img, nbrs, s.gid,
                          amask, ffd)
        inp, q = ctx.src, s.q
        err = {}
        for wv in (True, False):
            n0 = nbl.launches["nonbond_list"]
            got = nbl.nonbond_list(inp, q, None, wv)
            torch.cuda.synchronize()
            check(nbl.launches["nonbond_list"] == n0 + 1,
                  "nonbond_list: one launch")
            ref = nbl.nonbond_list_plain(inp, q, None, wv)
            for k, what in ((0, "evdw"), (1, "eclmb")):
                err[what] = abs(float(got[k] - ref[k])) / abs(float(ref[k]))
            rms = float(ref[2].double().pow(2).mean().sqrt())
            err["f"] = float((got[2] - ref[2]).abs().max()) / rms
            if wv:
                err["W"] = (float((got[3] - ref[3]).abs().max())
                            / float(ref[3].abs().max()))
            else:
                check(got[3] is None, "no virial asked, none given")
            log(f"nonbond_list {N} atoms, virial {wv}: evdw "
                f"{float(got[0]):.6e} (plain {float(ref[0]):.6e}), eclmb "
                f"{float(got[1]):.6e} ({float(ref[1]):.6e}); relative "
                f"errors {', '.join(f'{k} {v:.3e}' for k, v in err.items())}")
            check(bool(torch.isfinite(got[2]).all()), "finite forces")
            check(max(err["evdw"], err["eclmb"]) <= TOL_NBL_E,
                  f"nonbond_list energies within {TOL_NBL_E}")
            check(err["f"] <= TOL_NBL_F,
                  f"nonbond_list forces within {TOL_NBL_F} of their rms")
            check(not wv or err["W"] <= TOL_NBL_W,
                  f"nonbond_list virial within {TOL_NBL_W} of its max")

        # the work: the pairs that pass the gates, and the bytes each input
        # and output needs once: the rows' indices, the owners' positions,
        # types, global ids and charges, the live-center mask, and the
        # forces and the energy and virial parts
        tj = ctx.tj
        live = int((ctx.mask & ctx.notself
                    & (ffd.cf_pair[s.types[:n, None], tj, 0] > 0.5)).sum())
        nbytes = n * knb * 8 + N * (12 + 8 + 8 + 4 + 1) + n * (3 + 11) * 4
        bms, by = bound(nbytes, live * OPS_NONBOND_LIST)
        ms = graph_ms(lambda: nbl.nonbond_list(inp, q, None, True), 20)
        ms_nov = graph_ms(lambda: nbl.nonbond_list(inp, q, None, False), 20)
        plain_ms = cuda_ms(lambda: nbl.nonbond_list_plain(inp, q, None,
                                                          True), 3)
        grid_ms = cuda_ms(lambda: reax.nonbond_cf_energy_forces(
            ctx, q, s.types, amask, ffd, with_virial=True, img=e.img), 3)
        log(f"kernel nonbond_list at {N} atoms: {n} rows of {knb} slots "
            f"({int(nbrs.cntnb.max())} filled at most), {live} pairs; "
            f"{ms * 1e3:.1f} us/launch device time with the virial, "
            f"{ms_nov * 1e3:.1f} without (graph_ms, the energy and virial "
            f"sums included), bound {bms * 1e3:.2f} us ({by}, {nbytes} "
            f"bytes, {live * OPS_NONBOND_LIST} operations; {bms / ms:.1%} "
            f"of it); plain {plain_ms:.3f} ms; the closed form over a "
            f"built context {grid_ms:.3f} ms (cuda_ms) | {smi}")
        res.append(dict(atoms=N, max_rel_err=max(err.values()), ms=ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=grid_ms))
        if len(res) == 1:
            # the kernel on the pair list's steps
            zero = nbl.launches["nonbond_list"]
            e.init_velocity(seed=1)
            e.run(3, log=None)
            torch.cuda.synchronize()
            md_launches = nbl.launches["nonbond_list"] - zero
            check(md_launches > 0,
                  "nonbond_list launched by the pair-list steps")
        del e, ctx, inp, got, ref
        torch.cuda.empty_cache()

    # and not on the sweep's probes
    from rxmd_tpu_torch.ops import pairsweep as ps
    sw = make_engine(mcs[0], DEVICE)
    check(sw.pair_engine == "sweep", f"sweep engine ({sw.pair_engine})")
    sw.prepare()
    zero = dict(nbl.launches), dict(ps.launches)
    sw.probe(sw.state.pos.clone())
    torch.cuda.synchronize()
    check(nbl.launches == zero[0], "no nonbond_list launch in a probe of "
          "the sweep")
    check(ps.launches["nonbond"] > zero[1]["nonbond"],
          "the sweep's nonbond kernel in its probe")
    log(f"nonbond_list launches: {md_launches} in 3 steps of the pair list "
        f"(graphs: counted at eager runs and captures), 0 in a probe of "
        f"the sweep")
    del sw
    torch.cuda.empty_cache()
    return res[0]


def live_records(lst):
    """The indices of the list's records that rows hold, row by row in
    walk order."""
    start, count = lst.start.long(), lst.count.long()
    row = torch.repeat_interleave(torch.arange(start.shape[0],
                                               device=start.device), count)
    first = torch.cumsum(count, 0) - count
    return start[row] + torch.arange(row.shape[0], device=row.device) - first[
        row]


def library_apply_ms(lst, walk, X, live):
    """ms of torch.sparse.mm over the same list's entries as a CSR matrix
    (h only: H·X), the yardstick of the QEq apply; None if it does not
    run."""
    code = lst.code[live]
    col = torch.where(code >= 0, code, ~code)
    crow = torch.zeros(lst.count.shape[0] + 1, dtype=torch.int32,
                       device=X.device)
    crow[1:] = torch.cumsum(lst.count, 0, dtype=torch.int32)
    try:
        H = torch.sparse_csr_tensor(crow, col, lst.h[live].contiguous(),
                                    size=(walk.tslot.shape[0], lst.nown))
        return cuda_ms(lambda: torch.sparse.mm(H, X), 50)
    except RuntimeError as exc:
        log(f"torch.sparse.mm over the QEq list does not run: {exc}")
        return None


def total_energies(lines):
    """Total energy per atom from PRINTE lines ("MDstep: step TE PE ...")."""
    return np.array([float(x.split()[2]) for x in lines
                     if x.startswith("MDstep:")])


def drive(engine, steps, seed, echo):
    """init_velocity + run(steps) with a PRINTE line every step."""
    lines = []

    def sink(x):
        lines.append(x)
        if echo:
            log(x)

    engine.cfg.pstep = 1
    engine.init_velocity(seed=seed)
    engine.run(steps, log=sink)
    return lines


def phase_slice(mc, steps, seed):
    from rxmd_tpu_torch.ops import pairsweep as ps
    e = make_engine(mc, DEVICE)
    grid = e.pairs.grid
    log(f"slice: {e.state.n} atoms, pair grid nslots {grid.nslots}, "
        f"{len(grid.cols)} stencil columns, z-reach per column "
        f"{min(ps._reach_table(grid))}-{grid.zreach} cells")
    kres = phase_kernels(e, seed)

    e = make_engine(mc, DEVICE)
    zero_launches()
    lines = drive(e, steps, seed, echo=True)
    launches = read_launches("slice", e)
    te = total_energies(lines)
    check(len(te) == steps + 1 and np.isfinite(te).all(),
          f"{steps + 1} finite PRINTE lines")
    for x in (e.state.pos, e.state.vel, e.state.q, e.force, e.comps):
        check(bool(torch.isfinite(x).all()), "finite state and forces")
    check(e.state.pos.shape == (e.state.n, 3), "position shape")
    check(launches["nonbond"] == steps + 1,
          f"nonbond launches {launches['nonbond']} == steps + 1")
    log(f"launches: {launches}; {e.qeq_solves} QEq solves, CG iterations "
        f"summed {int(e.cg_iters)}; {e.describe()}")

    ref = make_engine(mc, DEVICE)
    ref.plain_sweeps = True
    te_ref = total_energies(drive(ref, steps, seed, echo=False))
    rel = np.abs(te - te_ref) / np.abs(te_ref)
    log(f"total energy vs the plain-sweep run: max rel diff {rel.max():.3e} "
        f"(bound {TOL_TE})")
    check(rel.max() <= TOL_TE, "total energy against the plain-sweep run")
    return e, kres, launches


def phase_small_reference(seed, nsteps=5):
    """168-atom cell: float32 kernels on the card against the float64 plain
    sweeps on the CPU (the configuration the CPU tests hold to rxmd_tpu;
    float64 asks for the closed form, its default being the tables)."""
    runs = []
    for dev, dt in ((DEVICE, "float32"), ("cpu", "float64")):
        e = make_engine((1, 1, 1), dev, dtype=dt, rebuild_every=4,
                        nonbond_closed_form=True)
        e.init_velocity(seed=seed)
        e.prepare()
        e.run(nsteps, log=None)
        runs.append((e.comps.double().cpu().numpy(),
                     e.state.pos.double().cpu().numpy()))
    (c32, p32), (c64, p64) = runs
    pe_err = np.abs(c32 - c64).max() / abs(c64[0])
    pos_err = np.abs(p32 - p64).max()
    log(f"168-atom cell, {nsteps} steps, float32 card vs float64 CPU: PE "
        f"components max diff {pe_err:.3e} of |PE| (bound {TOL_SMALL_PE}), "
        f"positions {pos_err:.3e} A (bound {TOL_SMALL_POS})")
    check(np.isfinite(c32).all() and pe_err <= TOL_SMALL_PE,
          "168-atom PE components")
    check(pos_err <= TOL_SMALL_POS, "168-atom positions")


def phase_timing(e, mc, steps, seed):
    """Each charge mode's atom-steps/s, then its device ms per step by
    phase over as many steps after a rebuild (`session_ms`)."""
    n = e.state.n
    for isq in (1, 2):
        eng = e if isq == 1 else make_engine(mc, DEVICE, isQEq=2)
        if isq == 2:
            eng.init_velocity(seed=seed)
            eng.prepare()
            eng.run(2, log=None)
        it0 = int(eng.cg_iters)
        wall = eng.run(steps, log=None)
        log(f"isQEq={isq}: {n * steps / wall:.4e} atom-steps/s "
            f"({wall / steps * 1e3:.2f} ms/step over {steps} steps, "
            f"{(int(eng.cg_iters) - it0) / steps:.1f} CG iterations/step)")
        wall, ms = session_ms(lambda: (eng._rebuild(eng.state),
                                       eng.run(steps, log=None))[1])
        parts = ", ".join(
            f"{k} {v / (c if k == 'rebuild' else steps):.2f}"
            for k, (v, c) in sorted(ms.items()))
        log(f"isQEq={isq} ms/step by phase (rebuild: ms per rebuild, every "
            f"{eng.rebuild_every} steps or on drift): {parts}; wall "
            f"{wall / steps * 1e3:.2f} ms/step")


def path_run(mc, device, steps, seed, dtype="float32", angles=None,
             timed=True, lg=False, **cfg):
    """An engine on the deck: init_velocity(seed), prepare, `steps` steps,
    with the launch counts zeroed first.  Returns a dict: the engine, the
    per-step PE components (steps + 1, 14), final positions and shells as
    float64 numpy, and with `timed` the wall ms per step, the device ms
    per step by phase (`session_ms`), one more rebuild's ms, the prepare s
    and the peak device memory of the run (MB)."""
    e = make_engine(mc, device, dtype=dtype, angles=angles, lg=lg, **cfg)
    zero_launches()
    if e.device.type == "cuda":
        fresh_peak(e.device)
    e.init_velocity(seed=seed)
    sync = (torch.cuda.synchronize if e.device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    comps = [e.prepare().double().cpu().numpy()]
    prep_s = time.perf_counter() - t0
    it0 = int(e.cg_iters)

    def loop():
        t0 = time.perf_counter()
        for _ in range(steps):
            e.run(1, log=None)
            comps.append(e.comps.double().cpu().numpy())
        sync()
        return time.perf_counter() - t0
    wall, ph = session_ms(loop) if timed else (loop(), None)
    res = dict(engine=e, comps=np.array(comps), n=e.state.n,
               pos=e.state.pos.double().cpu().numpy(), prep_s=prep_s,
               spos=e.state.spos.double().cpu().numpy(),
               cg=(int(e.cg_iters) - it0) / steps)
    if timed:
        rebuild = session_ms(lambda: e._rebuild(e.state))[1]
        res.update(ms=wall / steps * 1e3, rebuild_ms=rebuild["rebuild"][0],
                   phases={k: v / steps for k, (v, _) in ph.items()
                           if k != "rebuild"},
                   peak_mb=torch.cuda.max_memory_allocated(e.device) / 2**20)
    check(all(np.isfinite(c).all() for c in comps)
          and np.isfinite(res["pos"]).all(), "finite PE and positions")
    return res


def report(label, r, smi, phase="pair paths"):
    """One timing line; every time printed beside the card's nvidia-smi
    name and power limit."""
    e = r["engine"]
    phases = ", ".join(f"{k} {v:.2f}" for k, v in sorted(r["phases"].items()))
    log(f"{phase} | {label} | engine {e.pair_engine}, {r['n']} atoms, "
        f"{str(e.dtype)[6:]}, isQEq={e.cfg.isQEq}: {r['ms']:.2f} ms/step "
        f"wall, {r['n'] * 1e3 / r['ms']:.4e} atom-steps/s, by phase (ms/step)"
        f" {phases}; rebuild {r['rebuild_ms']:.2f} ms; prepare "
        f"{r['prep_s']:.2f} s; {r['cg']:.1f} CG iterations/step; peak "
        f"device memory {r['peak_mb']:.1f} MB | {smi}")


def pe_diff(comps, ref):
    """Largest per-step PE component difference, over |PE| of `ref`."""
    return float((np.abs(comps - ref) / np.abs(ref[:, :1])).max())


def check_path_pe(label, comps, ref):
    """`comps` against `ref` per step: slots 0-11 and Eclmb + Echarge
    within TOL_PATH_PE of |PE|, Eclmb and Echarge each within
    TOL_QEQ_SPLIT (see TOL_QEQ_SPLIT)."""
    def terms(c):
        return np.concatenate([c[:, :12], c[:, 12:].sum(1, keepdims=True)],
                              axis=1)
    err = pe_diff(terms(comps), terms(ref))
    split = float((np.abs(comps[:, 12:] - ref[:, 12:])
                   / np.abs(ref[:, :1])).max())
    log(f"{label}: PE components against the reference run, max {err:.3e} "
        f"of |PE| per step (bound {TOL_PATH_PE}), Eclmb and Echarge each "
        f"{split:.3e} (bound {TOL_QEQ_SPLIT})")
    check(err <= TOL_PATH_PE and split <= TOL_QEQ_SPLIT,
          f"{label}: PE components against the reference run")


def phase_pair_paths(mc, seed, steps=5, tric_steps=20):
    """The pair engines besides the sweep, at --mc: (a) the dense forms and
    (b) the pair-list (ELL) form on the orthogonal deck, each step's PE
    components within TOL_PATH_PE of |PE| of the sweep run from the same
    start; (c) a triclinic deck (lattice angles TRICLINIC): 168 atoms in
    float32 on the card against float64 on the CPU, then --mc timed; (d)
    float64 (the default config: the table pair list): 168 atoms on the
    card against the CPU within TOL_F64_CARD per component, then --mc
    timed.  Every run asserts its pair engine, and the dense and ELL runs
    launch no sweep kernel."""
    smi = nvidia_smi()
    ref = {}
    for isq in (1, 2):
        r = path_run(mc, DEVICE, steps, seed, isQEq=isq)
        check(r["engine"].pair_engine == "sweep", "sweep engine")
        report("sweep", r, smi)
        ref[isq] = r["comps"]
        del r
    runs = [("(a) dense", 1, dict(pair_kernel=False), "dense"),
            ("(a) dense", 2, dict(pair_kernel=False), "dense"),
            ("(b) ELL, dense QEq fold", 1,
             dict(pair_kernel=False, dense_direct_max=0), "ell"),
            ("(b) ELL", 2, dict(pair_kernel=False, dense_direct_max=0), "ell"),
            ("(b) ELL, ELL CG", 1, dict(pair_kernel=False, dense_direct_max=0,
                                        qeq_dense_max=0), "ell")]
    for label, isq, cfg, want in runs:
        r = path_run(mc, DEVICE, steps, seed, isQEq=isq, **cfg)
        check(r["engine"].pair_engine == want, f"{label}: engine {want}")
        no_sweep(label)
        report(label, r, smi)
        check_path_pe(f"{label}, isQEq={isq}, against the sweep",
                      r["comps"], ref[isq])
        del r

    # (c) triclinic: the small cell against float64 on the CPU, then --mc
    small = [path_run((1, 1, 1), dev, 5, seed, dtype=dt, angles=TRICLINIC,
                      timed=False, rebuild_every=4, nonbond_closed_form=True)
             for dev, dt in ((DEVICE, "float32"), ("cpu", "float64"))]
    for r in small:
        check(r["engine"].pair_engine == "ell", "triclinic: ELL engine")
    pe_err = pe_diff(small[0]["comps"], small[1]["comps"])
    pos_err = float(np.abs(small[0]["pos"] - small[1]["pos"]).max())
    log(f"(c) triclinic 168 atoms, 5 steps, float32 card vs float64 CPU: PE "
        f"components {pe_err:.3e} of |PE| (bound {TOL_SMALL_PE}), positions "
        f"{pos_err:.3e} A (bound {TOL_SMALL_POS})")
    check(pe_err <= TOL_SMALL_PE and pos_err <= TOL_SMALL_POS,
          "triclinic 168-atom cell against float64")
    del small
    for isq in (1, 2):
        r = path_run(mc, DEVICE, tric_steps, seed, angles=TRICLINIC,
                     isQEq=isq)
        e = r["engine"]
        check(e.pair_engine == "ell" and e.grid is None
              and e.img.n_images == 27, "triclinic: ELL, brute build, "
              f"27 images ({e.img.n_images})")
        no_sweep("triclinic")
        report(f"(c) triclinic {TRICLINIC}, {tric_steps} steps", r, smi)
        del r, e

    # (d) float64, the default config: the small cell against the CPU with
    # the CG capped (NMAXQEq) so both stop at the same iterate, then --mc
    small = [path_run((1, 1, 1), dev, 5, seed, dtype="float64", timed=False,
                      rebuild_every=4, NMAXQEq=8) for dev in (DEVICE, "cpu")]
    for r in small:
        check(r["engine"].pair_engine == "ell" and not r["engine"].closed_form,
              "float64 default: the table ELL engine")
    f64_card_vs_cpu("(d) float64 default", small)
    del small
    r = path_run(mc, DEVICE, steps, seed, dtype="float64")
    check(r["engine"].pair_engine == "ell" and not r["engine"].closed_form,
          "float64 default at --mc: the table ELL engine")
    no_sweep("float64")
    report("(d) float64 default (tables)", r, smi)


def no_sweep(what):
    from rxmd_tpu_torch.ops import pairsweep as ps
    check(not any(ps.launches.values()),
          f"{what}: no sweep kernel launched ({dict(ps.launches)})")


def f64_card_vs_cpu(label, small):
    """Two float64 runs (card, CPU) of one configuration: each PE
    component within TOL_F64_CARD relative per step."""
    a, b = small[0]["comps"], small[1]["comps"]
    err = float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())
    log(f"{label}, 168 atoms, 5 steps, card vs CPU: PE components max rel "
        f"diff {err:.3e} (bound {TOL_F64_CARD})")
    check(np.isfinite(a).all() and err <= TOL_F64_CARD,
          f"{label}: float64 on the card against the CPU")


def phase_pqeq_lg(mc, seed, steps=5):
    """PQEq and LG, which the sweep kernels do not take (see the module
    docstring, phase 8).  Every run asserts its pair engine and that no
    sweep kernel ran."""
    smi = nvidia_smi()
    t0 = time.perf_counter()
    pq = dict(isPQEq=True, pqeq_parm_path=PQEQ_PAR)
    # (a) PQEq, float32, at --mc
    for isq in (1, 2):
        r = path_run(mc, DEVICE, steps, seed, isQEq=isq, **pq)
        e = r["engine"]
        check(e.pair_engine == "ell" and e.pq is not None,
              f"PQEq isQEq={isq}: the pair-list engine")
        no_sweep(f"PQEq isQEq={isq}")
        st = e.state
        check(all(bool(torch.isfinite(x).all()) for x in
                  (st.pos, st.vel, st.q, st.spos, e.force)),
              f"PQEq isQEq={isq}: finite state")
        smax = float(st.spos.abs().max())
        check(smax > 0, f"PQEq isQEq={isq}: shells moved")
        report(f"(a) PQEq, max|spos| {smax:.3e} A", r, smi, "pqeq lg")
        del r, e, st

    # (b) PQEq at 168 atoms: float64 card against CPU, float32 against it
    small = [path_run((1, 1, 1), dev, 5, seed, dtype="float64", timed=False,
                      rebuild_every=4, NMAXQEq=8, **pq)
             for dev in (DEVICE, "cpu")]
    f64_card_vs_cpu("(b) PQEq float64", small)
    serr = float(np.abs(small[0]["spos"] - small[1]["spos"]).max())
    log(f"(b) PQEq float64 shells, card vs CPU: {serr:.3e} A (bound "
        f"{TOL_SPOS})")
    check(serr <= TOL_SPOS, "PQEq shells on the card against the CPU")
    r32 = path_run((1, 1, 1), DEVICE, 5, seed, timed=False, rebuild_every=4,
                   NMAXQEq=8, **pq)
    err = pe_diff(r32["comps"], small[1]["comps"])
    log(f"(b) PQEq float32 card vs float64 CPU, 168 atoms, 5 steps: PE "
        f"components {err:.3e} of |PE| (bound {TOL_SMALL_PE})")
    check(err <= TOL_SMALL_PE, "PQEq float32 against float64")
    del small, r32

    # (c) LG: the dense forms, then the pair list, float32 at --mc; the
    # float64 table engine at 168 atoms on the card against the CPU
    runs = {}
    for label, cfg, want in (("(c) LG dense", dict(pair_kernel=False),
                              "dense"),
                             ("(c) LG ELL", dict(dense_direct_max=0), "ell")):
        r = path_run(mc, DEVICE, steps, seed, lg=True, **cfg)
        check(r["engine"].pair_engine == want and r["engine"].ffd.is_lg,
              f"{label}: engine {want}")
        no_sweep(label)
        report(label, r, smi, "pqeq lg")
        runs[want] = r["comps"]
        del r
    check_path_pe("(c) LG ELL against LG dense", runs["ell"], runs["dense"])
    small = [path_run((1, 1, 1), dev, 5, seed, dtype="float64", timed=False,
                      rebuild_every=4, NMAXQEq=8, lg=True)
             for dev in (DEVICE, "cpu")]
    for r in small:
        check(r["engine"].pair_engine == "ell" and not r["engine"].closed_form,
              "LG float64: the table ELL engine")
    f64_card_vs_cpu("(c) LG float64 tables", small)
    del small
    phase_pqeq_lg_program(mc)
    log(f"pqeq lg: phase took {time.perf_counter() - t0:.1f} s | {smi}")


def phase_pqeq_lg_program(mc):
    """(d) The program under PQEq at --mc: geninit, `main` with
    rxmd_chon_pqeq.in for 10 steps, a 5-step restart from its rxff.npz
    (shells read back; first PE against the fresh-list PE), then 5 steps
    with --lg on the LG force field from a fresh geninit rxff.bin."""
    from rxmd_tpu_torch.io import checkpoint
    from rxmd_tpu_torch.tools import geninit
    def fresh_dat(dat):
        # geninit's rxff.bin alone, so that `main` starts from step 0
        check(geninit.main(["-i", CELL, "-f", FFIELD, "-o", dat, "-mc",
                            *map(str, mc)]) == 0, "geninit")
        os.remove(os.path.join(dat, "rxff.npz"))

    with tempfile.TemporaryDirectory() as tmp:
        dat = os.path.join(tmp, "DAT")
        fresh_dat(dat)
        base = ["--rxmdin", RXMD_PQEQ_IN, "--ffield", FFIELD, "--outDir",
                dat, "--dtype", "float32", "--pqeq", PQEQ_PAR]
        zero_launches()
        out, eng = run_main(base + ["--ntime_step", "10", "--pstep", "5"])
        no_sweep("PQEq main")
        n = eng.state.n
        pe = printe_pe(out)
        check(eng.pair_engine == "ell" and eng.pq is not None and len(pe) == 3
              and all(np.isfinite(p) for _, p in pe), "PQEq main: PRINTE")
        wall = [x for x in out.splitlines() if x.startswith("total (sec)")]
        log(f"(d) PQEq main: {n} atoms, {wall[0] if wall else ''}, CG "
            f"iterations {int(eng.cg_iters)}")
        st = checkpoint.load(os.path.join(dat, "rxff.npz"), torch.float32)
        smax = float(st.spos.abs().max())
        check(st.step == 10 and smax > 0,
              f"rxff.npz at step 10 with shells (max|spos| {smax:.3e} A)")
        pe_fresh = float(eng.prepare()[0]) / n
        del eng
        zero_launches()
        out2, eng2 = run_main(base + ["--ntime_step", "5", "--pstep", "5"])
        no_sweep("PQEq restart")
        pe2 = printe_pe(out2)
        read = eng2.start_state.spos.to("cpu", torch.float32)
        check(torch.equal(read, st.spos.cpu()),
              "PQEq restart: the engine starts from the file's shells")
        rel = abs(pe2[0][1] - pe_fresh) / abs(pe_fresh)
        log(f"(d) PQEq restart: shells read back (max|spos| "
            f"{float(read.abs().max()):.3e} A); first PE {pe2[0][1]:.6e} "
            f"against the fresh-list PE {pe_fresh:.6e}: rel diff {rel:.3e} "
            f"(bound {TOL_TE})")
        check(pe2[0][0] == 10 and rel <= TOL_TE, "PQEq restart PE")
        del eng2
        dat_lg = os.path.join(tmp, "DAT_LG")
        fresh_dat(dat_lg)
        zero_launches()
        out3, eng3 = run_main(["--rxmdin", RXMD_IN, "--ffield", FFIELD_LG,
                               "--lg", "--outDir", dat_lg, "--dtype",
                               "float32", "--ntime_step", "5", "--pstep",
                               "5"])
        no_sweep("--lg main")
        pe3 = printe_pe(out3)
        check(eng3.ffd.is_lg and eng3.pq is None
              and [k for k, _ in pe3] == [0, 5]
              and all(np.isfinite(p) for _, p in pe3), "--lg main: PRINTE")
        log(f"(d) --lg main: engine {eng3.pair_engine}, PE {pe3}")


def phase_sharded(mc, seed, steps=5):
    """The sharded engine on the card (see the module docstring, phase 9).
    Every run asserts that no sweep kernel ran."""
    from rxmd_tpu_torch.config import RunConfig
    from rxmd_tpu_torch.parallel import comm, dryrun
    from rxmd_tpu_torch.parallel.engine import ShardedEngine
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    # the CG runs to its float32 stop in both: capped short of it (8
    # iterations, as the float64 parity tests cap it) the charges are not
    # converged and the PE moves with them at first order
    ref_cfg = dict(pair_kernel=False, dense_direct_max=0, qeq_dense_max=0)
    comm.init_process_group(0, 1, f"127.0.0.1:{dryrun.free_port()}", DEVICE)
    try:
        for isq in (1, 2):
            ff, st = load_deck(mc, torch.float64, "cpu")
            zero_launches()
            fresh_peak()
            e = ShardedEngine(ff, st, RunConfig(
                dtype="float32", isQEq=isq, pstep=5),
                device=DEVICE)
            check(e.comm.grouped and e.comm.size == 1
                  and e.mesh_shape == (1, 1, 1) and e.closed_form
                  and e.device.type == torch.device(DEVICE).type,
                  "sharded: one NCCL rank, mesh (1, 1, 1), closed form")
            e.init_velocity(seed=seed)
            t0 = time.perf_counter()
            comps = [e.prepare().double().cpu().numpy()]
            prep_s = time.perf_counter() - t0
            it0 = int(e.cg_iters)

            def loop():
                t0 = time.perf_counter()
                for _ in range(steps):
                    e.run(1, log=None)
                    comps.append(e.comps.double().cpu().numpy())
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / steps * 1e3
            wall, ph = session_ms(loop)
            ph["rebuild"] = session_ms(e.rebuild)[1]["rebuild"]
            peak = torch.cuda.max_memory_allocated() / 2**20
            no_sweep(f"sharded isQEq={isq}")
            comps = np.array(comps)
            sizes = (f"ncap {e.ncap}, bcap {e.bcap}, rows "
                     f"{e._block.keep.shape[0]} of {e.mext}")
            cg = (int(e.cg_iters) - it0) / steps
            if isq == 1:
                log(f"sharded | {row_layout_cost(e)} | {smi}")
            del e
            r = path_run(mc, DEVICE, steps, seed, isQEq=isq, **ref_cfg)
            check(r["engine"].pair_engine == "ell", "reference: ELL engine")
            report("md.Engine reference (ELL, list CG)", r, smi, "sharded")
            ref = r["comps"]
            del r
            err = float((np.abs(comps[:, 0] - ref[:, 0])
                         / np.abs(ref[:, 0])).max())
            parts = ", ".join(f"{k} {v / (c if k == 'rebuild' else steps):.2f}"
                              for k, (v, c) in sorted(ph.items()))
            n = st.n
            log(f"sharded | isQEq={isq}, {n} atoms, float32, mesh (1, 1, 1), "
                f"1 NCCL rank, {sizes}: {wall:.2f} ms/step wall, "
                f"{n * 1e3 / wall:.4e} atom-steps/s, by phase (ms/step; "
                f"rebuild ms each; halo and allreduce inside the others) "
                f"{parts}; prepare {prep_s:.2f} s; {cg:.1f} CG "
                f"iterations/step; peak device memory {peak:.1f} MB | {smi}")
            log(f"sharded | isQEq={isq}: total PE per step against md.Engine "
                f"(ELL) max rel diff {err:.3e} (bound {TOL_TE})")
            check(np.isfinite(comps).all() and err <= TOL_TE,
                  f"sharded isQEq={isq}: total PE against md.Engine")
    finally:
        comm.destroy()
    count = torch.cuda.device_count()
    if count >= 2:
        err, rec, _ = dryrun.run(min(count, 8), DEVICE, mc=mc,
                                 dtype="float32", tol=TOL_TE)
        log(f"sharded | {min(count, 8)} NCCL ranks, mesh {rec['mesh']}: "
            f"PE against md.Engine {err:.3e} of |PE| (bound {TOL_TE}) | {smi}")
    else:
        log(f"sharded | multi-rank NCCL run: not run, it needs a second card "
            f"(torch.cuda.device_count() = {count})")
    log(f"sharded: phase took {time.perf_counter() - t_phase:.1f} s | {smi}")


def wall_ms(fn, reps=3):
    """(median host ms of fn() over reps calls after a warm-up, each ended
    by a device synchronize; the last result)."""
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    out = fn()
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), out


def row_layout_cost(e):
    """The sharded engine's rows against rxmd_tpu's layout, on the domain
    `e` holds after a rebuild.  The engine computes over the residents and
    the live ghosts, padded with empty ghost rows to the window's bucket
    (Block.keep): nonbonded rows, many-body centers and CG
    vectors for the residents alone (Neighbors.center_rows), bonded rows
    for the ghosts within `bond_depth`.  rxmd_tpu computes every row of
    the ghost buffers, ncap + 6 bcap, each with both lists and CG entries
    (rxmd_tpu/parallel/engine.py:406-461, 464-609).  Both layouts run the
    same domain's neighbor build, term lists, one force evaluation (halo
    refresh, pair context, bonded energies forward and backward with the
    copy-back, the nonbond) and one isQEq=2 solve, each timed by wall_ms;
    the residents' energies, forces and charges must agree (float32 sums
    in other orders).  Returns the log line."""
    from rxmd_tpu_torch import neighbors, qeq, reax
    from rxmd_tpu_torch.parallel import halo
    from rxmd_tpu_torch.md import _trim
    from rxmd_tpu_torch.pairs import PairList
    from rxmd_tpu_torch.parallel.engine import identity_image
    s, spec, comm, ncap, dev = e.sstate, e.spec, e.comm, e.ncap, e.device
    plan, frac_ext, valid_ext = halo.build_plan(s.frac, s.valid, spec, comm)
    tex_all = halo.apply_plan(plan, s.types, spec, comm)
    gex_all = halo.apply_plan(plan, s.gid, spec, comm)

    def cut_nbrs():
        keep = e._block.keep
        pos_rel, near = e._near(frac_ext[keep], valid_ext[keep])
        nbrs, occ = e._neighbors(pos_rel, valid_ext[keep], tex_all[keep],
                                 torch.nonzero(near).reshape(-1), e.grid)
        check(int(occ) <= e.grid.ccap, "row layouts: cell capacity")
        return pos_rel, nbrs

    def all_nbrs():
        pos_rel = (frac_ext - e.mylo) @ e.Hg.T
        nbrs, occ = neighbors.build_neighbors_cells(
            pos_rel, valid_ext, tex_all, e.grid, e.rc2b_ext, e.rctap2_ext,
            e.kb, e.knb)
        check(int(occ) <= e.grid.ccap, "row layouts: cell capacity")
        v = valid_ext[:, None]
        return pos_rel, nbrs._replace(
            idxb=torch.where(v, nbrs.idxb, -1),
            cntb=torch.where(valid_ext, nbrs.cntb, 0),
            idxnb=torch.where(v, nbrs.idxnb, -1),
            cntnb=torch.where(valid_ext, nbrs.cntnb, 0))

    res = {}
    for name, keep, build in (
            ("cut", e._block.keep, cut_nbrs),
            ("all", torch.arange(e.mext, device=dev), all_nbrs)):
        m = keep.shape[0]
        tex, gex = tex_all[keep], gex_all[keep]
        img = identity_image(m, e.dtype, dev)
        amask = torch.zeros(m, dtype=torch.bool, device=dev)
        amask[:ncap] = s.valid
        t_nb, (pos_rel, nbrs) = wall_ms(build)
        t_lists, lists = wall_ms(lambda: e._term_lists(
            pos_rel, tex, gex, img, nbrs, amask, e.term_slack,
            e.term_margin))
        lists = tuple(_trim(lst) for lst in lists)
        rows = nbrs.center_rows

        def refresh(x, is_frac=False):
            return halo.apply_plan(plan, x, spec, comm, is_frac)[keep]
        q_ext = refresh(s.q)

        def force():
            frac_res = s.frac.detach().requires_grad_(True)
            with torch.enable_grad():
                pr = (refresh(frac_res, True) - e.mylo) @ e.Hg.T
                ctx = reax.nb_ctx(pr, None, e.Hg, tex, img, nbrs, gex, amask,
                                  e.ffd)
                comps = reax.energy_components(
                    pr, q_ext, e.Hg, tex, gex, img, nbrs, e.ffd, lists,
                    amask=amask, caps=e.caps, include_nonbond=False)
                (g,) = torch.autograd.grad(comps[0], (frac_res,))
            ctx = ctx._replace(qj=q_ext[ctx.idx])
            ev, ec, ech, f_nb, _ = reax.nonbond_ctx_energy_forces(
                ctx, q_ext[:rows], tex[:rows], amask[:rows], e.ffd,
                e.closed_form, with_virial=True, img=img)
            f = -(g @ e.Hi) + f_nb[:ncap]
            return torch.cat([comps[1:11].detach(),
                              torch.stack([ev, ec, ech])]), f, ctx
        t_force, (comps, f, ctx) = wall_ms(force)

        def solve():
            if name == "cut":
                return qeq.solve(
                    s.q, s.qsfp, tex[:ncap], e.ffd, PairList.operator(
                        ctx, None, tex[:ncap], e.ffd, img, nbrs,
                        refresh=refresh, resident_ext=amask),
                    amask=s.valid, isqeq=2, lex_fqs=e.cfg.Lex_fqs,
                    allreduce=comm.psum).q
            # every row a CG entry, its ghost rows refreshed from the
            # residents before each matvec
            return qeq.solve(
                q_ext, refresh(s.qsfp), tex, e.ffd, PairList.operator(
                    ctx, None, tex, e.ffd, img, nbrs,
                    refresh=lambda x: refresh(x[:ncap]), resident_ext=amask),
                amask=amask, isqeq=2, lex_fqs=e.cfg.Lex_fqs,
                allreduce=comm.psum).q[:ncap]
        t_qeq, q = wall_ms(solve)
        res[name] = dict(rows=m, centers=rows, t=(t_nb, t_lists, t_force,
                                                   t_qeq),
                         comps=comps.double(), f=f.double(), q=q.double())
    a, b = res["cut"], res["all"]
    v = s.valid
    e_err = float((a["comps"].sum() - b["comps"].sum()).abs()
                  / b["comps"].sum().abs())
    f_err = float((a["f"][v] - b["f"][v]).abs().max()
                  / b["f"][v].abs().max())
    q_err = float((a["q"][v] - b["q"][v]).abs().max()
                  / b["q"][v].abs().max())
    check(e_err <= TOL_TE and f_err <= TOL_F and q_err <= TOL_Q,
          f"row layouts agree (energy {e_err:.2e}, forces {f_err:.2e}, "
          f"charges {q_err:.2e})")
    ta, tb = a["t"], b["t"]
    parts = " / ".join(f"{x:.2f} vs {y:.2f}" for x, y in zip(ta, tb))
    return (f"rows {a['rows']} (centers {a['centers']}) against rxmd_tpu's "
            f"{b['rows']} (centers {b['centers']}), ms: neighbor build / "
            f"term lists / force evaluation / isQEq=2 solve {parts}; sum "
            f"{sum(ta):.2f} vs {sum(tb):.2f}; residents' energy "
            f"{e_err:.2e}, forces {f_err:.2e}, charges {q_err:.2e} apart")


def idle_share(fn, by=None):
    """(device ms, wall ms, idle share, top) of fn() under torch.profiler
    (CUDA activity only): the summed device time of its kernels, copies
    and fills against the host wall of the window, which ends in a
    synchronize; the share is None when the trace holds no device time.
    `top`: the eight names with the most device time, (name, ms, calls);
    `by`, a dict if given, gets every name's (ms, calls).
    The trace's raw events are summed: building the profiler's event
    tree (`key_averages`) takes tens of seconds for a window of 1e5
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = {} if by is None else by
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            ms, calls = by.get(ev.name(), (0.0, 0))
            by[ev.name()] = (ms + ev.duration_ns() / 1e6, calls + 1)
    busy = sum(ms for ms, _ in by.values())
    top = [(k[:60], round(ms, 2), c) for k, (ms, c)
           in sorted(by.items(), key=lambda x: -x[1][0])[:8]]
    return (busy, wall, (max(0.0, 1.0 - busy / wall) if busy > 0 else None),
            top)


def op_profile(fn, top=8):
    """The `top` aten ops of fn() with the most device time (their
    kernels' time, children included) under torch.profiler with CPU and
    CUDA activity, by input shapes: (op, shapes, device ms, calls)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    dev = lambda ev: getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0)) / 1e3
    evs = [ev for ev in prof.key_averages(group_by_input_shape=True)
           if ev.key.startswith("aten::")]
    return [(ev.key, str(ev.input_shapes)[:80], round(dev(ev), 2), ev.count)
            for ev in sorted(evs, key=dev, reverse=True)[:top]]


def replay_after_rebuild(e):
    """One step right after a rebuild, as a replay of a captured graph
    (the lists rebuilt, so rebound, at the same positions each time; the
    first two calls warm the program up and capture it), against the
    same step run eagerly: (PE difference over |PE|, max position
    difference).  The sweep's replay launches its nonbond kernel once."""
    from rxmd_tpu_torch.ops import pairsweep as ps
    s0, f0, a0 = e.state, e.force, e._astr

    def one(graphs):
        e.graphs = graphs
        e.state, e.force, e._astr = s0, f0, a0
        e._rebuild(e.state)
        e._advance(1)
        torch.cuda.synchronize()
        return (e.comps.double().cpu().numpy(),
                e.state.pos.double().cpu().numpy())
    one(True)
    one(True)
    g = e._graphs
    reps, nb = g.replays, ps.launches["nonbond"]
    got = one(True)
    sweep = int(e.pair_engine == "sweep")
    check(g.replays == reps + 1 and ps.launches["nonbond"] == nb + sweep,
          "the step right after a rebuild replayed a captured graph")
    ref = one(False)
    e.graphs = True
    return (abs(got[0][0] - ref[0][0]) / abs(ref[0][0]),
            float(np.abs(got[1] - ref[1]).max()))


# phase 14's records, one per configuration whose rebuild program phases
# 10, 11 and 13 checked on their graphs run's engine
REBUILDS = []


def same_leaves(a, b):
    """Every tensor of two nests equal, shape and entries."""
    from rxmd_tpu_torch import graphs
    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) > 0 and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def counted_reads(fn):
    """(fn()'s result, the host reads it made: dryrun.HostReadGuard
    counting)."""
    from rxmd_tpu_torch.parallel.dryrun import HostReadGuard
    with HostReadGuard(count=True) as guard:
        out = fn()
    return out, guard.seen


def rebuild_check(label, e, rebuild, products, reps=3):
    """Phase 14's check of a rebuild program on the engine `e` of a graphs
    run (phases 10, 11, 13), whose rebuilds the run captured and
    replayed: `rebuild()` from one state as a CUDA graph and eagerly
    (`e.graphs` on and off), each reading the host once, their
    `products()` ((tensors, other values)) equal entry for entry, and the
    ms of each (CUDA events and host wall over `reps` rebuilds, each
    ending in its read)."""
    g = e._rebuild_graphs
    check(g is not None and g.captures >= 1 and g.replays >= 1,
          f"rebuild programs | {label}: the run's rebuilds captured and "
          f"replayed ({None if g is None else (g.captures, g.replays)})")
    caps0, reps0 = g.captures, g.replays
    fresh_peak()
    got, ms = {}, {}
    for mode in (True, False):
        e.graphs = mode
        _, reads = counted_reads(rebuild)
        check(len(reads) == 1, f"rebuild programs | {label}: one host read "
              f"a rebuild, graphs {mode} ({reads})")
        got[mode] = products()
        ms[mode] = (cuda_ms(rebuild, reps), wall_ms(rebuild, reps)[0])
    e.graphs = True
    check(g.captures == caps0 and g.replays == reps0 + 2 * reps + 3,
          f"rebuild programs | {label}: every graph rebuild a replay "
          f"({g.captures - caps0} captures, {g.replays - reps0} replays)")
    check(same_leaves(got[True][0], got[False][0])
          and got[True][1] == got[False][1],
          f"rebuild programs | {label}: the graph rebuild's products equal "
          f"the eager rebuild's entry for entry ({got[True][1]} against "
          f"{got[False][1]})")
    rec = dict(label=label, n=e.n if hasattr(e, "sstate") else e.state.n,
               dtype=str(e.dtype)[6:], graph_ms=ms[True], eager_ms=ms[False],
               capture_ms=g.capture_s * 1e3 / g.captures,
               peak=torch.cuda.max_memory_allocated() / 2**20)
    REBUILDS.append(rec)
    log(f"rebuild programs | {label} | {rec['n']} atoms, {rec['dtype']}: "
        f"rebuild ms as a graph {ms[True][0]:.2f} (CUDA events) / "
        f"{ms[True][1]:.2f} (wall), eagerly {ms[False][0]:.2f} / "
        f"{ms[False][1]:.2f}; one host read each; capture "
        f"{rec['capture_ms']:.1f} ms; products equal entry for entry; "
        f"peak device memory over these rebuilds {rec['peak']:.1f} MB | "
        f"{nvidia_smi()}")
    return rec


def rebuild_counts(e):
    """(captures, replays, keys first run eagerly) of an engine's rebuild
    programs so far."""
    g = e._rebuild_graphs
    return (0, 0, 0) if g is None else (g.captures, g.replays, len(g.seen))


def check_rebuilds(what, a, b):
    """A run pair's rebuilds (phase 14): a drift rebuild in each, and in
    the graphs run every rebuild but each key's first use (prepare's, and
    the sharded engine's first within its window's buckets) a CUDA graph
    (`rb`: rebuild_counts after the run), none in the eager run."""
    caps, reps, first = a["rb"]
    check(a["counts"][3] >= 1 and first >= 1 and caps <= first
          and reps == a["counts"][2] + 1 - first and b["rb"] == (0, 0, 0),
          f"{what}: a drift rebuild, every rebuild but each key's first "
          f"use a graph ({a['counts'][2]} rebuilds after prepare's, "
          f"{a['counts'][3]} on drift; rebuild captures, replays, first "
          f"uses {a['rb']} with graphs, {b['rb']} eagerly)")


def md_rebuild_check(label, e, profile=False):
    """rebuild_check on an md.Engine from its state: the neighbor and term
    lists, slot map and wrapped positions, the QEq list's capacity and
    the window's buckets.  With `profile`, where a rebuild's time goes:
    the device idle share of a graph rebuild and an eager rebuild's aten
    ops with the most device time (torch.profiler)."""
    s0 = e.state
    rec = rebuild_check(
        label, e, lambda: e._rebuild(s0),
        lambda: ((e.nbrs, e.tlists, e._layout, e._pos_ref),
                 (e.pairs.capacity(e._layout), dict(e._sizes))))
    if profile:
        busy, wall, idle, top = idle_share(lambda: e._rebuild(s0))
        e.graphs = False
        ops = op_profile(lambda: e._rebuild(s0), top=6)
        e.graphs = True
        log(f"rebuild programs | {label} | a graph rebuild under "
            f"torch.profiler: device {busy:.2f} of {wall:.2f} ms, idle "
            f"share {'not measured' if idle is None else f'{idle:.3f}'}; "
            f"kernels with the most device time (name, ms, calls) {top}; "
            f"an eager rebuild's aten ops with the most device time (op, "
            f"shapes, ms, calls) {ops} | {nvidia_smi()}")
    return rec


def sharded_rebuild_check(label, e):
    """rebuild_check on a ShardedEngine from its state: the migrated state,
    the window (Block), its buckets and the cell grid's depth."""
    s0 = e.sstate

    def rebuild():
        e.sstate = s0
        e.rebuild()
    return rebuild_check(label, e, rebuild,
                         lambda: ((e.sstate, e._block),
                                  (dict(e._sizes), e.grid.ccap)))


def phase_rebuild_programs(smi):
    """Phase 14 (see the module docstring): the rebuild programs that
    phases 10, 11 and 13 checked, one line each, and every configuration
    covered."""
    want = (["sweep isQEq=2", "sweep isQEq=1"]
            + [label for label, _, _ in graph_path_configs()]
            + ["sharded isQEq=2", "sharded isQEq=1"])
    got = [r["label"] for r in REBUILDS]
    check(got == want, f"rebuild programs: every configuration checked "
          f"({got} against {want})")
    for r in REBUILDS:
        g, e = r["graph_ms"], r["eager_ms"]
        log(f"rebuild programs | table | {r['label']}: {r['n']} atoms, "
            f"{r['dtype']}, ms graph {g[0]:.2f} / {g[1]:.2f}, eager "
            f"{e[0]:.2f} / {e[1]:.2f} (CUDA events / wall), "
            f"graph/eager {g[1] / e[1]:.3f} | {smi}")


def phase_graphs(mc, seed, steps=GRAPH_STEPS):
    """The step program as CUDA graphs (see the module docstring, phase
    10): at --mc, float32, the sweep, NVE, isQEq=2 then 1, the same
    `steps` run with graphs (the default) and eagerly (Engine.graphs off)
    from one start under the same schedule."""
    from rxmd_tpu_torch import qeq
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    cg = torch.cuda.CUDAGraph
    log(f"graphs: torch {torch.__version__}: CUDAGraph has a conditional "
        f"while node: {hasattr(cg, 'begin_capture_to_while_node')}, an if "
        f"node: {hasattr(cg, 'begin_capture_to_if_node')}; the CG reads one "
        f"finished flag per chunk of {qeq.CG_CHUNK} iterations")
    names = ("MD block (dispatch)", "MD step (dispatch)", "neighbor rebuild")
    for isq in (2, 1):
        runs = {}
        for mode in ("graphs", "eager"):
            e = make_engine(mc, DEVICE, isQEq=isq, pstep=10,
                            block_steps=GRAPH_BLOCK)
            e.graphs = mode == "graphs"
            check(e.pair_engine == "sweep" and e.uses_graphs() == e.graphs,
                  f"graphs: the sweep, graphs {e.graphs}")
            e.init_velocity(seed=seed)
            zero_launches()
            fresh_peak()
            printed = []
            wall = e.run(steps, log=lambda line, e=e: printed.append(
                (e.state.step, float(e.comps[0]))))
            rb = rebuild_counts(e)
            got = read_launches(f"graphs isQEq={isq} {mode}", e)
            iters = int(e.cg_iters)
            check(got["nonbond"] == steps + 1,
                  f"graphs: nonbond launches {got['nonbond']} == steps + 1")
            tm = e.timers
            counts = [tm.ncalls.get(k, 0) for k in names] + [
                tm.counters.get("drift-triggered rebuilds", 0)]
            peak = torch.cuda.max_memory_allocated() / 2**20
            by = {}
            busy, pwall, idle, _ = idle_share(
                lambda e=e: e.run(10, log=None), by)
            if isq == 1 and mode == "graphs":
                qeq_kernel_share(by, busy, 10, smi)
            runs[mode] = dict(e=e, printed=printed, wall=wall, counts=counts,
                              peak=peak, busy=busy, pwall=pwall, idle=idle,
                              launches=got, iters=iters, rb=rb,
                              caps=tm.counters.get("graph captures", 0),
                              reps=tm.counters.get("graph replays", 0),
                              cap_ms=tm.acc.get("graph capture", 0.0) * 1e3,
                              inblk=tm.counters.get("MD steps in blocks", 0))
        a, b = runs["graphs"], runs["eager"]
        check(a["counts"] == b["counts"] and a["counts"][0] >= 1,
              f"graphs isQEq={isq}: the same blocks, steps, rebuilds and "
              f"drift rebuilds, one block or more ({a['counts']} against "
              f"{b['counts']})")
        check([s for s, _ in a["printed"]] == [s for s, _ in b["printed"]],
              "graphs: the same PRINTE steps")
        check_rebuilds(f"graphs isQEq={isq}", a, b)
        err = max(abs(x - y) / abs(y) for (_, x), (_, y)
                  in zip(a["printed"], b["printed"]))
        check(np.isfinite(err) and err <= TOL_GRAPH_PE,
              f"graphs isQEq={isq}: PRINTE PE within {TOL_GRAPH_PE} of the "
              f"eager run ({err:.3e})")
        pe_err, pos_err = replay_after_rebuild(a["e"])
        check(pe_err <= TOL_GRAPH_PE and pos_err <= TOL_GRAPH_POS,
              f"graphs isQEq={isq}: the replay after a rebuild against the "
              f"eager step (PE {pe_err:.3e}, positions {pos_err:.3e} A)")
        md_rebuild_check(f"sweep isQEq={isq}", a["e"], profile=isq == 1)
        n = a["e"].state.n
        for mode, r in runs.items():
            idle = ("not measured" if r["idle"] is None
                    else f"{r['idle']:.3f}")
            log(f"graphs | isQEq={isq} {mode} | {n} atoms, {steps} steps: "
                f"{r['wall'] / steps * 1e3:.2f} ms/step wall, "
                f"{n * steps / r['wall']:.4e} atom-steps/s; blocks / steps "
                f"/ rebuilds / drift rebuilds {r['counts']}, steps in blocks "
                f"{r['inblk']:.0f}; captures {r['caps']:.0f} in "
                f"{r['cap_ms']:.1f} ms, replays {r['reps']:.0f}; CG "
                f"iterations {r['iters']}, launches "
                f"{r['launches']}; peak {r['peak']:.1f} MB; 10 more steps "
                f"under torch.profiler: device {r['busy']:.2f} of "
                f"{r['pwall']:.2f} ms, idle share {idle} | {smi}")
        log(f"graphs | isQEq={isq}: PRINTE PE graphs vs eager max rel diff "
            f"{err:.3e} (bound {TOL_GRAPH_PE}); replay after a rebuild vs "
            f"eager: PE {pe_err:.3e}, positions {pos_err:.3e} A")
        del runs, a, b
    log(f"graphs: phase took {time.perf_counter() - t_phase:.1f} s | {smi}")


def qeq_kernel_share(by, busy, steps, smi):
    """Print each QEq kernel's device ms per step and its share of the
    steps' device time, from a profiled window's names (idle_share's
    `by`); "not measured" where the trace holds none of its launches."""
    parts = []
    for kernel in ("qeq_build_kernel", "qeq_apply_kernel"):
        ms = sum(t for k, (t, _) in by.items() if kernel in k)
        calls = sum(c for k, (_, c) in by.items() if kernel in k)
        parts.append(f"{kernel} {ms / steps:.4f} ms/step ({calls} launches, "
                     f"{ms / busy:.2%} of the device time)" if calls
                     else f"{kernel} not measured (no launch in the trace)")
    log(f"graphs | isQEq=1 graphs, {steps} profiled steps, "
        f"{busy / steps:.3f} ms/step of device time: " + "; ".join(parts)
        + f" | {smi}")


def graph_path_configs():
    """Phase 11's configurations: (label, make_engine keywords, the pair
    engine it must take)."""
    ell = dict(pair_kernel=False, dense_direct_max=0)
    pq = dict(isPQEq=True, pqeq_parm_path=PQEQ_PAR)
    return [
        ("ELL isQEq=1", dict(isQEq=1, **ell), "ell"),
        ("dense isQEq=2", dict(isQEq=2, pair_kernel=False), "dense"),
        ("float64 tables isQEq=2", dict(isQEq=2, dtype="float64"), "ell"),
        ("triclinic ELL isQEq=2", dict(isQEq=2, angles=TRICLINIC), "ell"),
        ("uncached terms isQEq=2", dict(isQEq=2, term_cache=False, **ell),
         "ell"),
        ("tighten_lists isQEq=1", dict(isQEq=1, tighten_lists=True, **ell),
         "ell"),
        ("PQEq isQEq=1", dict(isQEq=1, **pq), "ell"),
        ("PQEq isQEq=2", dict(isQEq=2, **pq), "ell"),
        ("LG dense isQEq=2", dict(isQEq=2, lg=True), "dense"),
    ]


def phase_graph_paths(mc, seed, steps=GRAPH_PATH_STEPS, only=None):
    """The step program of every other configuration as CUDA graphs (see
    the module docstring, phase 11); `only` runs the configurations whose
    labels it names."""
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    names = ("MD block (dispatch)", "MD step (dispatch)", "neighbor rebuild")
    for label, cfg, want in graph_path_configs():
        if only is not None and label not in only:
            continue
        t_cfg = time.perf_counter()
        runs = {}
        for mode in ("graphs", "eager"):
            e = make_engine(mc, DEVICE, pstep=10, block_steps=GRAPH_BLOCK,
                            **cfg)
            e.graphs = mode == "graphs"
            check(e.pair_engine == want and e.uses_graphs() == e.graphs,
                  f"graph paths | {label}: engine {want} ({e.pair_engine}), "
                  f"graphs {e.graphs} ({e.uses_graphs()})")
            # every block end's (and rebuild's) capacity counts, checked
            checked = []
            over = e._check_over
            e._check_over = lambda got, over=over: (checked.append(got),
                                                    over(got))
            e.init_velocity(seed=seed)
            zero_launches()
            fresh_peak()
            printed = []
            wall = e.run(steps, log=lambda line, e=e: printed.append(
                (e.state.step, float(e.comps[0]))))
            rb = rebuild_counts(e)
            no_sweep(f"graph paths | {label} {mode}")
            tm = e.timers
            counts = [tm.ncalls.get(k, 0) for k in names] + [
                tm.counters.get("drift-triggered rebuilds", 0)]
            peak = torch.cuda.max_memory_allocated() / 2**20
            before = graph_counts(tm)
            busy, pwall, idle, _ = idle_share(
                lambda e=e: e.run(10, log=None))
            prof = [b - a for a, b in zip(before, graph_counts(tm))]
            runs[mode] = dict(e=e, printed=printed, wall=wall, counts=counts,
                              peak=peak, busy=busy, pwall=pwall, idle=idle,
                              checked=checked, prof=prof, rb=rb,
                              caps=tm.counters.get("graph captures", 0),
                              reps=tm.counters.get("graph replays", 0),
                              cap_ms=tm.acc.get("graph capture", 0.0) * 1e3,
                              inblk=tm.counters.get("MD steps in blocks", 0))
        a, b = runs["graphs"], runs["eager"]
        check(a["caps"] >= 1 and a["reps"] >= 1 and b["caps"] == 0,
              f"graph paths | {label}: {a['caps']:.0f} captures and "
              f"{a['reps']:.0f} replays with graphs, none eagerly")
        check(a["counts"] == b["counts"] and a["counts"][0] >= 1,
              f"graph paths | {label}: the same blocks, steps, rebuilds and "
              f"drift rebuilds, one block or more ({a['counts']} against "
              f"{b['counts']})")
        check([s for s, _ in a["printed"]] == [s for s, _ in b["printed"]],
              f"graph paths | {label}: the same PRINTE steps")
        check_rebuilds(f"graph paths | {label}", a, b)
        err = max(abs(x - y) / abs(y) for (_, x), (_, y)
                  in zip(a["printed"], b["printed"]))
        f64 = a["e"].dtype == torch.float64
        tol = TOL_GRAPH_PE_F64 if f64 else TOL_GRAPH_PE
        check(np.isfinite(err) and err <= tol,
              f"graph paths | {label}: PRINTE PE within {tol} of the eager "
              f"run ({err:.3e})")
        pe_err, pos_err = replay_after_rebuild(a["e"])
        check(pe_err <= tol and pos_err <= TOL_GRAPH_POS,
              f"graph paths | {label}: the replay after a rebuild against "
              f"the eager step (PE {pe_err:.3e}, positions {pos_err:.3e} A)")
        md_rebuild_check(label, a["e"])
        ncheck = [len(r["checked"]) for r in (a, b)]
        if not a["e"].term_cache or a["e"].cfg.tighten_lists:
            check(min(ncheck) >= 1, f"graph paths | {label}: the steps' "
                  f"capacity counts checked at block ends ({ncheck})")
        fill = {k: max(g[k] for r in (a, b) for g in r["checked"])
                for k in a["checked"][0]} if a["checked"] else {}
        fill = {k: v for k, v in fill.items() if v > 0}
        n = a["e"].state.n
        for mode, r in runs.items():
            idle = ("not measured" if r["idle"] is None
                    else f"{r['idle']:.3f}")
            log(f"graph paths | {label} {mode} | {n} atoms, "
                f"{str(r['e'].dtype)[6:]}, {steps} steps: "
                f"{r['wall'] / steps * 1e3:.2f} ms/step wall, "
                f"{n * steps / r['wall']:.4e} atom-steps/s; blocks / steps / "
                f"rebuilds / drift rebuilds {r['counts']}, steps in blocks "
                f"{r['inblk']:.0f}; captures {r['caps']:.0f} in "
                f"{r['cap_ms']:.1f} ms, replays {r['reps']:.0f}; peak "
                f"{r['peak']:.1f} MB; 10 more steps under torch.profiler: "
                f"device {r['busy']:.2f} of {r['pwall']:.2f} ms, idle share "
                f"{idle}, captures {r['prof'][0]:.0f} in "
                f"{r['prof'][1] * 1e3:.1f} ms, replays {r['prof'][2]:.0f} | "
                f"{smi}")
        log(f"graph paths | {label}: PRINTE PE graphs vs eager max rel diff "
            f"{err:.3e} (bound {tol}); replay after a rebuild vs eager: PE "
            f"{pe_err:.3e}, positions {pos_err:.3e} A; capacity checks "
            f"(graphs, eager) {ncheck}, no overflow, largest counts {fill} "
            f"against caps { {k: a['e'].caps[k] for k in fill} }; "
            f"{time.perf_counter() - t_cfg:.1f} s")
        del runs, a, b
        torch.cuda.empty_cache()
    log(f"graph paths: phase took {time.perf_counter() - t_phase:.1f} s | "
        f"{smi}")


def graph_counts(tm):
    """(captures, capture seconds, replays) in an engine's timers."""
    return (tm.counters.get("graph captures", 0),
            tm.acc.get("graph capture", 0.0),
            tm.counters.get("graph replays", 0))


def probe_configs():
    """Phase 12's configurations besides the sweep: (label, make_engine
    keywords, the pair engine it must take)."""
    pq = dict(isPQEq=True, pqeq_parm_path=PQEQ_PAR)
    return [
        ("ELL", dict(pair_kernel=False, dense_direct_max=0), "ell"),
        ("dense", dict(pair_kernel=False), "dense"),
        ("float64 tables", dict(dtype="float64"), "ell"),
        ("triclinic ELL", dict(angles=TRICLINIC), "ell"),
        ("PQEq", pq, "ell"),
        ("LG dense", dict(lg=True), "dense"),
    ]


def probe_diff(a, b):
    """(PE difference over |PE|, force difference over max|f|, charge
    difference in e) of two probes' (PE, forces, charges)."""
    return (abs(a[0] - b[0]) / abs(b[0]),
            float((a[1] - b[1]).abs().max() / b[1].abs().max()),
            float((a[2] - b[2]).abs().max()))


def check_probe_diff(what, d, f64):
    bars = ((TOL_GRAPH_PE_F64,) * 3 if f64
            else (TOL_PROBE_PE, TOL_PROBE_F, TOL_PROBE_Q))
    check(all(np.isfinite(x) and x <= b for x, b in zip(d, bars)),
          f"{what}: graph probe against the eager probe: PE {d[0]:.3e}, "
          f"forces {d[1]:.3e} of max|f|, charges {d[2]:.3e} e (bounds "
          f"{bars})")


def phase_optimizer_program(mc, seed, iters=OPT_ITERS):
    """The optimizer's probes as CUDA graphs (see the module docstring,
    phase 12): at --mc, float32, the sweep, `iters` CG iterations with
    graphs and eagerly from one start, then three probes of each other
    configuration, graphs against eager."""
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    optimizer_sweep(mc, iters, smi)
    probe_paths(mc, seed, smi)
    log(f"optimizer program: phase took {time.perf_counter() - t_phase:.1f}"
        f" s | {smi}")


def optimizer_sweep(mc, iters, smi):
    """Phase 12's sweep: `iters` CG iterations with graphs and eagerly
    from one start, then graph probes against eager probes at five of
    the positions the graph run probed."""
    from rxmd_tpu_torch import opt
    runs = {}
    for mode in ("graphs", "eager"):
        t_mode = time.perf_counter()
        e = make_engine(mc, DEVICE, mdmode=10)
        e.graphs = mode == "graphs"
        check(e.pair_engine == "sweep" and e.uses_graphs() == e.graphs,
              f"optimizer program: the sweep, graphs {e.graphs}")
        seen = []                        # every probe's positions
        probe = e.probe
        e.probe = lambda pos, hinv=None, probe=probe: (
            seen.append(pos), probe(pos, hinv))[1]
        lines, ends = [], []
        zero_launches()
        fresh_peak()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pe_end = opt.conjugate_gradient(
            e, max_iter=iters, log=lines.append,
            writer=lambda it, pos, p: ends.append(
                (p, time.perf_counter(), len(seen))))
        got = read_launches(f"optimizer program {mode}", e)
        check(got["nonbond"] == got["qeq_build"] == e.qeq_solves,
              f"optimizer program {mode}: nonbond and qeq_build launches "
              f"{got} == probes run {e.qeq_solves}")
        seq = [float(lines[0].split("PE0=")[1])] + [p for p, _, _ in ends]
        check(len(ends) == iters and all(np.isfinite(seq))
              and all(b <= a for a, b in zip(seq, seq[1:]))
              and pe_end == seq[-1],
              f"optimizer program {mode}: PE does not rise over {iters} "
              f"iterations ({seq})")
        ts = [t0] + [t for _, t, _ in ends]
        nps = [0] + [k for _, _, k in ends]
        tm = e.timers
        caps, cap_s, reps = graph_counts(tm)
        if e.graphs:
            g = e._probe_graphs
            check(caps >= 1 and reps >= 1
                  and reps == e.qeq_solves - 1 - len(g.seen),
                  f"optimizer program: {caps:.0f} captures, {reps:.0f} "
                  f"replays of {e.qeq_solves} probes run ({len(g.seen)} "
                  "keys first run eagerly, and the sizing probe): every "
                  "other probe a replay")
        else:
            check(caps == reps == 0, "optimizer program: no graph eagerly")
        peak = torch.cuda.max_memory_allocated() / 2**20
        before, nprobe = graph_counts(tm), len(seen)
        t_prof = time.perf_counter()
        busy, pwall, idle, top = idle_share(
            lambda e=e: opt.conjugate_gradient(e, max_iter=1, log=None))
        t_prof = time.perf_counter() - t_prof
        prof = [b - a for a, b in zip(before, graph_counts(tm))]
        runs[mode] = dict(
            e=e, seen=seen, seq=seq, launches=got, peak=peak,
            per_it=[b - a for a, b in zip(ts, ts[1:])],
            probes=[b - a for a, b in zip(nps, nps[1:])],
            caps=caps, cap_ms=cap_s * 1e3, reps=reps,
            regrow=tm.counters.get("probe QEq list regrowths", 0),
            busy=busy, pwall=pwall, idle=idle, prof=prof, top=top,
            prof_probes=len(seen) - nprobe, t_prof=t_prof,
            t_run=time.perf_counter() - t_mode)
    t_cmp = time.perf_counter()
    e = runs["graphs"]["e"]
    picks = np.linspace(0, len(runs["graphs"]["seen"]) - 1, 5).astype(int)
    diffs = []
    for i in picks:
        pos = runs["graphs"]["seen"][i]
        e.graphs = True
        a = e.probe(pos)
        e.graphs = False
        b = e.probe(pos)
        diffs.append(probe_diff(a, b))
        check_probe_diff(f"optimizer program | sweep probe {i}", diffs[-1],
                         False)
    # a probe's device ms by phase: the device marks of the port's trace
    # under a profiler session (utils/timers.py), the probe program's graph
    by = {k: round(ms / c, 2) for k, (ms, c) in session_ms(
        lambda: [e.probe(runs["graphs"]["seen"][i]) for i in picks])[1]
        .items()}
    e.graphs = False
    ops = op_profile(lambda: e.probe(runs["graphs"]["seen"][picks[-1]]))
    e.graphs = True
    worst = np.max(diffs, axis=0)
    n = e.state.n
    t_cmp = time.perf_counter() - t_cmp
    for mode, r in runs.items():
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.3f}"
        log(f"optimizer program | sweep {mode} | {n} atoms, float32, "
            f"{iters} iterations: seconds per iteration "
            f"{[round(x, 4) for x in r['per_it']]}, probes per iteration "
            f"{r['probes']} (the first with the start's); PE {r['seq']}; "
            f"captures {r['caps']:.0f} in {r['cap_ms']:.1f} ms, replays "
            f"{r['reps']:.0f}, QEq list regrowths {r['regrow']:.0f}; "
            f"launches {r['launches']}; peak {r['peak']:.1f} MB; one more "
            f"iteration under torch.profiler: {r['prof_probes']} probes, "
            f"device {r['busy']:.2f} of {r['pwall']:.2f} ms, idle share "
            f"{idle}, captures {r['prof'][0]:.0f} in "
            f"{r['prof'][1] * 1e3:.1f} ms, replays {r['prof'][2]:.0f}; "
            f"most device time (name, ms, calls): {r['top']}; this run "
            f"took {r['t_run']:.1f} s, {r['t_prof']:.1f} s of it the "
            f"profiled iteration with its trace's processing | {smi}")
    log(f"optimizer program | sweep: a graph probe's device ms by phase "
        f"(the port's marks, {len(picks)} probes): {by}; an eager probe's "
        f"aten ops with the most device time (op, input shapes, ms, "
        f"calls): {ops}")
    log(f"optimizer program | sweep: graph vs eager probe at {len(picks)} "
        f"recorded positions: max PE {worst[0]:.3e}, forces {worst[1]:.3e} "
        f"of max|f|, charges {worst[2]:.3e} e (bounds {TOL_PROBE_PE}, "
        f"{TOL_PROBE_F}, {TOL_PROBE_Q}); these checks and the phase split "
        f"took {t_cmp:.1f} s")
    del runs, e
    torch.cuda.empty_cache()


def probe_paths(mc, seed, smi):
    """Phase 12's other configurations: three probes each at positions a
    numpy-seeded step apart, graphs against eager on one engine."""
    for label, cfg, want in probe_configs():
        t_cfg = time.perf_counter()
        e = make_engine(mc, DEVICE, mdmode=10, **cfg)
        check(e.pair_engine == want and e.uses_graphs(),
              f"optimizer program | {label}: engine {want} "
              f"({e.pair_engine}), graphs")
        rng = np.random.default_rng(seed)
        step = torch.as_tensor(rng.normal(scale=0.01, size=(e.state.n, 3)),
                               dtype=e.dtype, device=e.device)
        zero_launches()
        ms, diffs = {"graphs": [], "eager": []}, []
        for k in range(3):
            pos = e.state.pos + (k + 1) * step
            out = {}
            for mode in ms:
                e.graphs = mode == "graphs"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[mode] = e.probe(pos)      # ends in its one read
                ms[mode].append(round((time.perf_counter() - t0) * 1e3, 2))
            diffs.append(probe_diff(out["graphs"], out["eager"]))
            check_probe_diff(f"optimizer program | {label} probe {k}",
                             diffs[-1], e.dtype == torch.float64)
        no_sweep(f"optimizer program | {label}")
        caps, cap_s, reps = graph_counts(e.timers)
        check(caps == 1 and reps == 2,
              f"optimizer program | {label}: three graph probes: a first "
              f"use, a capture and replay, a replay ({caps:.0f} captures, "
              f"{reps:.0f} replays)")
        worst = np.max(diffs, axis=0)
        log(f"optimizer program | {label} | engine {e.pair_engine}, "
            f"{str(e.dtype)[6:]}, {e.state.n} atoms, 3 probes: ms graphs "
            f"{ms['graphs']} (first use, capture + replay, replay), eager "
            f"{ms['eager']}; capture {cap_s * 1e3:.1f} ms; graph vs eager "
            f"max PE {worst[0]:.3e}, forces {worst[1]:.3e} of max|f|, "
            f"charges {worst[2]:.3e} e; {time.perf_counter() - t_cfg:.1f} s"
            f" | {smi}")
        del e
        torch.cuda.empty_cache()


def sharded_engine(mc, **cfg):
    """A float32 ShardedEngine on the card over the process group this
    process joined (one NCCL rank: mesh (1, 1, 1))."""
    from rxmd_tpu_torch.config import RunConfig
    from rxmd_tpu_torch.parallel.engine import ShardedEngine
    ff, st = load_deck(mc, torch.float64, "cpu")
    kw = dict(dtype="float32", isQEq=1, pstep=5)
    kw.update(cfg)
    return ShardedEngine(ff, st, RunConfig(**kw), device=DEVICE)


def sharded_replay_after_rebuild(e):
    """phase 13's replay_after_rebuild: one step right after a rebuild at
    the same positions, whose counts fit the window's buckets, so the
    window keeps its shapes and the step replays the program captured
    before it, against the same step run eagerly: (PE difference over
    |PE|, max position difference [A])."""
    s0, f0, a0, k0 = e.sstate, e.force, e._astr, e.step_count

    def one(graphs):
        e.graphs = graphs
        e.sstate, e.force, e._astr, e.step_count = s0, f0, a0, k0
        e.rebuild()
        e._advance(1)
        torch.cuda.synchronize()
        return (e.comps.double().cpu().numpy(),
                (e.sstate.frac @ e.Hg.T).double().cpu().numpy())
    one(True)
    one(True)
    g = e._graphs
    reps, caps = g.replays, g.captures
    got = one(True)
    check(g.replays == reps + 1 and g.captures == caps,
          "sharded graphs: the step right after a rebuild within the "
          "window's buckets replayed the program captured before it")
    ref = one(False)
    e.graphs = True
    return (abs(got[0][0] - ref[0][0]) / abs(ref[0][0]),
            float(np.abs(got[1] - ref[1]).max()))


def phase_sharded_graphs(mc, seed, steps=GRAPH_PATH_STEPS, iters=OPT_ITERS):
    """The sharded engine's programs as CUDA graphs with their NCCL
    collectives (see the module docstring, phase 13): one NCCL rank, mesh
    (1, 1, 1), at --mc in float32, isQEq=2 then 1, `steps` steps with
    graphs and eagerly from one start, then the sharded optimizer."""
    from rxmd_tpu_torch.parallel import comm, dryrun
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    names = ("MD block (dispatch)", "MD step (dispatch)", "neighbor rebuild")
    comm.init_process_group(0, 1, f"127.0.0.1:{dryrun.free_port()}", DEVICE)
    try:
        for isq in (2, 1):
            runs = {}
            for mode in ("graphs", "eager"):
                e = sharded_engine(mc, isQEq=isq, pstep=10,
                                   block_steps=GRAPH_BLOCK)
                e.graphs = mode == "graphs"
                check(e.comm.grouped and e.mesh_shape == (1, 1, 1)
                      and e.uses_graphs() == e.graphs,
                      f"sharded graphs: one NCCL rank, graphs {e.graphs}")
                e.init_velocity(seed=seed)
                zero_launches()
                fresh_peak()
                printed = []
                wall = e.run(steps, log=lambda line, e=e: printed.append(
                    (e.step_count, float(e.comps[0]))))
                no_sweep(f"sharded graphs isQEq={isq} {mode}")
                tm = e.timers
                counts = [tm.ncalls.get(k, 0) for k in names] + [
                    tm.counters.get("drift-triggered rebuilds", 0)]
                caps, cap_s, reps = graph_counts(tm)
                # prepare, then every block and single step: each key's
                # first use runs eagerly, every later dispatch replays
                # (in the step cache: the rebuilds replay in their own)
                runs_n = 1 + counts[0] + counts[1]
                if e.graphs:
                    first = len(e._graphs.seen)
                    g = e._graphs
                    check(g.captures >= 1 and g.replays == runs_n - first,
                          f"sharded graphs isQEq={isq}: {g.captures} "
                          f"captures, {g.replays} replays of {runs_n} "
                          f"dispatches ({first} keys first run eagerly): "
                          "every other dispatch a replay")
                else:
                    first = runs_n
                    check(caps == reps == 0,
                          "sharded graphs: no graph eagerly")
                peak = torch.cuda.max_memory_allocated() / 2**20
                rb = rebuild_counts(e)
                # the window's buckets grow at the first rebuilds of the
                # heating deck (its angle and torsion lists): 10 steps
                # more, then 10 profiled
                e.run(10, log=None)
                before = graph_counts(tm)
                busy, pwall, idle, _ = idle_share(
                    lambda e=e: e.run(10, log=None))
                prof = [b - a for a, b in zip(before, graph_counts(tm))]
                runs[mode] = dict(e=e, printed=printed, wall=wall,
                                  counts=counts, caps=caps,
                                  cap_ms=cap_s * 1e3, reps=reps, first=first,
                                  peak=peak, busy=busy, pwall=pwall,
                                  idle=idle, prof=prof, rb=rb,
                                  iters=int(e.cg_iters),
                                  sizes=dict(e._sizes))
            a, b = runs["graphs"], runs["eager"]
            check(a["counts"] == b["counts"] and a["counts"][0] >= 1,
                  f"sharded graphs isQEq={isq}: the same blocks, steps, "
                  f"rebuilds and drift rebuilds, one block or more "
                  f"({a['counts']} against {b['counts']})")
            check([s for s, _ in a["printed"]]
                  == [s for s, _ in b["printed"]],
                  "sharded graphs: the same PRINTE steps")
            check_rebuilds(f"sharded graphs isQEq={isq}", a, b)
            err = max(abs(x - y) / abs(y) for (_, x), (_, y)
                      in zip(a["printed"], b["printed"]))
            check(np.isfinite(err) and err <= TOL_GRAPH_PE,
                  f"sharded graphs isQEq={isq}: PRINTE PE within "
                  f"{TOL_GRAPH_PE} of the eager run ({err:.3e})")
            pe_err, pos_err = sharded_replay_after_rebuild(a["e"])
            check(pe_err <= TOL_GRAPH_PE and pos_err <= TOL_GRAPH_POS,
                  f"sharded graphs isQEq={isq}: the replay after a rebuild "
                  f"against the eager step (PE {pe_err:.3e}, positions "
                  f"{pos_err:.3e} A)")
            sharded_rebuild_check(f"sharded isQEq={isq}", a["e"])
            no_sweep(f"sharded graphs isQEq={isq}")
            e = a["e"]
            n = e.n
            rows = e._block.keep.shape[0]
            for mode, r in runs.items():
                idle = ("not measured" if r["idle"] is None
                        else f"{r['idle']:.3f}")
                log(f"sharded graphs | isQEq={isq} {mode} | {n} atoms, "
                    f"float32, mesh (1, 1, 1), 1 NCCL rank, rows {rows} of "
                    f"{e.mext}, {steps} steps from one start: "
                    f"{r['wall'] / steps * 1e3:.2f} ms/step wall, "
                    f"{n * steps / r['wall']:.4e} atom-steps/s; blocks / "
                    f"steps / rebuilds / drift rebuilds {r['counts']}; "
                    f"captures {r['caps']:.0f} in {r['cap_ms']:.1f} ms, "
                    f"replays {r['reps']:.0f}, first uses {r['first']}; CG "
                    f"iterations {r['iters']}; peak {r['peak']:.1f} MB; "
                    f"after 10 steps more, 10 under torch.profiler: device "
                    f"{r['busy']:.2f} of {r['pwall']:.2f} ms, idle share "
                    f"{idle}, captures {r['prof'][0]:.0f}, replays "
                    f"{r['prof'][2]:.0f}; window buckets {r['sizes']} | "
                    f"{smi}")
            log(f"sharded graphs | isQEq={isq}: PRINTE PE graphs vs eager "
                f"max rel diff {err:.3e} (bound {TOL_GRAPH_PE}); replay "
                f"after a rebuild vs eager: PE {pe_err:.3e}, positions "
                f"{pos_err:.3e} A")
            del runs, a, b, e
        sharded_optimizer(mc, iters, smi)
    finally:
        comm.destroy()
    count = torch.cuda.device_count()
    if count >= 2:
        err, rec, _ = dryrun.run(min(count, 8), DEVICE, mc=mc,
                                 dtype="float32", tol=TOL_TE)
        log(f"sharded graphs | {min(count, 8)} NCCL ranks, mesh "
            f"{rec['mesh']}: 3 steps (first use, capture, replay) with "
            f"their sends, receives and all-reduces captured, PE against "
            f"md.Engine {err:.3e} of |PE| (bound {TOL_TE}); captures "
            f"{rec['captures']:.0f}, replays {rec['replays']:.0f} | {smi}")
    else:
        log(f"sharded graphs | multi-rank graphs (captured sends and "
            f"receives): not run, NCCL runs one rank a card and this "
            f"machine has {count} (torch.cuda.device_count())")
    log(f"sharded graphs: phase took {time.perf_counter() - t_phase:.1f} s"
        f" | {smi}")


def sharded_optimizer(mc, iters, smi):
    """Phase 13's optimizer: `iters` CG iterations of the sharded engine
    (mdmode 10) with graphs and eagerly from one start, then graph probes
    against eager probes at three of the positions the graph run
    probed."""
    from rxmd_tpu_torch import opt
    runs = {}
    for mode in ("graphs", "eager"):
        e = sharded_engine(mc, mdmode=10)
        e.graphs = mode == "graphs"
        seen, resyncs = [], []
        evaluate = e.cg_evaluate
        e.cg_evaluate = lambda pos, f=evaluate: (seen.append(pos),
                                                 f(pos))[1]

        def resync(*a, f=e.cg_resync):
            out, reads = counted_reads(lambda: f(*a))
            resyncs.append(len(reads))
            return out
        e.cg_resync = resync
        lines, ends = [], []
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pe_end = opt.conjugate_gradient(
            e, max_iter=iters, log=lines.append,
            writer=lambda it, pos, p: ends.append(
                (p, time.perf_counter(), len(seen))))
        no_sweep(f"sharded optimizer {mode}")
        seq = [float(lines[0].split("PE0=")[1])] + [p for p, _, _ in ends]
        check(len(ends) == iters and all(np.isfinite(seq))
              and all(y <= x for x, y in zip(seq, seq[1:]))
              and pe_end == seq[-1],
              f"sharded optimizer {mode}: PE does not rise over {iters} "
              f"iterations ({seq})")
        tm = e.timers
        caps, cap_s, reps = graph_counts(tm)
        runs_n = len(seen) + tm.counters.get("probe regrowths", 0)
        check(len(resyncs) == iters and set(resyncs) == {1},
              f"sharded optimizer {mode}: one host read a resync "
              f"({resyncs})")
        rb = rebuild_counts(e)
        if e.graphs:
            pg = e._probe_graphs
            first = len(pg.seen)
            check(pg.captures >= 1 and pg.replays == runs_n - first,
                  f"sharded optimizer: {pg.captures} captures, "
                  f"{pg.replays} replays of {runs_n} probes run ({first} "
                  "keys first run eagerly): every other probe a replay")
            # the resync program: its first use eagerly, then a capture
            # and replays
            check(rb == (1, iters - 1, 1),
                  f"sharded optimizer: the resyncs a program after their "
                  f"first use (captures, replays, first uses {rb})")
        else:
            check(caps == reps == 0 and rb == (0, 0, 0),
                  "sharded optimizer: no graph eagerly")
        ts = [t0] + [t for _, t, _ in ends]
        nps = [0] + [k for _, _, k in ends]
        runs[mode] = dict(e=e, seen=seen, seq=seq, caps=caps,
                          cap_ms=cap_s * 1e3, reps=reps, runs=runs_n, rb=rb,
                          per_it=[y - x for x, y in zip(ts, ts[1:])],
                          probes=[y - x for x, y in zip(nps, nps[1:])])
    e = runs["graphs"]["e"]
    del e.cg_evaluate, e.cg_resync
    seen = runs["graphs"]["seen"]
    diffs = []
    for i in np.linspace(0, len(seen) - 1, 3).astype(int):
        e.graphs = True
        x = e.cg_evaluate(seen[i])
        e.graphs = False
        y = e.cg_evaluate(seen[i])
        diffs.append(probe_diff(x, y))
        check_probe_diff(f"sharded optimizer probe {i}", diffs[-1], False)
    e.graphs = True
    worst = np.max(diffs, axis=0)
    for mode, r in runs.items():
        spi = [round(x, 4) for x in r["per_it"]]
        spp = [round(t / max(k, 1), 4) for t, k in zip(r["per_it"],
                                                        r["probes"])]
        log(f"sharded graphs | optimizer {mode} | {e.n} atoms, float32, "
            f"mesh (1, 1, 1), {iters} iterations: seconds per iteration "
            f"{spi}, probes per iteration {r['probes']} (the first with "
            f"the start's), seconds per probe {spp}; PE {r['seq']}; "
            f"captures {r['caps']:.0f} in {r['cap_ms']:.1f} ms, replays "
            f"{r['reps']:.0f} of {r['runs']} probes run and {iters} "
            f"resyncs (one host read each; resync captures, replays, "
            f"first uses {r['rb']}) | {smi}")
    log(f"sharded graphs | optimizer: graph vs eager probe at "
        f"{len(diffs)} recorded positions: max PE {worst[0]:.3e}, forces "
        f"{worst[1]:.3e} of max|f|, charges {worst[2]:.3e} e (bounds "
        f"{TOL_PROBE_PE}, {TOL_PROBE_F}, {TOL_PROBE_Q})")
    del runs, e
    torch.cuda.empty_cache()


def zero_launches():
    from rxmd_tpu_torch.ops import pairsweep as ps
    for k in ps.launches:
        ps.launches[k] = 0


def read_launches(what, engine):
    """The launch counts of the run just ended on `engine`, which began at
    its construction with the counts at 0: nonbond ran, qeq_build once per
    QEq solve, and qeq_apply once per matvec: the gradient's and
    qeq.CG_CHUNK per chunk of CG iterations run, so per solve from its
    iterations + 1 to its iterations + 1 + CG_CHUNK (under graphs too: a
    replay adds the launches its graphs hold)."""
    from rxmd_tpu_torch import qeq
    from rxmd_tpu_torch.ops import pairsweep as ps
    torch.cuda.synchronize()
    got = dict(ps.launches)
    solves, iters = engine.qeq_solves, int(engine.cg_iters)
    check(got["nonbond"] > 0, f"{what}: nonbond launched ({got})")
    check(got["qeq_build"] == solves > 0,
          f"{what}: qeq_build launches {got['qeq_build']} == QEq solves "
          f"{solves}")
    check(iters + solves <= got["qeq_apply"]
          <= iters + solves * (1 + qeq.CG_CHUNK),
          f"{what}: qeq_apply launches {got['qeq_apply']} within CG "
          f"iterations + solves {iters + solves} and + {qeq.CG_CHUNK} a "
          "solve")
    return got


class Tee:
    """stdout that also keeps what was written."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        self.parts.append(s)
        return sys.__stdout__.write(s)

    def flush(self):
        sys.__stdout__.flush()

    def text(self):
        return "".join(self.parts)


def run_main(argv):
    """rxmd_tpu_torch.__main__.main in this process (so the launch counts
    can be read), its output echoed and returned, with the engine it ran;
    the engine's `start_state` is its state when `run` began."""
    from rxmd_tpu_torch import __main__ as prog, md
    engines = []
    run = md.Engine.run

    def spy(self, *a, **k):
        engines.append(self)
        self.start_state = self.state
        return run(self, *a, **k)
    tee = Tee()
    md.Engine.run, old = spy, sys.stdout
    sys.stdout = tee
    try:
        rc = prog.main(argv, device=DEVICE)
    finally:
        md.Engine.run, sys.stdout = run, old
    check(rc == 0, f"main {' '.join(argv[-4:])} returned {rc}")
    return tee.text(), engines[0]


def printe_pe(text):
    """(step, PE per atom) of each PRINTE line."""
    rows = [x.split() for x in text.splitlines() if x.startswith("MDstep:")]
    return [(int(r[1]), float(r[3])) for r in rows]


def xyz_writer(eng, tmp, reps=3):
    """Phase 6's .xyz writer: which one `traj.write_xyz` ran (the port's
    csrc/trajio.cpp, built by the host C++ compiler, through ctypes), its
    ms against the Python formatting (`write_xyz_plain`) on one frame of
    the engine's state, the two files' bytes equal, and the trajectory
    output's share of the run's loop (all four formats)."""
    import filecmp
    from rxmd_tpu_torch.io import traj
    st, names = eng.state, eng.ff.atom_names
    ms = {}
    for name, write in (("native", traj.write_xyz),
                        ("plain", traj.write_xyz_plain)):
        path = os.path.join(tmp, f"frame_{name}.xyz")
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            write(path, st, names)
            ts.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(ts))
    same = filecmp.cmp(os.path.join(tmp, "frame_native.xyz"),
                       os.path.join(tmp, "frame_plain.xyz"), shallow=False)
    check(same and traj._lib is not None,
          "program: the native .xyz writer ran, its bytes the plain "
          "writer's")
    tm = eng.timers
    out, loop = tm.acc["trajectory output"], tm.acc["MD loop (wall)"]
    log(f"program | xyz writer: traj.write_xyz through "
        f"{os.path.relpath(traj.build(), REPO)} (rxmd_tpu_torch/csrc/"
        f"trajio.cpp, host C++ compiler, ctypes); one {st.n}-atom frame "
        f"{ms['native']:.2f} ms native, {ms['plain']:.2f} ms plain (Python "
        f"formatting), median of {reps}, bytes equal; trajectory output "
        f"{out:.3f} s of the {loop:.3f} s loop ({out / loop:.4f}; "
        f"{tm.ncalls['trajectory output']} frames in xyz, pdb, bnd and "
        f"bin) | {nvidia_smi()}")


def phase_program(mc, steps):
    """The port as a program at full width: geninit, then `main` from
    rxff.bin (mdmode 5, frames in all four formats), a restart from its
    rxff.npz (mdmode 1), mdmode 7 with a field and springs, and two
    iterations of the CG optimizer on an engine built as main builds it."""
    from rxmd_tpu_torch import config, ffield, md, opt
    from rxmd_tpu_torch.io import checkpoint, refbin, traj
    from rxmd_tpu_torch.tools import geninit
    with tempfile.TemporaryDirectory() as tmp:
        dat = os.path.join(tmp, "DAT")
        check(geninit.main(["-i", CELL, "-f", FFIELD, "-o", dat, "-mc",
                            *map(str, mc)]) == 0, "geninit")
        os.remove(os.path.join(dat, "rxff.npz"))
        # the in-repo deck's rxmd.in (full-CG QEq at 1e-7), with overrides
        base = ["--rxmdin", RXMD_IN, "--ffield", FFIELD, "--outDir", dat,
                "--dtype", "float32"]

        # 1. main from rxff.bin: mdmode 5 every 10 steps, PRINTE every 5,
        #    frames in all four formats every 10
        zero_launches()
        out, eng = run_main(base + [
            "--mdmode", "5", "--sstep", "10", "--ntime_step", str(steps),
            "--pstep", "5", "--fstep", "10", "--isBinary",
            "--isBondFile", "--isPDB", "--isXYZ"])
        got = read_launches("main", eng)
        check(got["nonbond"] == steps + 1,
              f"main: nonbond launches {got['nonbond']} == steps + 1")
        pe = printe_pe(out)
        check(len(pe) == steps // 5 + 1 and all(np.isfinite(p) for _, p in pe),
              "main: finite PRINTE lines")
        n = eng.state.n
        for step in (0, 10):
            for ext in ("xyz", "pdb", "bnd", "bin"):
                path = os.path.join(dat, f"{step:09d}.{ext}")
                check(os.path.exists(path), f"frame {path}")
            fr = next(traj.read_xyz_frames(os.path.join(dat, f"{step:09d}.xyz")))
            check(fr["pos"].shape == (n, 3) and np.isfinite(fr["pos"]).all(),
                  f"frame {step}: {n} finite positions")
            for ext in ("pdb", "bnd"):
                with open(os.path.join(dat, f"{step:09d}.{ext}")) as fh:
                    check(sum(1 for _ in fh) == n, f"frame {step}.{ext} rows")
            fb, _ = refbin.read_rxff_bin(os.path.join(dat, f"{step:09d}.bin"))
            check(fb.n == n and fb.step == step
                  and bool(torch.isfinite(fb.pos).all()),
                  f"frame {step}.bin: {n} finite positions at step {step}")
        with np.load(os.path.join(dat, "rxff.npz")) as z:
            check(int(z["step"]) == steps, "rxff.npz step")
        log(f"program: {n} atoms, launches {got}, CG iterations "
            f"{int(eng.cg_iters)}")
        xyz_writer(eng, tmp)
        # the last PRINTE line's PE comes from the term lists cached at the
        # last rebuild; a restart builds them anew, so hold it to the same
        # state evaluated on fresh lists (prepare, as the restart does)
        pe_fresh = float(eng.prepare()[0]) / n
        log(f"last PE {pe[-1][1]:.6e} on the cached term lists, "
            f"{pe_fresh:.6e} on fresh ones: rel diff "
            f"{abs(pe_fresh - pe[-1][1]) / abs(pe_fresh):.3e}")
        del eng

        # 2. restart from rxff.npz, NVE
        zero_launches()
        out2, eng2 = run_main(base + ["--mdmode", "1", "--ntime_step",
                                      "10", "--pstep", "5"])
        got = read_launches("restart", eng2)
        head = [x for x in out2.splitlines() if "CURRENTSTEP" in x]
        check(head and head[0].split()[-2] == str(steps),
              f"restart header CURRENTSTEP {steps}: {head}")
        pe2 = printe_pe(out2)
        rel = abs(pe2[0][1] - pe_fresh) / abs(pe_fresh)
        log(f"restart: first PE {pe2[0][1]:.6e} against the first run's end "
            f"state {pe_fresh:.6e}: rel diff {rel:.3e} (bound {TOL_TE}); "
            f"launches {got}")
        check(pe2[0][0] == steps and rel <= TOL_TE, "restart PE")

        # 3. mdmode 7 with a field along z and springs on C and O
        zero_launches()
        out3, eng3 = run_main(base + [
            "--mdmode", "7", "--sstep", "5", "--ntime_step", "10",
            "--pstep", "5", "--efield", "3", "0.05", "--spring", "2.0",
            "1", "3"])
        got = read_launches("mdmode 7", eng3)
        pe3 = printe_pe(out3)
        check(len(pe3) == 3 and all(np.isfinite(p) for _, p in pe3)
              and bool(torch.isfinite(eng3.state.vel).all()),
              "mdmode 7 with field and springs: finite output")
        check(eng3.cfg.isEfield and eng3.cfg.spring_const == 2.0,
              "field and springs on")
        log(f"mdmode 7, field and springs: launches {got}")

        # 4. the CG optimizer, on an engine built as main builds it
        cfg = config.parse_rxmd_in(RXMD_IN)
        cfg = config.apply_cli(cfg, config.cli_parser().parse_args(
            base + ["--mdmode", "10"]))
        ff = ffield.parse_ffield(cfg.ffield_path)
        st = checkpoint.load(os.path.join(dat, "rxff.npz"), torch.float32)
        e = md.Engine(ff, st, cfg, dtype=torch.float32, device=DEVICE)
        pes, lines = [], []

        def sink(x):
            lines.append(x)
            log(x)
        zero_launches()
        t0 = time.perf_counter()
        pe_end = opt.conjugate_gradient(
            e, max_iter=2, log=sink,
            writer=lambda it, pos, p: pes.append((p, time.perf_counter())))
        got = read_launches("optimizer", e)
        seq = [float(lines[0].split("PE0=")[1])] + [p for p, _ in pes]
        ts = [t0] + [t for _, t in pes]
        per_it = [b - a for a, b in zip(ts, ts[1:])]
        caps, cap_s, reps = graph_counts(e.timers)
        log(f"optimizer: PE {seq}, seconds per iteration "
            f"{[round(x, 3) for x in per_it]}, launches {got}, probes "
            f"{e.qeq_solves} as the probe program: captures {caps:.0f} in "
            f"{cap_s * 1e3:.1f} ms, replays {reps:.0f}")
        check(len(pes) == 2 and all(b <= a for a, b in zip(seq, seq[1:]))
              and pe_end == seq[-1], "optimizer: PE does not rise over two "
              "iterations")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mc", nargs=3, type=int, default=(4, 4, 3))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from rxmd_tpu_torch import native
    from rxmd_tpu_torch.ops import pairsweep as ps
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    so, secs, msgs = native.build(ps._SRC, force=True, verbose=True)
    log(f"build: nvcc {SOURCE} -> {os.path.relpath(so, REPO)} in "
        f"{secs:.1f} s")
    for line in msgs.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "stack frame")):
            log(f"  ptxas: {line.strip()}")

    mc = tuple(args.mc)
    e, kres, launches = phase_slice(mc, args.steps, args.seed)
    hres = phase_hbond(mc, smi)
    tres = phase_torsion(mc, smi)
    nres = phase_nonbond_list((mc, tuple(2 * k for k in mc)), smi)
    phase_small_reference(args.seed)
    phase_timing(e, mc, args.steps, args.seed)
    del e
    phase_program(mc, args.steps)
    phase_pair_paths(mc, args.seed)
    phase_pqeq_lg(mc, args.seed)
    phase_sharded(mc, args.seed)
    phase_graphs(mc, args.seed)
    phase_graph_paths(mc, args.seed)
    phase_optimizer_program(mc, args.seed)
    phase_sharded_graphs(mc, args.seed)
    phase_rebuild_programs(smi)

    rec = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches[name], **kres[name]}
        for name in KERNELS] + [
        {"name": "hbond", "route": "cuda", "source": HB_SOURCE,
         "replaces": "none (the autograd grid of reax.e_hbond)", **hres},
        {"name": "torsion", "route": "cuda", "source": TOR_SOURCE,
         "replaces": "none (the autograd grid of reax.build_torsion_list)",
         **tres},
        {"name": "nonbond_list", "route": "cuda", "source": NBL_SOURCE,
         "replaces": "none (the (n, knb) planes of "
                     "reax.nonbond_cf_energy_forces)", **nres}]}
    log(json.dumps(rec))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
