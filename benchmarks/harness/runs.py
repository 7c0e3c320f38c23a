"""One run of a cell, by the traffic mix's kind ("md", "relax", or
"md_sharded": harness/sharded.py), and the check of what it produced
against the reference.

`KINDS[kind](cell, seed, seconds, trace, device, t0)` makes the inputs,
sets the port up, drives the window (and with `trace` the counted and
profiled parts), keeps what the check needs, frees the port and returns
dict(values: the end-to-end metrics, art: what the per-layer readers read,
prof, attempted, peak, setup_parts: the set-up's seconds by part, and the
check's inputs; md_sharded's rank 0 adds `ranks`, its other ranks return
None).  `check(r, device, control)` runs the float64 reference
on them: (numbers, and with `control` the control's numbers: the same
reference in bfloat16 put in the program's place).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from reference.evaluate import Evaluator

from . import deck, drive, judge, port, roofline
from . import trace as tracing


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _reset_peak(device):
    """Start the count of peak device memory (the allocator initialized
    first: a reset before the first allocation is refused)."""
    if device.type == "cuda":
        torch.empty(0, device=device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


class SetupClock:
    """The set-up's parts: the seconds from the process start (t0), or
    from the last mark, to each mark."""

    def __init__(self, t0):
        self.last, self.parts = t0, {}

    def mark(self, name):
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


def _setup(cell, seed, device, t0):
    """(inputs, engine, clock) with the set-up's parts up to the engine."""
    clock = SetupClock(t0)
    clock.mark("imports_s")
    inputs = deck.make(cell.config, cell.traffic, seed)
    clock.mark("inputs_s")
    _reset_peak(device)
    clock.mark("device_s")
    eng = port.engine(cell.config, cell.traffic, inputs, device)
    clock.mark("engine_s")
    return inputs, eng, clock


def md(cell, seed, seconds, trace, device, t0):
    inputs, eng, clock = _setup(cell, seed, device, t0)
    log, start = drive.md_setup(eng, cell.traffic)
    clock.mark("warmup_s")
    setup_s = time.perf_counter() - t0
    win = drive.md_window(eng, cell.traffic, seconds, log, count_reads=trace)
    peak = _peak(device)
    n = inputs.pos.shape[0]
    art = dict(win, n=n, peak_bytes=peak)
    prof = None
    if trace:
        pairs0 = roofline.count_pairs(eng.state.pos, inputs.H)
        prof = tracing.profiled(
            lambda: eng.run(cell.traffic["trace_steps"], log=log))
        pairs1 = roofline.count_pairs(eng.state.pos, inputs.H)
        art.update(trace=prof, pairs=0.5 * (pairs0[0] + pairs1[0]),
                   pairs_distinct=0.5 * (pairs0[1] + pairs1[1]))
    end = port.snapshot(eng, bo_sum=port.bond_sums(eng))
    eng.run(1, log=None)
    snaps = dict(start=start, end=end, next=port.snapshot(eng))
    cfg = eng.cfg
    run = dict(isQEq=cfg.isQEq, Lex_fqs=cfg.Lex_fqs, mdmode=cfg.mdmode,
               sstep=cfg.sstep, treq=cfg.treq, dt_fs=cfg.dt_fs)
    del eng
    free(device)
    values = dict(atom_steps_per_s=n * win["steps"] / win["wall_s"],
                  setup_s=setup_s)
    return dict(kind="md", values=values, art=art, prof=prof,
                attempted=win["steps"], peak=peak, inputs=inputs,
                snaps=snaps, run=run, setup_parts=clock.parts)


def relax(cell, seed, seconds, trace, device, t0):
    inputs, eng, clock = _setup(cell, seed, device, t0)
    box = drive.relax_setup(eng, cell.traffic)
    clock.mark("warmup_s")
    setup_s = time.perf_counter() - t0
    win = drive.relax_window(eng, cell.traffic, seconds, box,
                             count_reads=trace)
    if not win["iterations"]:
        raise RuntimeError("the optimizer ended before its first iteration")
    peak = _peak(device)
    art = dict(win, n=inputs.pos.shape[0], peak_bytes=peak)
    (x0, _), (xp, _), (xk, pek) = (win["path"][0], win["path"][-2],
                                   win["path"][-1])
    t = lambda a: torch.as_tensor(a, dtype=eng.dtype, device=device)
    # the optimizer's last iterate, which a window ended by the writer
    # hook did not commit
    eng.state = dataclasses.replace(eng.state, pos=t(xk))
    prof = None
    if trace:
        from rxmd_tpu_torch import opt
        box["record"] = []
        prof = tracing.profiled(lambda: opt.conjugate_gradient(
            eng, max_iter=cell.traffic["trace_iters"],
            ftol=cell.traffic["run_config"]["ftol"], log=None))
        # the pairs each probe of the traced iteration needed, counted
        # once the profile has closed
        pairs = [roofline.count_pairs(p, inputs.H) for p in box["record"]]
        box["record"] = None
        art.update(trace=prof,
                   pairs=sum(p[0] for p in pairs) / len(pairs),
                   pairs_distinct=sum(p[1] for p in pairs) / len(pairs))
        eng.state = dataclasses.replace(eng.state, pos=t(xk))
    host = lambda a: a.double().cpu().numpy()
    pe0, f0, q0 = box["first"]
    _, fk, qk = eng.probe(t(xk))
    prog = dict(start=dict(pe=float(pe0), force=host(f0), q=host(q0),
                           pos=x0),
                last=dict(pe=pek, force=host(fk), q=host(qk),
                          bo_sum=port.bond_sums(eng), pos=xk, prev=xp))
    del eng, box
    free(device)
    values = dict(relax_iter_s=win["wall_s"] / win["iterations"],
                  setup_s=setup_s)
    return dict(kind="relax", values=values, art=art, prof=prof,
                attempted=win["iterations"], peak=peak, inputs=inputs,
                prog=prog, setup_parts=clock.parts)


def md_sharded(cell, seed, seconds, trace, device, t0):
    from .sharded import md_sharded as run
    return run(cell, seed, seconds, trace, device, t0)


KINDS = {"md": md, "relax": relax, "md_sharded": md_sharded}


def _evaluator(r, dtype, device):
    i = r["inputs"]
    return Evaluator(i.ff, i.types, i.H, dtype=dtype, device=device)


def check(r, device, control=False):
    """(numbers, control numbers or None) of a run `r`."""
    R = _evaluator(r, torch.float64, device)
    if r["kind"] == "md":
        ref = judge.md_reference(R, r["snaps"], r["run"])
        nums = judge.md_numbers(r["snaps"], ref, r["inputs"].H)
        ctl = None
        if control:
            C = _evaluator(r, torch.bfloat16, device)
            ctl = judge.md_numbers(judge.md_reference(C, r["snaps"],
                                                      r["run"]),
                                   ref, r["inputs"].H)
        return nums, ctl
    p = r["prog"]
    ref = dict(start=R.evaluate(p["start"]["pos"]),
               last=R.evaluate(p["last"]["pos"]))
    nums = judge.relax_numbers(p, ref)
    ctl = None
    if control:
        C = _evaluator(r, torch.bfloat16, device)
        xc = judge.golden_along(C, p["last"]["prev"],
                                p["last"]["pos"] - p["last"]["prev"])
        cs, cl = C.evaluate(p["start"]["pos"]), C.evaluate(xc)
        as_prog = lambda o, **kw: dict(pe=o["comps"][0], force=o["force"],
                                       q=o["q"], bo_sum=o["bo_sum"], **kw)
        cprog = dict(start=as_prog(cs, pos=p["start"]["pos"]),
                     last=as_prog(cl, pos=xc, prev=p["last"]["prev"]))
        ctl = judge.relax_numbers(cprog, dict(start=ref["start"],
                                              last=R.evaluate(xc)))
    return nums, ctl
