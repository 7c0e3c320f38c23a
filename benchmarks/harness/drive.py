"""Set-up, window and traced sub-window of a cell, on the port's own entry
points: `md.Engine.run` for MD, `opt.conjugate_gradient` for a relaxation.

MD: set-up runs `prepare`, then `warmup_steps` steps through `run` in
calls of `chunk_steps`, as the window calls it, so that every program key
the window uses is captured (a rebuild among them; the deck reaches the
window's temperature in them too).  The window calls `run(chunk_steps)`
until `seconds` have passed (on several cards, until `stop` hands every
rank rank 0's verdict); each call ends in a synchronize, so the
window's wall covers all of its work.  Its PRINTE lines are kept with the
host time at which each was printed.

Relaxation: set-up runs `warmup_probes` probes at the start positions (the
first sizes the QEq list, the second is the probe program's eager first
use, the third its capture).  The window runs the optimizer and ends at the
first iteration end past `seconds`, which the optimizer's per-iteration
`writer` hook sees; it ends there, or where the optimizer converges.
"""
from __future__ import annotations

import time

import torch

from . import port
from .trace import HostReads


class StopWindow(Exception):
    """Raised by the optimizer's writer hook at the window's end."""


class Log:
    """The `log` of `Engine.run`: each line with the host time it came."""

    def __init__(self):
        self.lines = []

    def __call__(self, line):
        self.lines.append((time.perf_counter(), line))

    def printe_times(self, since):
        """Host times of the PRINTE lines printed inside the loop after
        `since` (a run's closing PRINTE, followed by its "total" line, is
        not one of them)."""
        out = []
        for k, (t, line) in enumerate(self.lines):
            closing = (k + 1 < len(self.lines)
                       and self.lines[k + 1][1].startswith("total"))
            if t >= since and line.startswith("MDstep:") and not closing:
                out.append(t)
        return out


def _sync(eng):
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _counters(eng):
    tm = eng.timers
    return dict(qeq_iters=int(eng.cg_iters),
                rebuilds=tm.ncalls.get("neighbor rebuild", 0),
                captures=int(tm.counters.get("graph captures", 0)))


def md_setup(eng, traffic, snapshot=port.snapshot):
    """prepare (`snapshot` of its outputs: the start), then the warm-up."""
    log = Log()
    eng.prepare()
    start = snapshot(eng)
    chunk = traffic["chunk_steps"]
    for _ in range(traffic["warmup_steps"] // chunk):
        eng.run(chunk, log=log)
    _sync(eng)
    return log, start


def md_window(eng, traffic, seconds, log, count_reads=False,
              stop=lambda done: done):
    """The timed window: dict(steps, wall_s, printe_times, qeq_iters,
    rebuilds, captures[, host_reads]).  After each call `stop(this
    process's clock has passed seconds)` decides; host reads are counted
    inside the calls."""
    c0 = _counters(eng)
    reads = HostReads() if count_reads else None
    chunk = traffic["chunk_steps"]
    steps = 0
    t0 = time.perf_counter()
    while True:
        if reads:
            reads.__enter__()
        try:
            eng.run(chunk, log=log)
        finally:
            if reads:
                reads.__exit__(None, None, None)
        steps += chunk
        wall = time.perf_counter() - t0
        if stop(wall >= seconds):
            break
    c1 = _counters(eng)
    out = dict(steps=steps, wall_s=wall, printe_times=log.printe_times(t0),
               **{k: c1[k] - c0[k] for k in c0})
    if reads:
        out["host_reads"] = reads.n
    return out


def relax_setup(eng, traffic):
    """The warm-up probes at the start positions; counts every later probe
    (`probes`), keeps the first (PE, forces, charges): the start, and
    where `record` is a list, each probe's positions."""
    pos0 = eng.state.pos
    for _ in range(traffic["warmup_probes"]):
        eng.probe(pos0)
    _sync(eng)
    probe = eng.probe
    box = dict(probes=0, first=None, record=None)

    def counted(pos, hinv=None):
        box["probes"] += 1
        if box["record"] is not None:       # a traced iteration's probes
            box["record"].append(pos.detach().clone())
        out = probe(pos, hinv)
        if box["first"] is None:
            box["first"] = out        # (PE, forces, charges) on the device
        return out
    eng.probe = counted
    return box


def relax_window(eng, traffic, seconds, box, count_reads=False):
    """The optimizer from the engine's positions until the first iteration
    end past `seconds`: dict(iterations, wall_s, probes, captures, path
    [(positions, PE) at the start and each iteration end][, host_reads])."""
    from rxmd_tpu_torch import opt
    start = eng.state.pos.detach().double().cpu().numpy()
    c0, p0 = _counters(eng), box["probes"]
    reads = HostReads() if count_reads else None
    t0 = time.perf_counter()
    ends = []

    def writer(it, pos, pe):
        ends.append((time.perf_counter(), pos, pe))
        if ends[-1][0] - t0 >= seconds:
            raise StopWindow

    if reads:
        reads.__enter__()
    try:
        opt.conjugate_gradient(eng, max_iter=traffic["max_iter"],
                               ftol=traffic["run_config"]["ftol"], log=None,
                               writer=writer)
    except StopWindow:
        pass
    finally:
        if reads:
            reads.__exit__(None, None, None)
    # the iterates leave the device once the window has closed
    path = [(start, None)] + [(p.detach().double().cpu().numpy(), pe)
                              for _, p, pe in ends]
    c1 = _counters(eng)
    out = dict(iterations=len(ends),
               wall_s=ends[-1][0] - t0 if ends else None,
               probes=box["probes"] - p0, path=path,
               captures=c1["captures"] - c0["captures"])
    if reads:
        out["host_reads"] = reads.n
    return out
