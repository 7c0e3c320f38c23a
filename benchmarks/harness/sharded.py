"""The kind "md_sharded": MD of one deck on ShardedEngine, one process per
domain of the configuration's `mesh` (harness/launch.py starts them, one a
card; a one-domain mesh runs in the benchmark's own process).

Every rank makes the same inputs from the seed, builds its domain's engine
(port_sharded.py) and warms it with drive.md_setup: `prepare`, then
`warmup_steps` steps in calls of `chunk_steps`.  A barrier then lets the
latest rank set the window's start: `setup_s` runs from the launcher's
start to it.  The window is drive.md_window on every rank with a
collective stop: after each call of `run(chunk_steps)` rank 0's clock
decides whether `seconds` have passed, and one all-reduce hands the
decision to every rank, so all ranks run the same steps and stop
together.  `atom_steps_per_s` is the mesh's atoms times
those steps over rank 0's wall.  With `trace` every rank counts its host
reads in the window and profiles the same `trace_steps` after it; each
rank's artifacts (its timers session among them) go to rank 0, under
art["ranks"], rank 0's also at the top level, where the one-card readers
find them.

The check's inputs are gathered to rank 0 in global-id order: the start
(`prepare`'s outputs), the window's end with each atom's summed bond order
(each domain's own, port_sharded.bond_sums), and one more step.  The group
is left before rank 0 checks them against the reference, on its card
alone.  Rank 0 returns runs.md's dict, with `ranks` (each rank's peak
memory and traced device time); the other ranks return None.
"""
from __future__ import annotations

import functools
import time

import torch

from . import deck, drive, port_sharded, runs, session
from . import trace as tracing


def md_sharded(cell, seed, seconds, trace, device, t0):
    clock = runs.SetupClock(t0)
    clock.mark("imports_s")
    device, group = port_sharded.join(device)
    clock.mark("group_s")
    world = 1 if group is None else torch.distributed.get_world_size()
    mesh = cell.config["mesh"]
    if world != cell.chips or mesh[0] * mesh[1] * mesh[2] != cell.chips:
        raise RuntimeError(
            f"{cell.name} asks {cell.chips} card(s), its mesh {mesh}; "
            f"{world} rank(s) run")
    rank = port_sharded.rank(group)
    inputs = deck.make(cell.config, cell.traffic, seed)
    clock.mark("inputs_s")
    runs._reset_peak(device)
    clock.mark("device_s")
    eng = port_sharded.engine(cell.config, cell.traffic, inputs, device)
    clock.mark("engine_s")
    log, start = drive.md_setup(
        eng, cell.traffic,
        snapshot=functools.partial(port_sharded.snapshot, group=group))
    clock.mark("warmup_s")
    port_sharded.barrier(group)
    clock.mark("barrier_s")
    setup_s = time.perf_counter() - t0
    win = drive.md_window(
        eng, cell.traffic, seconds, log, count_reads=trace,
        stop=functools.partial(port_sharded.stop, group=group))
    peak = runs._peak(device)
    n = inputs.pos.shape[0]
    art = dict(win, n=n, peak_bytes=peak)
    prof = None
    if trace:
        prof = tracing.profiled(
            lambda: eng.run(cell.traffic["trace_steps"], log=log))
        art.update(trace=prof)
    end = port_sharded.snapshot(eng, group, bonds=True)
    eng.run(1, log=None)
    snaps = dict(start=start, end=end, next=port_sharded.snapshot(eng, group))
    cfg = eng.cfg
    run = dict(isQEq=cfg.isQEq, Lex_fqs=cfg.Lex_fqs, mdmode=cfg.mdmode,
               sstep=cfg.sstep, treq=cfg.treq, dt_fs=cfg.dt_fs)
    ranks = port_sharded.gather(
        dict(art, rank=rank, session=session.last() if trace else None),
        group)
    del eng
    runs.free(device)
    if group is not None:
        port_sharded.leave()
    if rank != 0:
        return None
    art["ranks"] = ranks
    values = dict(atom_steps_per_s=n * win["steps"] / win["wall_s"],
                  setup_s=setup_s)
    devs = [dict(rank=a["rank"], memory_peak_bytes=a["peak_bytes"],
                 **({} if a.get("trace") is None else
                    dict(busy_s=a["trace"]["busy_s"],
                         window_s=a["trace"]["window_s"])))
            for a in ranks]
    return dict(kind="md", values=values, art=art, prof=prof,
                attempted=win["steps"],
                peak=max(d["memory_peak_bytes"] for d in devs), ranks=devs,
                inputs=inputs, snaps=snaps, run=run,
                setup_parts=clock.parts)
