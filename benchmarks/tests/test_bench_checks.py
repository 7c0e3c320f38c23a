"""What decides `correct`, on a deck that a CPU test run holds: a sound run
of each cell passes its limits; the control (the reference in bfloat16 put
in the program's place) fails them; and a run whose timed path is broken
underneath fails them, once for each fault that the cell can have (a step
that returns its state unchanged; half of the atoms left out, the rest
counted double; an answer altered where it is produced).  A cell runs on
one chip, so it has no exchange between chips to leave out."""
import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_small  # noqa: E402

from harness import judge, spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 5000000011


def md_fault(kind):
    """A replacement of md.Engine._step_fn with the fault `kind`."""
    from rxmd_tpu_torch import md
    orig = md.Engine._step_fn

    def step(self, s, *a, **k):
        o = orig(self, s, *a, **k)
        if kind == "unchanged":
            return o._replace(state=dataclasses.replace(
                s, step=o.state.step))
        if kind == "half":
            f = o.force.clone()
            n = f.shape[0] // 2
            f[:n] *= 2.0
            f[n:] = 0.0
            return o._replace(force=f)
        q = o.state.q.clone()              # "altered": one atom's charge
        q[0] += 0.2
        return o._replace(state=dataclasses.replace(o.state, q=q))
    return md.Engine, "_step_fn", step


def relax_fault(kind):
    """A replacement with the fault `kind` in the optimizer's path: the
    iterate never moves (the adapter hands back the engine's positions),
    the probe's forces over half of the atoms, or its PE altered."""
    from rxmd_tpu_torch import md, opt
    if kind == "unchanged":
        def resync(self, pos, g, p):
            return self.engine.state.pos, g, p
        return opt._MDAdapter, "resync", resync
    orig = md.Engine.probe

    def probe(self, pos, hinv=None):
        pe, f, q = orig(self, pos, hinv)
        if kind == "half":
            f = f.clone()
            n = f.shape[0] // 2
            f[:n] *= 2.0
            f[n:] = 0.0
            return pe, f, q
        return pe * (1.0 + 1e-3), f, q
    return md.Engine, "probe", probe


def _cell(name):
    return bench_small.small_cell(name)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_and_control(name):
    ok, nums, ctl = bench_small.run(_cell(name), SEED, control=True)
    assert ok, nums
    cell = _cell(name)
    assert not judge.verdict(ctl, cell.limits)[0], ctl


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault, monkeypatch):
    cell = _cell(name)
    make = md_fault if cell.traffic["kind"] == "md" else relax_fault
    owner, attr, repl = make(fault)
    monkeypatch.setattr(owner, attr, repl)
    try:
        ok, nums, _ = bench_small.run(cell, SEED)
    except RuntimeError as err:          # a fault the port itself refuses
        pytest.skip(f"the port raised: {err}")
    assert not ok, nums
