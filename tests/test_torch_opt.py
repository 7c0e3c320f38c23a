"""The structural optimizer (mdmode 10): rxmd_tpu_torch.opt against
rxmd_tpu.opt on the 168-atom deck in float64, two CG iterations.

rxmd_tpu's probes take its uncached path (closed-form ELL nonbond, the
dense QEq hessian at this size, per-probe term enumeration); the port's
build fresh lists with exact gates and a fresh slot layout, and run the
pair sweep.  Both warm-start every probe's CG from the state's charges and
converge it to 1e-12.

Bars:
* every probe's PE within 1e-8 relative of rxmd_tpu's, probe by probe:
  the bracket and golden search are host-side comparisons of these
  energies, so the same count and values mean the same branches.  A
  mismatch is reported as a different branch, never absorbed.
* PE after each CG iteration within 1e-8 relative;
* final positions within 1e-7 A (one golden interval, 6e-9 in the step,
  times |p| ~ 1e2, bounds a branch taken differently at the last probe).
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    opt as jopt, system as jsys
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    opt as topt, system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
KW = dict(dtype="float64", QEq_tol=1e-12, mdmode=10, nonbond_closed_form=True)


def _recording(cls, store):
    """cls.evaluate that also appends each probe's PE to `store`."""
    evaluate = cls.evaluate

    def wrapped(self, pos):
        out = evaluate(self, pos)
        store.append(float(out[0]))
        return out
    return wrapped


@pytest.fixture(scope="module")
def runs():
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type)
    probes = {"jax": [], "port": []}
    iters = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt._MDAdapter, "evaluate",
                   _recording(jopt._MDAdapter, probes["jax"]))
        mp.setattr(topt._MDAdapter, "evaluate",
                   _recording(topt._MDAdapter, probes["port"]))
        je = jmd.Engine(ff, st, jcfg.RunConfig(block_steps=1, **KW))
        jpe = jopt.conjugate_gradient(
            je, max_iter=2, log=None,
            writer=lambda it, pos, pe: iters["jax"].append(pe))
        te = tmd.Engine(tff.parse_ffield(FF), tsys.state_from_numpy(
            {k: np.asarray(v) for k, v in vars(st).items()}),
            tcfg.RunConfig(block_steps=1, **KW), device="cpu")
        pos0 = te.state.pos.clone()
        tpe = topt.conjugate_gradient(
            te, max_iter=2, log=None,
            writer=lambda it, pos, pe: iters["port"].append(pe))
    return dict(je=je, te=te, jpe=jpe, tpe=tpe, probes=probes, iters=iters,
                pos0=pos0)


def test_line_search_takes_the_same_branches(runs):
    pj, pt = (np.array(runs["probes"][k]) for k in ("jax", "port"))
    assert len(pj) == len(pt), (
        f"the line search took a different branch: {len(pt)} probes in the "
        f"port, {len(pj)} in rxmd_tpu")
    err = np.abs(pt - pj) / np.abs(pj)
    k = int(err.argmax())
    assert err.max() <= 1e-8, (
        f"probe {k} of {len(pj)} differs by {err[k]:.3e} relative: a "
        "different branch or a different energy")


def test_pe_per_iteration(runs):
    ij, it = (np.array(runs["iters"][k]) for k in ("jax", "port"))
    assert len(ij) == len(it) == 2
    assert np.abs(it - ij).max() <= 1e-8 * np.abs(ij).max()
    # the optimizer went down, and returned its last PE
    assert it[1] < it[0] < runs["probes"]["port"][0]
    assert runs["tpe"] == it[-1]


def test_final_state(runs):
    je, te = runs["je"], runs["te"]
    assert np.abs(np.asarray(je.state.pos) - te.state.pos.numpy()).max() \
        <= 1e-7
    # commit wrote the final positions and charges into the engine state
    assert not torch.equal(te.state.pos, runs["pos0"])
    assert np.abs(np.asarray(je.state.q) - te.state.q.numpy()).max() <= 1e-8


def test_probe_leaves_its_input_untouched(runs):
    te = runs["te"]
    ad = topt._MDAdapter(te)
    pos = te.state.pos + 20.0          # outside the box: the probe wraps a copy
    before = pos.clone()
    pe, f, q = ad.evaluate(pos)
    assert torch.equal(pos, before)
    assert abs(float(pe) - runs["tpe"]) <= 1e-8 * abs(runs["tpe"])
    assert f.shape == (te.state.n, 3) and q.shape == (te.state.n,)


def test_other_engines_raise():
    with pytest.raises(TypeError, match="object"):
        topt.conjugate_gradient(object(), max_iter=1)
