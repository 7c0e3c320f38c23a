"""md.Engine's pair-list and dense engines, triclinic boxes, uncached
terms and tighten_lists: rxmd_tpu_torch against rxmd_tpu's Engine on the
same decks and configurations, prepare plus a few steps with
rebuild_every=2 so the wrap and the list rebuilds run.

Configurations (float64 unless named):
  * "defaults": the 168-atom cell with both packages' defaults, the
    interpolation tables over the pair list (before this engine the port
    ran the closed form there and parted from rxmd_tpu by the tables'
    interpolation error);
  * "tric_*": the cell's fractional coordinates under the lattice angles
    (95, 100, 105) degrees: the closed form with full CG, the tables with
    the extended Lagrangian;
  * "dense": pair_kernel=False with the closed form on the (2, 2, 2)
    replica (1,344 atoms, min L 21.4 A): the dense forms in both;
  * "uncached_tight": term_cache=False with tighten_lists=True;
  * "f32": float32, pair_kernel=False on the cell (the closed-form pair
    list in both).
Each run asserts the pair engine both packages chose.

QEq is capped at NMAXQEq CG iterations (10 for full CG, 4 for exL's cold
start): the two packages' summation orders part by ~3e-11 e after 10
iterations and the CG amplifies it (test_torch_pairpath.py), so a capped
solve keeps per-step parity deterministic.  Bars: float64, PE components
within 1e-8 relative and positions within 1e-8 A at every step; float32,
each component within 1e-5 of |PE| and positions within 1e-5 A.
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
NSTEPS = 3
TRICLINIC = (95.0, 100.0, 105.0)

FULL_CG = dict(isQEq=1, NMAXQEq=10)
EXL = dict(isQEq=2, NMAXQEq=4)
CONFIGS = {
    "defaults": ("cell", dict(FULL_CG), "ell"),
    "tric_closed_cg": ("tric", dict(FULL_CG, nonbond_closed_form=True),
                       "ell"),
    "tric_tables_exl": ("tric", dict(EXL), "ell"),
    "dense": ("x2", dict(EXL, pair_kernel=False, nonbond_closed_form=True),
              "dense"),
    "uncached_tight": ("cell", dict(EXL, term_cache=False,
                                    tighten_lists=True), "ell"),
    "f32": ("cell", dict(EXL, dtype="float32", pair_kernel=False), "ell"),
}


def deck_arrays(kind, name_to_type):
    """(pos, types, H) of "cell", "tric" or "x2" (see the docstring)."""
    frac, types, cell = tsys.read_geninit_xyz(CELL, name_to_type)
    if kind == "tric":
        cell = cell[:3] + TRICLINIC
    frac, types, cell = tsys.replicate(frac, types, cell,
                                       (2, 2, 2) if kind == "x2" else (1,) * 3)
    H = tsys.box_matrix(*cell)
    return frac @ H.T, types, H


def _states(kind):
    ff = jff.parse_ffield(FF)
    pos, types, H = deck_arrays(kind, ff.name_to_type)
    return ff, jsys.make_state(pos, types, H), tsys.make_state(pos, types, H)


def _jax_engine_kind(je):
    if je.pairk is not None:
        return "sweep"
    return "dense" if je.dense_direct else "ell"


def _trajectory(engine, to_np, nsteps):
    engine.init_velocity(seed=1)
    comps = [to_np(engine.prepare())]
    pos = [to_np(engine.state.pos)]
    for _ in range(nsteps):
        engine.run(1, log=None)
        comps.append(to_np(engine.comps))
        pos.append(to_np(engine.state.pos))
    return np.array(comps, np.float64), np.array(pos, np.float64)


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    kind, over, engine = CONFIGS[request.param]
    kw = dict(dict(dtype="float64", QEq_tol=1e-12, rebuild_every=2,
                   pstep=1), **over)
    ff, js, ts = _states(kind)
    je = jmd.Engine(ff, js, jcfg.RunConfig(block_steps=1, **kw))
    te = tmd.Engine(tff.parse_ffield(FF), ts,
                    tcfg.RunConfig(block_steps=1, **kw),
                    device="cpu")
    jc, jp = _trajectory(je, np.asarray, NSTEPS)
    tc, tp = _trajectory(te, lambda x: x.cpu().numpy(), NSTEPS)
    return dict(name=request.param, engine=engine, je=je, te=te, jc=jc,
                jp=jp, tc=tc, tp=tp)


def test_pair_engine_as_rxmd_tpu(runs):
    assert runs["te"].pair_engine == runs["engine"]
    assert _jax_engine_kind(runs["je"]) == runs["engine"]


def test_pe_components_per_step(runs):
    jc, tc = runs["jc"], runs["tc"]
    assert np.isfinite(tc).all()
    if runs["name"] == "f32":
        err = np.abs(jc - tc) / np.abs(jc[:, :1])
        bar = 1e-5
    else:
        err = np.abs(jc - tc) / np.maximum(np.abs(jc), 1.0)
        bar = 1e-8
    assert err.max() <= bar, (err.max(), np.unravel_index(err.argmax(),
                                                           err.shape))
    # every term is live
    assert (np.abs(tc[:, 1:14]) > 0).sum(axis=1).min() >= 12


def test_positions_per_step(runs):
    bar = 1e-5 if runs["name"] == "f32" else 1e-8
    assert np.abs(runs["jp"] - runs["tp"]).max() <= bar
    assert runs["te"]._steps_since_rebuild == 1       # rebuilt before step 3


def test_defaults_route_to_the_tables():
    """The float64 default is the tables; the sweep needs the closed form,
    an orthogonal box and cached lists, and pair_kernel=True on anything
    else raises, naming why."""
    tf = tff.parse_ffield(FF)
    _, _, cell = _states("cell")
    _, _, tric = _states("tric")
    e = tmd.Engine(tf, cell, tcfg.RunConfig(), device="cpu")
    assert e.pair_engine == "ell" and not e.closed_form \
        and not hasattr(e.pairs, "grid")
    e = tmd.Engine(tf, cell, tcfg.RunConfig(dtype="float32"), device="cpu")
    assert e.pair_engine == "sweep" and e.closed_form
    for cfg, why in ((dict(nonbond_closed_form=False), "tables"),
                     (dict(term_cache=False), "term_cache"),
                     (dict(tighten_lists=True), "tighten_lists")):
        with pytest.raises(ValueError, match=why):
            tmd.Engine(tf, cell, tcfg.RunConfig(dtype="float32",
                                                pair_kernel=True, **cfg),
                       device="cpu")
    with pytest.raises(ValueError, match="triclinic"):
        tmd.Engine(tf, tric, tcfg.RunConfig(dtype="float32",
                                            pair_kernel=True), device="cpu")


@pytest.fixture(scope="module")
def optimizer_runs():
    """One optimizer iteration on the triclinic cell with the float64
    defaults (the table pair list in both), every probe's PE recorded."""
    kw = dict(dtype="float64", QEq_tol=1e-12, mdmode=10, NMAXQEq=10)
    ff, js, ts = _states("tric")
    probes = {"jax": [], "port": []}

    def recording(cls, store):
        evaluate = cls.evaluate

        def wrapped(self, pos):
            out = evaluate(self, pos)
            store.append(float(out[0]))
            return out
        return wrapped
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt._MDAdapter, "evaluate",
                   recording(jopt._MDAdapter, probes["jax"]))
        mp.setattr(topt._MDAdapter, "evaluate",
                   recording(topt._MDAdapter, probes["port"]))
        je = jmd.Engine(ff, js, jcfg.RunConfig(block_steps=1, **kw))
        jpe = jopt.conjugate_gradient(je, max_iter=1, log=None)
        te = tmd.Engine(tff.parse_ffield(FF), ts,
                        tcfg.RunConfig(block_steps=1, **kw),
                        device="cpu")
        tpe = topt.conjugate_gradient(te, max_iter=1, log=None)
    return te, probes, jpe, tpe


def test_optimizer_on_the_pair_list(optimizer_runs):
    te, probes, jpe, tpe = optimizer_runs
    assert te.pair_engine == "ell" and not hasattr(te.pairs, "grid")
    pj, pt = np.array(probes["jax"]), np.array(probes["port"])
    assert len(pj) == len(pt) > 2
    assert np.abs(pt - pj).max() <= 1e-8 * np.abs(pj).max()
    assert tpe < pt[0] and abs(tpe - jpe) <= 1e-8 * abs(jpe)
