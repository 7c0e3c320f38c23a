"""The optimizer's probe program (`md.Engine._probe_fn`, run by
`md.Engine.probe`, which `opt.conjugate_gradient` calls once per probe),
on the CPU in float64.

* Against the eager probe the port ran before it had the program (kept
  here as `_eager_probe`: a wrapped copy, the rebuild's lists with exact
  gates and, for the sweep, its slot layout and an exact-size QEq list,
  the solve, the forces over those lists): PE within 1e-10 relative,
  forces within 1e-10 of max|f|, charges within 1e-10 e, for the nine
  configurations of chip_smoke's `graph_path_configs()` and the sweep.
  The CG is capped (NMAXQEq 12), as in the other parity tests: the two
  sum the same terms in other orders, which a converging CG amplifies.
* Against rxmd_tpu's jitted `evaluate` (rxmd_tpu/opt.py:40-50) on the
  same positions, closed form on both sides, CG capped at 8: PE within
  1e-8 relative, forces within 1e-8 of max|f|, charges within 1e-8 e
  (test_torch_opt.py's bars).
* The probe's QEq list: a capacity below a probe's entries grows to the
  next bucket and the probe runs again, giving the exact-size result;
  an engine capacity (neighbor rows, the cell grid, a term list) below a
  probe's count raises, naming it.
* On a card a probe runs through a graph cache of its own
  (`Engine._probe_graphs`, a stand-in cache here), keyed by the QEq
  list's capacity; the sweep's first probe sizes the list eagerly.
* One `opt.conjugate_gradient` iteration on the pair list, probe by
  probe, against rxmd_tpu's (test_torch_opt.py runs the sweep's).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    opt as jopt, system as jsys
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    opt as topt, system as tsys

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
FF_LG = os.path.join(DATA, "ffield_chon_synth_lg")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
TRICLINIC = (95.0, 100.0, 105.0)

BASE = dict(dtype="float64", NMAXQEq=12, QEq_tol=1e-10, mdmode=10)
PQ = dict(isPQEq=True, pqeq_parm_path=PAR)
ELL = dict(pair_kernel=False, dense_direct_max=0)
# chip_smoke.graph_path_configs() and the sweep, at the CPU's sizes:
# name -> (deck, LG, config, pair engine)
CONFIGS = {
    "ell_closed": ("cell", False, dict(nonbond_closed_form=True, **ELL),
                   "ell"),
    "dense": ("x2", False, dict(nonbond_closed_form=True,
                                pair_kernel=False), "dense"),
    "ell_tables": ("cell", False, dict(), "ell"),
    "triclinic": ("tric", False, dict(), "ell"),
    "uncached": ("cell", False, dict(term_cache=False), "ell"),
    "tighten": ("cell", False, dict(tighten_lists=True), "ell"),
    "pqeq_isqeq1": ("cell", False, dict(isQEq=1, **PQ), "ell"),
    "pqeq_isqeq2": ("cell", False, dict(isQEq=2, **PQ), "ell"),
    "lg_dense": ("x2", True, dict(nonbond_closed_form=True), "dense"),
    "sweep": ("x2", False, dict(nonbond_closed_form=True), "sweep"),
}


def _deck(kind, lg=False):
    """The force field and the state of "cell" (168 atoms, brute-force
    neighbors), "tric" (its fractional coordinates under TRICLINIC) or
    "x2" (its (2, 2, 2) replica, 1,344 atoms: the cell list)."""
    ff = tff.parse_ffield(FF_LG if lg else FF, lg=lg)
    frac, types, cell = tsys.read_geninit_xyz(CELL, ff.name_to_type)
    if kind == "tric":
        cell = cell[:3] + TRICLINIC
    frac, types, cell = tsys.replicate(frac, types, cell,
                                       (2, 2, 2) if kind == "x2" else (1,) * 3)
    H = tsys.box_matrix(*cell)
    return ff, tsys.make_state(frac @ H.T, types, H)


def _engine(name, deck=None, **over):
    """The engine of CONFIGS[name], on `deck` if given."""
    kind, lg, cfg, want = CONFIGS[name]
    ff, st = _deck(deck or kind, lg)
    e = tmd.Engine(ff, st, tcfg.RunConfig(**{**BASE, **cfg, **over}),
                   device="cpu")
    assert e.pair_engine == want
    return e


def _moved(e, seed=5, scale=0.03):
    """The engine's positions moved by a numpy-seeded step, as a probe's
    are (some atoms leave the box: the probe wraps them)."""
    rng = np.random.default_rng(seed)
    return e.state.pos + torch.as_tensor(
        rng.normal(scale=scale, size=(e.state.n, 3)), dtype=e.dtype)


def _exact_gate_lists(e, pos, s):
    """The rebuild program's products at `pos` with exact gates (slack 1,
    margin 0) and term lists whatever the engine caches: the wrapped
    positions, the neighbor lists, the term lists cut to their counts and
    the pair layout."""
    kept = e.term_slack, e.term_margin, e.term_cache
    e.term_slack, e.term_margin, e.term_cache = 1.0, 0.0, True
    try:
        out = e._rebuild_fn(tmd.RebuildIn(pos, s.H, s.types, s.gid,
                                          torch.linalg.inv(s.H)))
    finally:
        e.term_slack, e.term_margin, e.term_cache = kept
    for lst in out.lists:
        assert int(lst.cnt) <= lst.valid.shape[0]
    return out.pos, out.nbrs, tuple(tmd._trim(lst) for lst in out.lists), \
        out.layout


@torch.no_grad()
def _eager_probe(e, pos):
    """The port's probe before the program: fresh lists with exact gates
    (slack 1, margin 0), the rebuild's checks, an exact-size QEq list."""
    s = e.state
    pw, nbrs, lists, layout = _exact_gate_lists(e, pos, s)
    pairs = e._pair_data(pw, s, nbrs, layout)
    q, _, _, _, spos = e._qeq_step(pw, s.q, s.qsfp, s.qsfv, s, nbrs, pairs,
                                   isqeq=1, spos=s.spos)
    comps, f = e._forces(pw, q, s, nbrs, lists, pairs, False, spos)
    return float(comps[0]), f, q


def _bars(got, ref, tol):
    pe, f, q = got
    pe_r, f_r, q_r = ref
    assert abs(pe - pe_r) <= tol * abs(pe_r), (pe, pe_r)
    assert float((f - f_r).abs().max()) <= tol * float(f_r.abs().max())
    assert float((q - q_r).abs().max()) <= tol


@pytest.mark.parametrize("name", list(CONFIGS))
def test_probe_matches_the_eager_probe(name):
    e = _engine(name)
    pos = _moved(e)
    before = pos.clone()
    ref = _eager_probe(e, pos)
    got = e.probe(pos)
    assert torch.equal(pos, before)
    assert got[1].shape == (e.state.n, 3) and got[2].shape == (e.state.n,)
    _bars(got, ref, 1e-10)
    assert e.qeq_solves == 1 and int(e.cg_iters) > 0
    if name == "sweep":
        # the first probe sized the QEq list; the next runs at that
        # capacity, with the same result
        cap = e._sizes["probe qeq list"]
        assert e.timers.peaks["probe QEq list"][0] <= cap
        again = e.probe(pos)
        assert again[0] == got[0] and torch.equal(again[1], got[1])
    peaks = e.timers.peaks
    assert 0 < peaks["nonbonded nbr list"][0] <= e.knb
    assert 0 < peaks["angle list"][0] <= e.caps["ang"]


@pytest.fixture(scope="module")
def jax_engine():
    jf = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, jf.name_to_type)
    kw = dict(dtype="float64", NMAXQEq=8, QEq_tol=1e-12, mdmode=10,
              nonbond_closed_form=True)
    je = jmd.Engine(jf, st, jcfg.RunConfig(**kw))
    return st, kw, jopt._MDAdapter(je)


def _port_engine(st, kw, **over):
    return tmd.Engine(tff.parse_ffield(FF), tsys.state_from_numpy(
        {k: np.asarray(v) for k, v in vars(st).items()}),
        tcfg.RunConfig(**kw, **over), device="cpu")


@pytest.mark.parametrize("over,engine", [({}, "sweep"),
                                         (dict(pair_kernel=False), "ell")],
                         ids=["sweep", "ell"])
def test_probe_matches_rxmd_tpu(jax_engine, over, engine):
    st, kw, jad = jax_engine
    te = _port_engine(st, kw, **over)
    assert te.pair_engine == engine
    pos = _moved(te, seed=9, scale=0.02)
    jpe, jf, jq = jad.evaluate(jnp.asarray(pos.numpy()))
    got = topt._MDAdapter(te).evaluate(pos)
    _bars(got, (float(jpe), torch.as_tensor(np.array(jf)),
                torch.as_tensor(np.array(jq))), 1e-8)


def test_qeq_list_capacity_grows_and_reruns():
    e = _engine("sweep", "cell")
    pos = _moved(e)
    exact = e.probe(pos)                  # sizes the list: exact entries
    need = e.timers.peaks["probe QEq list"][0]
    solves = e.qeq_solves
    e._sizes["probe qeq list"] = 64
    got = e.probe(pos)
    assert e.timers.counters["probe QEq list regrowths"] == 1
    assert e.qeq_solves == solves + 2     # the short list's run, then again
    assert e._sizes["probe qeq list"] >= need > 64
    assert got[0] == exact[0]
    assert torch.equal(got[1], exact[1]) and torch.equal(got[2], exact[2])


# cap -> (shrink it, the message); the cell grid's on the replica (the
# 168-atom cell takes the brute-force build), the others on the cell
OVERFLOWS = {
    "kb": (lambda e: setattr(e, "kb", 2), "bonded neighbor overflow"),
    "knb": (lambda e: setattr(e, "knb", 16), "nonbonded neighbor overflow"),
    "cells": (lambda e: setattr(e, "grid", e.grid._replace(ccap=2)),
              "neighbor cell overflow"),
    "ang": (lambda e: e.caps.update(ang=16), "total overflow: ang"),
    "ks": (lambda e: e.caps.update(ks=2), "many-body candidate overflow"),
}


@pytest.mark.parametrize("cap", list(OVERFLOWS))
def test_engine_capacity_overflow_raises(cap):
    e = _engine("sweep", "x2" if cap == "cells" else "cell")
    shrink, message = OVERFLOWS[cap]
    shrink(e)
    with pytest.raises(RuntimeError, match=message):
        e.probe(_moved(e))


class _Cache:
    """graphs.GraphCache's interface, running the function eagerly."""

    made = []

    def __init__(self, device):
        self.keys = []
        self.captures = self.replays = 0
        self.capture_s = 0.0
        _Cache.made.append(self)

    def run(self, key, fn, window, carry, window_id):
        layout = getattr(carry, "layout", None)
        self.keys.append((key, window, getattr(layout, "qcap", None),
                          window_id))
        self.replays += 1
        return fn(window, carry, None)


def test_probe_runs_through_its_own_graph_cache(monkeypatch):
    from rxmd_tpu_torch import graphs
    e = _engine("sweep", "cell")
    monkeypatch.setattr(graphs, "GraphCache", _Cache)
    monkeypatch.setattr(tmd.Engine, "uses_graphs", lambda self: True)
    _Cache.made.clear()
    pos = _moved(e)
    ref = _eager_probe(e, pos)
    first = e.probe(pos)                  # eager: sizes the QEq list
    assert e._probe_graphs is None
    got = [e.probe(pos) for _ in range(2)]
    cache = e._probe_graphs
    assert _Cache.made == [cache] and e._graphs is None
    cap = e._sizes["probe qeq list"]
    assert cache.keys == [("probe", (), cap, 0)] * 2
    assert e.timers.counters["graph replays"] == 2
    for out in [first] + got:
        _bars(out, ref, 1e-10)
    # the steps' rebuild and cache leave the probe's alone
    e.prepare()
    e.run(2, log=None)
    assert e._probe_graphs is cache and e._graphs is not cache
    e.probe(pos)
    assert len(cache.keys) == 3


def _recording(store):
    """A probe's `evaluate` that also appends its PE to `store`."""
    def wrap(evaluate):
        def wrapped(self, pos):
            out = evaluate(self, pos)
            store.append(float(out[0]))
            return out
        return wrapped
    return wrap


def test_one_cg_iteration_matches_rxmd_tpu(jax_engine):
    """One optimizer iteration on the pair list (ELL): every probe's PE,
    in order, within 1e-8 relative of rxmd_tpu's, then the PE and
    positions after it."""
    st, kw, _ = jax_engine
    probes = {"jax": [], "port": []}
    ends = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt._MDAdapter, "evaluate",
                   _recording(probes["jax"])(jopt._MDAdapter.evaluate))
        mp.setattr(topt._MDAdapter, "evaluate",
                   _recording(probes["port"])(topt._MDAdapter.evaluate))
        je = jmd.Engine(jff.parse_ffield(FF), st, jcfg.RunConfig(**kw))
        ends["jax"] = jopt.conjugate_gradient(je, max_iter=1, log=None)
        te = _port_engine(st, kw, pair_kernel=False)
        assert te.pair_engine == "ell"
        ends["port"] = topt.conjugate_gradient(te, max_iter=1, log=None)
    pj, pt = np.array(probes["jax"]), np.array(probes["port"])
    assert len(pj) == len(pt) > 3, (len(pt), len(pj))
    assert np.abs(pt - pj).max() <= 1e-8 * np.abs(pj).max()
    assert te.qeq_solves == len(pt)
    assert abs(ends["port"] - ends["jax"]) <= 1e-8 * abs(ends["jax"])
    assert ends["port"] < pt[0]
    assert np.abs(np.asarray(je.state.pos) - te.state.pos.numpy()).max() \
        <= 1e-7
