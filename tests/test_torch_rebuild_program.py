"""md.Engine's rebuild as a device program (`Engine._rebuild_fn`, rxmd_tpu's
jitted rebuild programs, rxmd_tpu/md.py:545-604), on the CPU, for every
single-device configuration: the sweep, the pair list (closed form and
tables), the dense forms, a triclinic box, uncached terms, tighten_lists,
PQEq at isQEq 1 and 2 and LG.

* Under `parallel/dryrun.HostReadGuard` the program reads nothing on the
  host and makes no tensor from host data, and its products equal the
  same program run unguarded, entry for entry.
* Its products on the deck against rxmd_tpu's `_make_rebuild()` on the
  same state (float64): the wrapped positions within 1e-12 A, each
  neighbor row's entries and counts equal, the cached term lists' counts
  and valid entries equal, and for the sweep the slot layout equal to
  rxmd_tpu's `bin_slots` over rxmd_tpu's wrapped positions.
* `Engine._rebuild` reads the host once (HostReadGuard counting), also
  with the steps' counts pending; the term lists are cut to the window's
  buckets and the QEq list's capacity is the walk's candidates.
* A count past each capacity raises with the rebuild's message: the
  neighbor cells, the bonded and nonbonded rows, the angle, torsion and
  hbond lists (total and per row), the sweep's slot cells, and a step's
  QEq list pending at the rebuild.
* `Engine.run` against rxmd_tpu's at block_steps 3 with rebuilds every 6
  steps (the pair list with tables, and a triclinic box): the same
  rebuild counts, the PE components at each PRINTE within 1e-8 of |PE|
  and positions within 1e-8 A, the CG capped as in the other parity
  tests.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    neighbors as jnb, system as jsys
from rxmd_tpu.ops import pairsweep as jps
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    system as tsys
from rxmd_tpu_torch.ops import pairsweep as tps
from rxmd_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
FF_LG = os.path.join(DATA, "ffield_chon_synth_lg")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
TRICLINIC = (95.0, 100.0, 105.0)

BASE = dict(dtype="float64", NMAXQEq=8, QEq_tol=1e-12)
PQ = dict(isPQEq=True, pqeq_parm_path=PAR)
# name: (deck, LG, config, pair engine)
CONFIGS = {
    "sweep": ("x2", False, dict(isQEq=1, nonbond_closed_form=True),
              "sweep"),
    "ell_closed": ("cell", False, dict(isQEq=1, nonbond_closed_form=True,
                                       pair_kernel=False), "ell"),
    "ell_tables": ("cell", False, dict(isQEq=1), "ell"),
    "dense": ("x2", False, dict(isQEq=2, nonbond_closed_form=True,
                                pair_kernel=False), "dense"),
    "triclinic": ("tric", False, dict(isQEq=1), "ell"),
    "uncached": ("cell", False, dict(isQEq=2, term_cache=False), "ell"),
    "tighten": ("cell", False, dict(isQEq=1, tighten_lists=True), "ell"),
    "pqeq_isqeq1": ("cell", False, dict(isQEq=1, **PQ), "ell"),
    "pqeq_isqeq2": ("cell", False, dict(isQEq=2, **PQ), "ell"),
    "lg": ("cell", True, dict(isQEq=1), "ell"),
}


def _deck(kind, lg=False):
    """(port ForceField, rxmd_tpu ForceField, positions, types, H) of
    "cell", "tric" (the cell's fractional coordinates under TRICLINIC) or
    "x2" (the (2, 2, 2) replica, 1,344 atoms)."""
    ff = tff.parse_ffield(FF_LG if lg else FF, lg=lg)
    frac, types, cell = tsys.read_geninit_xyz(CELL, ff.name_to_type)
    if kind == "tric":
        cell = cell[:3] + TRICLINIC
    frac, types, cell = tsys.replicate(frac, types, cell,
                                       (2, 2, 2) if kind == "x2" else (1,) * 3)
    H = tsys.box_matrix(*cell)
    return ff, jff.parse_ffield(FF_LG if lg else FF, lg=lg), frac @ H.T, \
        types, H


def _engine(name, **over):
    kind, lg, cfg, want = CONFIGS[name]
    ff, _, pos, types, H = _deck(kind, lg)
    e = tmd.Engine(ff, tsys.make_state(pos, types, H), tcfg.RunConfig(
        **{**BASE, **cfg, **over}), device="cpu")
    assert e.pair_engine == want
    return e


def _carry(e, s=None):
    s = e.state if s is None else s
    return tmd.RebuildIn(s.pos, s.H, s.types, s.gid, torch.linalg.inv(s.H))


@pytest.fixture(scope="module")
def engines():
    """One engine per configuration, built on first use (not prepared)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _engine(name)
        return cache[name]
    return get


def _equal_nests(a, b):
    """Every tensor of two nests equal (the same leaves in order)."""
    from rxmd_tpu_torch import graphs
    la, lb = graphs.leaves(a), graphs.leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(x, y)


# ----------------------------------------------------------------------
# the program reads nothing on the host

@pytest.mark.parametrize("name", list(CONFIGS))
def test_rebuild_fn_reads_nothing(engines, name):
    e = engines(name)
    with torch.no_grad():
        # an eager first use makes the grids' device constants, as a
        # graph's first use does on a card
        ref = e._rebuild_fn(_carry(e))
        carry = _carry(e)
        with dryrun.HostReadGuard() as guard:
            out = e._rebuild_fn(carry)
        assert guard.reads == 0
    _equal_nests(out, ref)
    got = dict(zip(tmd.REBUILD_COUNTS, out.counts.tolist()))
    assert min(got["kb"], got["knb"]) > 0
    assert (got["cells"] > 0) == (e.grid is not None), got
    assert (min(got["ang"], got["tor"]) > 0) == e.term_cache, got
    assert (out.lists is not None) == e.term_cache
    sweep = e.pair_engine == "sweep"
    assert (got["slots"] > 0) == (got["qeq"] > 0) == sweep
    if out.lists is not None:
        assert [lst.valid.shape[0] for lst in out.lists] == [
            e.caps["ang"], e.caps["tor"], e.caps["hbf"]]


# ----------------------------------------------------------------------
# against rxmd_tpu's rebuild

def _rows_equal(ti, tc, ji, jc):
    ti, tc, ji, jc = (np.asarray(x) for x in (ti, tc, ji, jc))
    assert np.array_equal(tc, jc)
    assert ti.shape[0] == ji.shape[0]
    k = max(ti.shape[1], ji.shape[1])
    pad = lambda a: np.pad(a, ((0, 0), (0, k - a.shape[1])),
                           constant_values=-1)
    ti, ji = pad(ti), pad(ji)
    assert np.array_equal(ti, ji)


LIST_FIELDS = (("j", "a", "c", "oi", "ok"), ("j", "a", "c", "ok", "e"),
               ("i", "a", "c"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rebuild_matches_rxmd_tpu(engines, name):
    e = engines(name)
    kind, lg, cfg, _ = CONFIGS[name]
    _, jf, pos, types, H = _deck(kind, lg)
    kw = {**BASE, **cfg}
    kw.pop("pair_kernel", None)
    je = jmd.Engine(jf, jsys.make_state(pos, types, H), jcfg.RunConfig(**kw))
    js, jnbrs, jlists, _ = je._rebuild(je.state)
    with torch.no_grad():
        out = e._rebuild_fn(_carry(e))
    assert np.abs(out.pos.numpy() - np.asarray(js.pos)).max() <= 1e-12
    _rows_equal(out.nbrs.idxb, out.nbrs.cntb, jnbrs.idxb, jnbrs.cntb)
    _rows_equal(out.nbrs.idxnb, out.nbrs.cntnb, jnbrs.idxnb, jnbrs.cntnb)
    if e.term_cache:
        assert len(jlists) == 3
        for tl, jl, fields in zip(out.lists, jlists, LIST_FIELDS):
            n = int(tl.cnt)
            assert n == int(jl.cnt) > 0 and n <= tl.valid.shape[0]
            assert bool(tl.valid[:n].all()) and not bool(tl.valid[n:].any())
            for f in fields:
                assert np.array_equal(getattr(tl, f)[:n].numpy(),
                                      np.asarray(getattr(jl, f))[:n]), f
    else:
        assert out.lists is None and jlists == ()
    if e.pair_engine == "sweep":
        jgrid = jps.make_pair_grid(np.asarray(H), e.rctap, skin=e.skin,
                                   ccap=e.pairs.grid.ccap)
        jpose = jnb.ext_positions(js.pos, js.H, je.img)
        jsm = jps.bin_slots(jpose, jnp.ones(jpose.shape[0], bool), jgrid,
                            js.n)
        for f in ("slot_src", "slot_of_atom"):
            assert np.array_equal(getattr(out.layout.sm, f).numpy(),
                                  np.asarray(getattr(jsm, f))), f
        assert int(out.layout.sm.overflow) == int(jsm.overflow) > 0


# ----------------------------------------------------------------------
# one host read, the window's buckets

@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_host_read_per_rebuild(name):
    e = _engine(name)
    e.init_velocity(seed=1)
    e.prepare()
    e._advance(1)
    e._advance(1)
    # the steps' counts wait for a check: the sweep's QEq list, the
    # uncached terms' and the tightened lists' counts
    sweep = e.pair_engine == "sweep"
    assert bool(e._pending()) == (sweep or not e.term_cache
                                  or e.cfg.tighten_lists)
    with dryrun.HostReadGuard(count=True) as guard:
        e._rebuild(e.state)
    assert len(guard.seen) == 1, guard.seen
    assert not e._pending()
    out = e._rebuild_fn(_carry(e))
    got = dict(zip(tmd.REBUILD_COUNTS, out.counts.tolist()))
    if e.term_cache:
        for lst, full, nm in zip(e.tlists, out.lists, ("ang", "tor", "hbf")):
            size = lst.valid.shape[0]
            assert got[nm] <= size == e._sizes[nm] <= full.valid.shape[0]
            assert torch.equal(lst.j if nm != "hbf" else lst.i,
                               (full.j if nm != "hbf" else full.i)[:size])
    if sweep:
        assert got["qeq"] <= e._layout.qcap == e._sizes["qeq list"]
        assert got["qeq"] == int(tps.walk_candidates(
            e.pairs.grid, tps.atom_walk(e._layout.sm)))


# ----------------------------------------------------------------------
# each capacity

def _set(attr, value):
    def f(e):
        if attr.startswith("caps."):
            e.caps[attr[5:]] = value
        elif attr == "grid.ccap":
            e.grid = e.grid._replace(ccap=value)
        elif attr == "pairs.grid.ccap":
            e.pairs.grid = e.pairs.grid._replace(ccap=value)
        elif attr == "_layout.qcap":
            e._layout = e._layout._replace(qcap=value)
        else:
            setattr(e, attr, value)
    return f


OVERFLOWS = {
    "cells": (_set("grid.ccap", 2), r"neighbor cell overflow: \d+ atoms > "
                                    r"ccap=2"),
    "kb": (_set("kb", 2), r"bonded neighbor overflow: \d+ > capacity 2"),
    "knb": (_set("knb", 8), r"nonbonded neighbor overflow: \d+ > capacity 8"),
    "ang": (_set("caps.ang", 1), r"interaction-list overflow: total "
                                 r"overflow: ang \d+/1"),
    "tor": (_set("caps.tor", 1), r"total overflow: tor \d+/1"),
    "hbf": (_set("caps.hbf", 1), r"total overflow: .*hbf \d+/1"),
    "ang_row": (_set("caps.ang_row", 1), r"PER-ROW overflow in ang_row"),
    "slots": (_set("pairs.grid.ccap", 2),
              r"pair-sweep cell overflow: \d+ > ccap=2"),
    "qeq_pending": (_set("_layout.qcap", 1),
                    r"QEq list overflow: \d+ entries > capacity 1"),
}


@pytest.mark.parametrize("case", list(OVERFLOWS))
def test_overflow_raises_with_its_message(case):
    e = _engine("sweep")
    e.init_velocity(seed=1)
    e.prepare()
    change, msg = OVERFLOWS[case]
    change(e)
    if case == "qeq_pending":
        e._advance(1)                # the step's QEq list, unchecked
    with pytest.raises(RuntimeError, match=msg):
        e._rebuild(e.state)


# ----------------------------------------------------------------------
# a run with rebuilds against rxmd_tpu's

RUN_CONFIGS = ("ell_tables", "triclinic")
RUN_STEPS = 24


def _timed_run(engine, to_np):
    printed = []
    engine.init_velocity(seed=1)
    engine.prepare()
    engine.run(RUN_STEPS, log=lambda line: printed.append(
        (int(engine.state.step), to_np(engine.comps))))
    return printed, to_np(engine.state.pos), \
        engine.timers.ncalls.get("neighbor rebuild", 0)


@pytest.mark.parametrize("name", RUN_CONFIGS)
def test_run_with_rebuilds_against_rxmd_tpu(name):
    kind, lg, cfg, _ = CONFIGS[name]
    ff, jf, pos, types, H = _deck(kind, lg)
    kw = dict(BASE, **cfg, block_steps=3, pstep=3, rebuild_every=6)
    je = jmd.Engine(jf, jsys.make_state(pos, types, H), jcfg.RunConfig(**kw))
    jp, jpos, jreb = _timed_run(je, np.asarray)
    te = tmd.Engine(ff, tsys.make_state(pos, types, H), tcfg.RunConfig(**kw),
                    device="cpu")
    tp, tpos, treb = _timed_run(te, lambda x: x.cpu().numpy())
    assert treb == jreb >= RUN_STEPS // 6 - 1
    assert [s for s, _ in tp] == [s for s, _ in jp]
    for (step, a), (_, b) in zip(tp, jp):
        err = np.abs(a - b).max() / abs(b[0])
        assert np.isfinite(a).all() and err <= 1e-8, (step, err)
    assert np.abs(tpos - jpos).max() <= 1e-8


def test_callers_run_config_keeps_its_isqeq():
    """Under mdmode 0 both engines run isQEq=1 on a copy of the caller's
    RunConfig (ref: init.F90:56-63)."""
    from rxmd_tpu_torch.parallel.engine import ShardedEngine
    ff, _, pos, types, H = _deck("cell")
    for make in (lambda c: tmd.Engine(ff, tsys.make_state(pos, types, H), c,
                                      device="cpu"),
                 lambda c: ShardedEngine(ff, tsys.make_state(pos, types, H),
                                         c, mesh_shape=(1, 1, 1),
                                         device="cpu")):
        cfg = tcfg.RunConfig(**dict(BASE, mdmode=0, isQEq=2))
        e = make(cfg)
        assert cfg.isQEq == 2 and e.cfg.isQEq == 1
        assert dataclasses.replace(e.cfg, isQEq=2) == cfg
