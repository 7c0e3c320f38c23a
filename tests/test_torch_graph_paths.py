"""The step program of every single-device configuration, on the CPU:
what lets md.Engine run its steps and blocks as CUDA graphs beyond the
sweep.

* A host-read guard (`parallel/dryrun.HostReadGuard`): `Engine._block_fn`
  for one step and for a block of 3 on the pair-list engine (closed form
  and tables), the dense engine, a triclinic box, uncached terms,
  tighten_lists, PQEq at isQEq 1 and 2 and LG, and `Engine._probe_fn`,
  with every way a tensor reaches the host made to raise (`Tensor.item`,
  `__bool__`, `__int__`, `__float__`, `__index__`, `tolist`, `numpy`,
  `cpu`, `nonzero`, `masked_select`, torch's `nonzero`, `masked_select`,
  `argwhere`, `unique`, one-argument `torch.where`, and indexing with a
  boolean mask), and every tensor made from host data.  The CG's
  finished flag, read by the `loop` hook between chunks, is the one read
  allowed.
  (The sweep's plain versions read counts on the host by design and run
  eagerly: they are exempt.)
* `uses_graphs()` on a card for every configuration, and the rebuild
  window of the engines without a slot map (pair list, dense) settling
  to a few shapes, each taken once, so graphs serve later windows.
* The uncached terms' lists at the engine's capacities against the exact
  lists (`cap=None`): the same entries in the same order, the padding
  invalid.
* A capacity below a step's count (the uncached lists' "ang", "tor",
  "tor_row", "ks", "kh"; the tightened lists' "kb_t", "knb_t") makes
  `Engine.run` raise at the block's end, after the steps ran, naming it.
* `md.Engine.run` against rxmd_tpu's `Engine.run` at block_steps 3 in
  float64 on the 168-atom deck, NVE from seeded velocities (blocks of 3
  form between single steps and drift-triggered rebuilds): PQEq at isQEq
  1 and 2, and the pair list with uncached terms and tighten_lists.  The
  CG is capped (NMAXQEq 8, tol 1e-12), as in the other parity tests.
  Bars, as in test_torch_blocks.py: the same block, step, rebuild and
  drift-rebuild counts, a block or more; the PE components at each
  PRINTE within 1e-8 of |PE|; final positions within 1e-8 A.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, system as jsys
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    pairs as tpairs, reax as trx, system as tsys
from rxmd_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
FF_LG = os.path.join(DATA, "ffield_chon_synth_lg")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
TRICLINIC = (95.0, 100.0, 105.0)


def _deck(kind, lg=False):
    """The force field and the state of "cell", "tric" (the cell's
    fractional coordinates under TRICLINIC) or "x2" (the (2, 2, 2)
    replica, 1,344 atoms, min L 21.4 A: the dense forms' size)."""
    ff = tff.parse_ffield(FF_LG if lg else FF, lg=lg)
    frac, types, cell = tsys.read_geninit_xyz(CELL, ff.name_to_type)
    if kind == "tric":
        cell = cell[:3] + TRICLINIC
    frac, types, cell = tsys.replicate(frac, types, cell,
                                       (2, 2, 2) if kind == "x2" else (1,) * 3)
    H = tsys.box_matrix(*cell)
    return ff, tsys.make_state(frac @ H.T, types, H)


# ----------------------------------------------------------------------
# the host-read guard

@pytest.fixture
def guard():
    """dryrun.HostReadGuard, entered for the test and inactive until the
    test sets its `active`: then every host read raises, and so does a
    tensor made from host data (on a card a copy to the device, which a
    captured stream cannot make); its `loop` lifts it for the CG's
    finished flags and counts them in `reads`."""
    with dryrun.HostReadGuard() as g:
        g.active = False
        yield g


GUARD_BASE = dict(dtype="float64", NMAXQEq=12, QEq_tol=1e-10)
PQ = dict(isPQEq=True, pqeq_parm_path=PAR)
# name: (deck, LG, config, pair engine)
GUARD_CONFIGS = {
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


# the optimizer's probe program runs on these and the sweep (on the
# replica: the cell list and the sweep's slot layout)
PROBE_CONFIGS = dict(GUARD_CONFIGS, sweep=(
    "x2", False, dict(isQEq=1, nonbond_closed_form=True), "sweep"))


@pytest.fixture(scope="module")
def prepared():
    """One prepared engine per configuration, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            kind, lg, over, engine = PROBE_CONFIGS[name]
            ff, st = _deck(kind, lg)
            e = tmd.Engine(ff, st, tcfg.RunConfig(**GUARD_BASE, **over),
                           device="cpu")
            assert e.pair_engine == engine
            e.init_velocity(seed=1)
            e.prepare()
            cache[name] = e
        return cache[name]
    return get


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", list(GUARD_CONFIGS))
def test_no_host_read_inside_the_step(prepared, guard, name, steps):
    e = prepared(name)
    window = (e.nbrs, e.tlists, e._layout, e._pos_ref)
    carry = (dataclasses.replace(e.state, step=0), e.force, e._astr)
    pattern = ((False, True),) * steps
    guard.active = True
    with torch.no_grad():
        out = e._block_fn(pattern, window, carry, guard.loop)
    guard.active = False
    assert bool(torch.isfinite(out.comps).all())
    assert torch.equal(out.state.pos, out.state.pos)
    isq = e.cfg.isQEq
    # the full CG reads its flag between chunks; the extended Lagrangian's
    # one iteration reads nothing
    assert (guard.reads > 0) == (isq == 1), guard.reads
    over = out.over
    if e.term_cache and not e.cfg.tighten_lists:
        assert over is None
    else:
        counts = dict(zip(tmd.CAP_NAMES, over.tolist()))
        assert all(counts[k] <= e.caps[k] for k in tmd.CAP_NAMES), counts
        if not e.term_cache:
            assert min(counts[k] for k in ("ang", "tor", "ks", "kh")) > 0
        if e.cfg.tighten_lists:
            assert min(counts["kb_t"], counts["knb_t"]) > 0


def _plain_sweeps_unguarded(monkeypatch, guard):
    """The sweep's plain versions read counts on the host by design (the
    card runs the kernels): the guard is lifted inside them."""
    from rxmd_tpu_torch.ops import pairsweep as tps
    for name in ("nonbond_plain", "qeq_build_plain", "qeq_apply_plain"):
        def plain(*a, orig=getattr(tps, name), **k):
            was, guard.active = guard.active, False
            try:
                return orig(*a, **k)
            finally:
                guard.active = was
        monkeypatch.setattr(tps, name, plain)


@pytest.mark.parametrize("name", list(PROBE_CONFIGS))
def test_no_host_read_inside_the_probe(prepared, guard, monkeypatch, name):
    """Engine._probe_fn, the optimizer's probe program, at positions moved
    by a numpy-seeded step, reads nothing on the host but the CG's chunk
    flags, after one eager run (a graph's first use, which makes the
    grids' device constants); its counts are within the caps."""
    import numpy as np
    e = prepared(name)
    _plain_sweeps_unguarded(monkeypatch, guard)
    rng = np.random.default_rng(3)
    pos = e.state.pos + torch.as_tensor(
        rng.normal(scale=0.02, size=(e.state.n, 3)), dtype=e.dtype)
    sweep = e.pair_engine == "sweep"
    if sweep:
        e.probe(pos)                 # sizes the QEq list, eagerly
    carry = tmd.ProbeIn(dataclasses.replace(e.state, pos=pos, step=0),
                        torch.linalg.inv(e.state.H),
                        tpairs.SweepLayout(None, e._sizes["probe qeq list"])
                        if sweep else None)
    with torch.no_grad():
        ref = e._probe_fn(carry)
        guard.active = True
        out = e._probe_fn(carry, guard.loop)
        guard.active = False
    assert guard.reads > 0           # a full CG reads its flag per chunk
    assert bool(torch.isfinite(out.pe)) and float(out.pe) == float(ref.pe)
    assert torch.equal(out.force, ref.force)
    got = dict(zip(tmd.PROBE_COUNTS, out.counts.tolist()))
    assert (got["cells"] > 0) == (e.grid is not None), got
    assert min(got["kb"], got["knb"], got["ang"], got["tor"],
               got["ks"]) > 0, got
    assert (got["slots"] > 0) == (got["qeq"] > 0) == sweep, got
    assert (min(got["kb_t"], got["knb_t"]) > 0) == e.cfg.tighten_lists
    e._check_probe(got)


def test_graphs_on_a_card_for_every_configuration(prepared, monkeypatch):
    """uses_graphs() holds for every configuration on a card, with graphs
    on, and stays on while a profiler session records (the trace's marks
    are the device's own); off for the CPU, graphs off or the sweep's
    plain versions."""
    from torch.profiler import ProfilerActivity, profile
    for name in GUARD_CONFIGS:
        e = prepared(name)
        assert not e.uses_graphs()                  # the CPU
        monkeypatch.setattr(e, "device", torch.device("cuda"))
        assert e.uses_graphs(), name
        with profile(activities=[ProfilerActivity.CPU]):
            assert e.uses_graphs(), name
        for attr, value in (("graphs", False), ("plain_sweeps", True)):
            monkeypatch.setattr(e, attr, value)
            assert not e.uses_graphs(), (name, attr)
            monkeypatch.undo()
            monkeypatch.setattr(e, "device", torch.device("cuda"))
        monkeypatch.undo()
    assert not hasattr(tmd, "GRAPH_ENGINES")


@pytest.mark.parametrize("name", ["ell_tables", "dense"])
def test_window_shapes_settle(name):
    """The rebuild window of the engines without a slot map (nbrs, the
    cached lists padded by `_size`, pos_ref) takes a few shapes, each
    once, so the graphs captured over it serve the later windows
    (graphs.GraphCache drops a window's programs when its shapes
    change)."""
    from rxmd_tpu_torch import graphs
    kind, lg, over, engine = GUARD_CONFIGS[name]
    ff, st = _deck(kind, lg)
    e = tmd.Engine(ff, st, tcfg.RunConfig(**dict(
        GUARD_BASE, **over, rebuild_every=2, block_steps=1)), device="cpu")
    assert e.pair_engine == engine and not hasattr(e.pairs, "grid")
    e.init_velocity(seed=1)
    sigs = []
    rebuild = e._rebuild

    def rebuilt(s):
        rebuild(s)
        sigs.append(graphs.signature((e.nbrs, e.tlists, e._layout,
                                      e._pos_ref)))
    e._rebuild = rebuilt
    e.run(12 if kind == "cell" else 7, log=None)
    runs = [sig for i, sig in enumerate(sigs) if i == 0 or sig != sigs[i - 1]]
    assert len(sigs) >= 4 and len(runs) == len(set(runs)) <= 3, runs


# ----------------------------------------------------------------------
# capped lists against exact ones

def test_capped_lists_equal_the_exact_ones(prepared):
    e = prepared("uncached")
    s = e.state
    nbrs = e.nbrs
    bo = trx.bond_order(s.pos, s.H, s.types, e.img, nbrs, e.ffd)
    amask = torch.ones(s.n, dtype=torch.bool)
    caps = e.caps
    counts = {}
    args = (s.types, e.img, nbrs, bo, amask, e.ffd)
    pairs = [
        (trx.build_angle_list(*args, cap=None, ks=caps["ks"]),
         trx.build_angle_list(*args, cap=caps["ang"], ks=caps["ks"],
                              counts=counts)),
        (trx.build_torsion_list(s.types, s.gid, *args[1:], cap=None,
                                ks=caps["ks"]),
         trx.build_torsion_list(s.types, s.gid, *args[1:], cap=caps["tor"],
                                ks=caps["ks"], rowcap=caps["tor_row"],
                                counts=counts))]
    for exact, capped in pairs:
        m = exact.j.shape[0]
        assert 0 < m == int(exact.cnt) == int(capped.cnt)
        assert capped.j.shape[0] == capped.valid.shape[0] > m
        assert bool(capped.valid[:m].all()) and not bool(
            capped.valid[m:].any())
        for f in exact._fields:
            if f != "cnt":
                assert torch.equal(getattr(exact, f),
                                   getattr(capped, f)[:m]), f
    assert 0 < int(counts["ks"]) <= caps["ks"]


# ----------------------------------------------------------------------
# a capacity below a step's count raises at the block's end

OVERFLOW_CASES = {
    "ang": lambda c: 16,
    "tor": lambda c: 16,
    "tor_row": lambda c: 1,
    "ks": lambda c: c - 5,           # caps["ks"] is the most + 4
    "kh": lambda c: 1,               # two hydrogens on a carbon
    "kb_t": lambda c: 2,
    "knb_t": lambda c: 16,
}


@pytest.mark.parametrize("cap", list(OVERFLOW_CASES))
def test_overflow_raises_at_the_block_end(cap):
    ff, st = _deck("cell")
    e = tmd.Engine(ff, st, tcfg.RunConfig(
        dtype="float64", isQEq=2, NMAXQEq=4, term_cache=False,
        tighten_lists=True, block_steps=3, pstep=100), device="cpu")
    e.init_velocity(seed=1)
    e.prepare()
    e.caps = dict(e.caps, **{cap: OVERFLOW_CASES[cap](e.caps[cap])})
    with pytest.raises(RuntimeError, match=cap) as err:
        e.run(3, log=None)
    assert e.state.step == 3, "raised before the steps ran"
    key = {"tor_row": "PER-ROW overflow in tor_row",
           "ang": "total overflow: ang", "tor": "total overflow: tor",
           "ks": "many-body candidate overflow", "kh": "hbond overflow",
           "kb_t": "bonded neighbor overflow",
           "knb_t": "nonbonded neighbor overflow"}[cap]
    assert key in str(err.value)
    assert e.timers.ncalls.get("MD block (dispatch)", 0) == 1


# ----------------------------------------------------------------------
# both packages' Engine.run

RUN_BASE = dict(dtype="float64", QEq_tol=1e-12, NMAXQEq=8, block_steps=3,
                pstep=8)
RUN_STEPS = 32
RUN_CONFIGS = {
    "pqeq_isqeq1": dict(isQEq=1, **PQ),
    "pqeq_isqeq2": dict(isQEq=2, **PQ),
    "ell_uncached_tight": dict(isQEq=2, term_cache=False,
                               tighten_lists=True),
}


def _timer_counts(tm):
    return dict(blocks=tm.ncalls.get("MD block (dispatch)", 0),
                steps=tm.ncalls.get("MD step (dispatch)", 0),
                rebuilds=tm.ncalls.get("neighbor rebuild", 0),
                drift=tm.counters.get("drift-triggered rebuilds", 0),
                md_steps=tm.counters.get("MD steps", 0))


def _scheduled(engine, to_np):
    printed = []
    engine.init_velocity(seed=1)
    engine.prepare()
    engine.run(RUN_STEPS, log=lambda line: printed.append(
        (int(engine.state.step), to_np(engine.comps))))
    return printed, to_np(engine.state.pos), _timer_counts(engine.timers)


@pytest.fixture(scope="module", params=list(RUN_CONFIGS))
def scheduled(request):
    kw = dict(RUN_BASE, **RUN_CONFIGS[request.param])
    jf = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, jf.name_to_type)
    je = jmd.Engine(jf, st, jcfg.RunConfig(**kw))
    jrun = _scheduled(je, np.asarray)
    te = tmd.Engine(tff.parse_ffield(FF), tsys.state_from_numpy(
        {k: np.asarray(v) for k, v in vars(st).items()}),
        tcfg.RunConfig(**kw), device="cpu")
    assert te.pair_engine == "ell"
    trun = _scheduled(te, lambda x: x.cpu().numpy())
    return jrun, trun, te


def test_run_schedule_counts(scheduled):
    (_, _, jc), (_, _, tc), te = scheduled
    assert tc == jc, (tc, jc)
    assert tc["blocks"] >= 1 and tc["rebuilds"] >= 2
    assert te.timers.counters["MD steps in blocks"] == \
        tc["blocks"] * te.block_steps


def test_run_printe_pe_and_positions(scheduled):
    (jp, jpos, _), (tp, tpos, _), _ = scheduled
    assert [s for s, _ in tp] == [s for s, _ in jp]
    for (step, a), (_, b) in zip(tp, jp):
        err = np.abs(a - b).max() / abs(b[0])
        assert np.isfinite(a).all() and err <= 1e-8, (step, err)
    assert np.abs(tpos - jpos).max() <= 1e-8
