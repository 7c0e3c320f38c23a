"""rxmd_tpu's step program in the port, on the CPU: the host schedule with
K-step blocks, the masked and chunked CG, and the QEq list's fixed
capacity.

* `md.Engine.run` against rxmd_tpu's `Engine.run` at block_steps 10 and 3
  on the 168-atom deck in float64 (closed form: the port's sweep, plain
  versions, against rxmd_tpu's pair list), rebuilds on the cadence and on
  drift.  The full CG is capped (NMAXQEq 8, tol 1e-12), as in the other
  parity tests.  Bars: the timers' block, step, rebuild and
  drift-triggered rebuild counts equal, two or more blocks in each; the PE
  components at each PRINTE within 1e-8 of |PE|; final positions within
  1e-8 A.
* The masked, chunked CG (`qeq._cg`) against rxmd_tpu's `while_loop` CG
  on one synthetic float64 problem (a well-conditioned dense hessian, the
  same closures in both): the stop inside a chunk, on a chunk boundary and
  at NMAXQEq.  Bars: the same iteration count, charges within 1e-12, and
  one host read per chunk but the last.
* `qeq_build_plain` at a capacity below the walk's candidates (what the
  list's layout asks) flags the overflow through `need`, its apply stays
  finite, and the engine raises on it.
* `ShardedEngine.run` against rxmd_tpu's `ShardedEngine.run` at
  block_steps 3 on mesh (1, 1, 1) (one gloo rank), 168 atoms: the same
  dispatch and rebuild counts, PE at the common PRINTE steps within 1e-8
  of |PE|, final positions within 1e-8 A.
"""
import math
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    qeq as jqeq, system as jsys
from rxmd_tpu.parallel.engine import ShardedEngine as JShardedEngine
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    qeq as tqeq, system as tsys
from rxmd_tpu_torch.ops import pairsweep as tps
from rxmd_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")

# (block_steps, steps, config): blocks of 10 form only where the drift
# budget allows ten steps (mdmode 5 holds the deck at 100 K, rebuilds on
# the cadence); NVE heats it to ~2,900 K, where blocks of 3 form between
# single steps and drift-triggered rebuilds
CASES = {
    "block10_exL_mdmode5": (10, 50, dict(isQEq=2, mdmode=5, sstep=1,
                                         treq=100.0, pstep=10,
                                         rebuild_every=20)),
    "block3_fullCG_nve": (3, 32, dict(isQEq=1, pstep=8)),
    "block3_exL_nve": (3, 32, dict(isQEq=2, pstep=16)),
}
BASE = dict(dtype="float64", QEq_tol=1e-12, NMAXQEq=8,
            nonbond_closed_form=True)


def _timer_counts(tm):
    return dict(blocks=tm.ncalls.get("MD block (dispatch)", 0),
                steps=tm.ncalls.get("MD step (dispatch)", 0),
                rebuilds=tm.ncalls.get("neighbor rebuild", 0),
                drift=tm.counters.get("drift-triggered rebuilds", 0),
                md_steps=tm.counters.get("MD steps", 0))


def _scheduled(engine, nsteps, to_np):
    printed = []
    engine.init_velocity(seed=1)
    engine.prepare()
    engine.run(nsteps, log=lambda line: printed.append(
        (int(engine.state.step), to_np(engine.comps))))
    return printed, to_np(engine.state.pos), _timer_counts(engine.timers)


@pytest.fixture(scope="module", params=list(CASES))
def scheduled(request):
    block, nsteps, over = CASES[request.param]
    kw = dict(BASE, block_steps=block, **over)
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type)
    je = jmd.Engine(ff, st, jcfg.RunConfig(**kw))
    jrun = _scheduled(je, nsteps, np.asarray)
    te = tmd.Engine(tff.parse_ffield(FF), tsys.state_from_numpy(
        {k: np.asarray(v) for k, v in vars(st).items()}),
        tcfg.RunConfig(**kw), device="cpu")
    assert te.pair_engine == "sweep" and not te.uses_graphs()
    trun = _scheduled(te, nsteps, lambda x: x.cpu().numpy())
    return jrun, trun, te


def test_schedule_counts(scheduled):
    (_, _, jc), (_, _, tc), te = scheduled
    assert tc == jc, (tc, jc)
    assert tc["blocks"] >= 2 and tc["rebuilds"] >= 2
    assert te.timers.counters["MD steps in blocks"] == \
        tc["blocks"] * te.block_steps


def test_printe_pe_and_positions(scheduled):
    (jp, jpos, _), (tp, tpos, _), _ = scheduled
    assert [s for s, _ in tp] == [s for s, _ in jp]
    for (step, a), (_, b) in zip(tp, jp):
        err = np.abs(a - b).max() / abs(b[0])
        assert np.isfinite(a).all() and err <= 1e-8, (step, err)
    assert np.abs(tpos - jpos).max() <= 1e-8


# ----------------------------------------------------------------------
# the CG alone

N_CG = 48


@pytest.fixture(scope="module")
def cg_problem():
    """A synthetic float64 QEq problem, the closures of both packages'
    `_cg` over it, and the reference stop iteration."""
    rng = np.random.default_rng(3)
    b = rng.normal(size=(N_CG, N_CG))
    A = 2.0 * (b @ b.T) / N_CG
    np.fill_diagonal(A, 0.0)
    eta = rng.uniform(8.0, 12.0, N_CG)
    chi = rng.normal(scale=2.0, size=N_CG)
    q0 = rng.normal(scale=0.1, size=N_CG)

    def closures(xp, asarray):
        A_, eta_, chi_ = asarray(A), asarray(eta), asarray(chi)
        w = asarray(np.ones(N_CG))

        def mv(X):
            return eta_[:, None] * X + A_ @ X

        def matvec2_and_est(Hv, qcur):
            per = chi_ * qcur + 0.5 * eta_ * qcur * qcur + (A_ @ qcur) * qcur
            return mv(Hv), xp.sum(per)

        def gradient(X):
            return xp.stack([-chi_, -w], 1) - mv(X)
        return matvec2_and_est, gradient

    jmv, jgrad = closures(jnp, jnp.asarray)
    tmv, tgrad = closures(torch, lambda a: torch.as_tensor(a))

    def jcg(nmax, tol):
        return jqeq._cg(jnp.asarray(q0), jnp.asarray(q0),
                        jnp.ones(N_CG, bool), jnp.float64, 1, nmax, tol,
                        1.0, False, lambda x: x, jmv, jgrad)

    def tcg(nmax, tol, chunk, monkeypatch):
        reads = []
        monkeypatch.setattr(tqeq, "CG_CHUNK", chunk)

        def loop(run_chunk, carry, nchunks):
            def counted(c):
                reads.append(1)
                return run_chunk(c)
            return tqeq.eager_loop(counted, carry, nchunks)
        res = tqeq._cg(torch.as_tensor(q0), torch.as_tensor(q0),
                       torch.ones(N_CG, dtype=torch.bool), torch.float64, 1,
                       nmax, tol, 1.0, False, tmv, tgrad, loop=loop)
        return res, len(reads)

    tol = 1e-10
    ref = jcg(500, tol)
    return jcg, tcg, tol, int(ref.iters)


def _chunk_case(cg_problem, where):
    """(nmax, chunk) placing the reference's stop at `where`."""
    _, _, _, k = cg_problem
    calls = k + 1                 # the updates and the stop test's own
    if where == "inside":
        return 500, [c for c in range(3, calls) if calls % c][0]
    if where == "boundary":
        return 500, [c for c in range(2, calls) if calls % c == 0][-1]
    return k - 3, 4               # the cap, before the stop fires


@pytest.mark.parametrize("where", ["inside", "boundary", "nmax"])
def test_chunked_cg_stops_where_the_while_loop_does(cg_problem, where,
                                                    monkeypatch):
    jcg, tcg, tol, k = cg_problem
    assert k >= 8
    nmax, chunk = _chunk_case(cg_problem, where)
    j = jcg(nmax, tol)
    t, chunks = tcg(nmax, tol, chunk, monkeypatch)
    assert int(t.iters) == int(j.iters) == min(k, nmax)
    assert np.abs(t.q.numpy() - np.asarray(j.q)).max() <= 1e-12
    assert abs(float(t.est) - float(j.est)) <= 1e-12 * abs(float(j.est))
    calls = min(k + 1, nmax)
    assert chunks == math.ceil(calls / chunk) >= 2
    assert (calls % chunk == 0) == (where == "boundary")


# ----------------------------------------------------------------------
# the QEq list's capacity

def _engine(**kw):
    tf = tff.parse_ffield(FF)
    return tmd.Engine(tf, tsys.from_cellfile(CELL, tf.name_to_type),
                      tcfg.RunConfig(dtype="float64", nonbond_closed_form=True,
                                     **kw), device="cpu")


def test_qeq_list_capacity_overflow(monkeypatch):
    e = _engine(isQEq=1, NMAXQEq=4)
    e._rebuild(e.state)
    s = e.state
    ops = e.pairs.data(s.pos, s, None, e._layout)
    planes, walk, grid, fn = ops.qeq_planes(), ops.walk, ops.grid, ops.fn
    qcap = e._layout.qcap
    full = tps.qeq_build_plain(grid, walk, planes, fn, ops.own, s.n)
    E = int(full.need)
    assert E == full.rec.shape[0] == int(walk.qstart[-1]) > int(
        full.count.sum()) > 0
    # the engine's capacity (the walk's candidates, padded) holds the
    # list; the padding past its records adds nothing
    assert qcap >= E
    roomy = tps.qeq_build_plain(grid, walk, planes, fn, ops.own, s.n,
                                cap=qcap)
    assert int(roomy.need) == E and roomy.rec.shape[0] == qcap
    assert torch.equal(roomy.rec[:E], full.rec)
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(s.n, 2)))
    q = torch.as_tensor(np.random.default_rng(2).normal(size=s.n))
    assert torch.allclose(tps.qeq_apply_plain(roomy, walk, X, q),
                          tps.qeq_apply_plain(full, walk, X, q),
                          rtol=0, atol=1e-12)
    small = tps.qeq_build_plain(grid, walk, planes, fn, ops.own, s.n,
                                cap=E // 2)
    assert int(small.need) == E > small.rec.shape[0] == E // 2
    assert torch.equal(small.rec, full.rec[:E // 2])
    assert torch.equal(small.count, full.count)
    assert bool(torch.isfinite(tps.qeq_apply_plain(small, walk, X,
                                                   q)).all())
    # an engine whose capacity falls short raises, at prepare's solve or
    # at the end of a run
    monkeypatch.setattr(tps, "walk_candidates",
                        lambda grid, walk: torch.tensor(64))
    with pytest.raises(RuntimeError, match="QEq list overflow"):
        _engine(isQEq=1, NMAXQEq=4).prepare()
    monkeypatch.undo()
    e = _engine(isQEq=2, NMAXQEq=4)
    e.prepare()
    e._layout = e._layout._replace(qcap=64)
    with pytest.raises(RuntimeError, match="QEq list overflow"):
        e.run(2, log=None)


# ----------------------------------------------------------------------
# the sharded schedule

SHARDED_KW = dict(dtype="float64", QEq_tol=1e-14, NMAXQEq=8, isQEq=2,
                  block_steps=3, pstep=4)
SHARDED_STEPS = 12


def _counted(fn, box, name):
    def wrapped(*a, **k):
        box[name] += 1
        return fn(*a, **k)
    return wrapped


def test_sharded_run_against_rxmd_tpu():
    mc = (1, 1, 1)
    rec = dryrun.launch(1, dryrun.scheduled_run, mc, SHARDED_KW,
                        SHARDED_STEPS, 1, (1, 1, 1), timeout=280.0)[0]
    ff = jff.parse_ffield(FF)
    je = JShardedEngine(ff, jsys.from_cellfile(CELL, ff.name_to_type, mc=mc),
                        jcfg.RunConfig(**SHARDED_KW), mesh_shape=(1, 1, 1))
    je.init_velocity(seed=1)
    je.prepare()
    box = dict(blocks=0, steps=0, rebuilds=0)
    make = je._make_step_program
    je._make_step_program = lambda *a: _counted(make(*a), box, "blocks")
    je._step_qeq = _counted(je._step_qeq, box, "steps")
    je.rebuild = _counted(je.rebuild, box, "rebuilds")
    printed = []
    je.run(SHARDED_STEPS, log=lambda line: printed.append(
        (je.step_count, np.asarray(je.comps))))
    got = {k: rec[k] for k in box}
    assert got == box and box["blocks"] >= 2, (got, box)
    assert rec["in_blocks"] == 3 * box["blocks"]
    ref = dict(printed)
    common = [(s, c) for s, c in rec["printed"] if s in ref]
    assert len(common) >= 2
    for s, c in common:
        assert np.abs(c - ref[s]).max() <= 1e-8 * abs(ref[s][0]), s
    jpos = np.asarray(je.to_state().pos)
    assert np.abs(rec["pos"] - jpos).max() <= 1e-8
