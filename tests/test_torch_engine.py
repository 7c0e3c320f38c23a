"""The slice end to end: rxmd_tpu_torch's Engine against rxmd_tpu's
Engine on the 168-atom deck, with rebuild_every=4 so the wrap, neighbor,
term-list and slot rebuilds run.

* float64, prepare plus 10 NVE steps, closed-form nonbond in both
  (nonbond_closed_form=True; float64 would take the tables): rxmd_tpu
  runs its ELL closed-form path, the port its pair sweep (plain version
  on the CPU); the physics is the same.  Bars: per-step PE components within 1e-8 relative and
  positions within 1e-8 A.  QEq is converged tightly (tol 1e-12) wherever
  a full CG runs, since at the default stop test two summation orders can
  stop at different iterates (see test_torch_qeq.py); exL steps run
  exactly one CG iteration.
* float32, prepare plus 5 steps: rxmd_tpu runs its Pallas sweep in
  interpret mode (pair_kernel=True on the CPU), the port its plain sweep.
  Bars: each PE component within 1e-5 of |PE| and positions within
  1e-5 A: float32 sums of ~1e4 kcal/mol taken in other orders part by
  ~1e-6 of |PE|, and ~1e-6 A after 5 steps.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    system as jsys
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
NSTEPS = 10
F32_STEPS = 5


def _kinetic(engine):
    s = engine.state
    return float((engine.hmas[s.types] * (s.vel * s.vel).sum(1)).sum())


def _trajectory(engine, to_np, nsteps):
    engine.init_velocity(seed=1)
    comps = [to_np(engine.prepare())]
    pos = [to_np(engine.state.pos)]
    etot = [comps[0][0] + _kinetic(engine)]
    rebuilds = 0
    for _ in range(nsteps):
        engine.run(1, log=None)
        comps.append(to_np(engine.comps))
        pos.append(to_np(engine.state.pos))
        etot.append(comps[-1][0] + _kinetic(engine))
        rebuilds += engine._steps_since_rebuild == 1
    return np.array(comps), np.array(pos), np.array(etot), rebuilds


@pytest.fixture(scope="module", params=[2, 1], ids=["exL", "fullCG"])
def runs(request):
    kw = dict(dtype="float64", isQEq=request.param, QEq_tol=1e-12,
              rebuild_every=4, pstep=1, nonbond_closed_form=True)
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type)
    je = jmd.Engine(ff, st, jcfg.RunConfig(block_steps=1, **kw))
    jc, jp, _, _ = _trajectory(je, np.asarray, NSTEPS)
    tf = tff.parse_ffield(FF)
    te = tmd.Engine(tf, tsys.state_from_numpy(
        {k: np.asarray(v) for k, v in vars(st).items()}),
        tcfg.RunConfig(block_steps=1, **kw), device="cpu")
    assert te.pair_engine == "sweep"
    tc, tp, etot, rebuilds = _trajectory(te, lambda x: x.cpu().numpy(),
                                         NSTEPS)
    return jc, jp, tc, tp, etot, rebuilds, te


def test_pe_components_per_step(runs):
    jc, _, tc, _, _, _, _ = runs
    err = np.abs(jc - tc) / np.maximum(np.abs(jc), 1.0)
    assert err.max() <= 1e-8, (err.max(), np.unravel_index(err.argmax(),
                                                           err.shape))
    assert np.isfinite(tc).all()


def test_positions_per_step(runs):
    _, jp, _, tp, _, _, _ = runs
    assert np.abs(jp - tp).max() <= 1e-8


def test_rebuilds_ran_and_energy_is_conserved(runs):
    _, _, _, _, etot, rebuilds, te = runs
    assert rebuilds == 3          # prepare's, then before steps 5 and 9
    line = te.printe_line()
    assert line.startswith("MDstep:") and f"{NSTEPS:9d}" in line
    # NVE sanity bound, not a parity bar: the synthetic cell relaxes hard
    # (KE grows ~5x in 10 steps, 300 K -> 1350 K) and exL charges lag it,
    # so the total drifts by up to ~3e-4 relative here in both packages
    assert np.abs(etot - etot[0]).max() < 1e-3 * abs(etot[0])


@pytest.fixture(scope="module")
def runs_f32():
    # exL with NMAXQEq=4 bounds the interpret-mode sweeps: both packages
    # run 4 CG iterations in prepare's cold start and 1 in each step
    kw = dict(dtype="float32", isQEq=2, NMAXQEq=4, rebuild_every=4, pstep=1)
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type)
    je = jmd.Engine(ff, st, jcfg.RunConfig(block_steps=1, pair_kernel=True,
                                           **kw))
    assert je.pairk is not None and je._pk_interp
    jc, jp, _, _ = _trajectory(je, np.asarray, F32_STEPS)
    te = tmd.Engine(tff.parse_ffield(FF), tsys.state_from_numpy(
        {k: np.asarray(v) for k, v in vars(st).items()}),
        tcfg.RunConfig(block_steps=1, **kw), device="cpu")
    tc, tp, _, rebuilds = _trajectory(te, lambda x: x.cpu().numpy(),
                                      F32_STEPS)
    assert rebuilds == 2 and te.dtype == torch.float32
    return jc, jp, tc, tp


def test_float32_matches_pallas_engine(runs_f32):
    jc, jp, tc, tp = runs_f32
    assert np.isfinite(tc).all()
    err = np.abs(jc - tc) / np.abs(jc[:, :1])
    assert err.max() <= 1e-5, (err.max(), np.unravel_index(err.argmax(),
                                                           err.shape))
    assert np.abs(jp - tp).max() <= 1e-5
