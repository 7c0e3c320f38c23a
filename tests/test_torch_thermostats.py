"""Thermostats, momentum removal, the electric field and spring restraints,
and stress(): rxmd_tpu_torch's Engine against rxmd_tpu's in float64 on
the 168-atom deck.

* `_thermostat` (mdmodes 4, 5, 7, 8), `_zero_momentum` and
  `remove_angular_momentum` on one state: within 1e-12 of rxmd_tpu's eager
  methods (the same float64 expressions).  mdmode 7 also runs on a deck
  where one element has a single atom and one has none: both keep factor 0.
* mdmode 6 redraws the same velocities from the same host step.
* 6 steps of mdmode 5 (sstep 2) with a field along z and springs on two
  elements, rebuild_every=4, against rxmd_tpu's Engine(block_steps=1,
  nonbond_closed_form=True): PE components within 1e-8 relative, positions
  within 1e-8 A, the pressure column within 1e-8 relative, as the
  engine's parity test holds NVE.  QEq at tol 1e-12 (see
  test_torch_engine.py).
* stress(): the port's (autograd strain virial + sweep virial rows +
  kinetic) within 1e-8 of rxmd_tpu's strain-gradient stress with its
  closed-form nonbond.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    reax as jrx, system as jsys, units as junits
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
NSTEPS = 6
# mdmode 5 every 2 steps; field along z (1-based 3) at 0.5 V/A; springs of
# 5 kcal/mol/A^2 on C and O (0-based types 0 and 2)
KW = dict(dtype="float64", mdmode=5, sstep=2, isQEq=1, QEq_tol=1e-12,
          rebuild_every=4, isEfield=True, eFieldDir=2, eFieldStrength=0.5,
          spring_const=5.0, spring_types=(0, 2), nonbond_closed_form=True)


def _pair(**over):
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type)
    kw = {**KW, **over}
    je = jmd.Engine(ff, st, jcfg.RunConfig(block_steps=1, **kw))
    te = tmd.Engine(tff.parse_ffield(FF), tsys.state_from_numpy(
        {k: np.asarray(v) for k, v in vars(st).items()}),
        tcfg.RunConfig(block_steps=1, **kw), device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines():
    return _pair()


def _velocities(te, scale=1.0, seed=5):
    rng = np.random.default_rng(seed)
    v = rng.normal(scale=0.01 * scale, size=(te.state.n, 3))
    return v + np.array([0.003, -0.002, 0.001])        # net momentum


def _states(je, te, v, types=None):
    js = dataclasses.replace(je.state, vel=jnp.asarray(v))
    ts = dataclasses.replace(te.state, vel=torch.as_tensor(v))
    if types is not None:
        js = dataclasses.replace(js, types=jnp.asarray(types, jnp.int32))
        ts = dataclasses.replace(ts, types=torch.as_tensor(types))
    return js, ts


def _singleton_types(types):
    """Type 1 (H) kept on one atom only, type 3 (N) on none."""
    t = types.copy()
    h = np.nonzero(t == 1)[0]
    t[h[1:]] = 0
    t[t == 3] = 2
    return t


@pytest.mark.parametrize("mode,scale,deck", [
    (4, 1.0, "deck"), (5, 1.0, "deck"), (7, 1.0, "deck"),
    (7, 1.0, "singleton"), (8, 1.0, "deck"), (8, 1.3, "deck")])
def test_thermostat(engines, mode, scale, deck):
    je, te = engines
    v = _velocities(te, scale)
    types = None
    if deck == "singleton":
        types = _singleton_types(te.state.types.numpy())
        assert (types == 1).sum() == 1 and (types == 3).sum() == 0
    js, ts = _states(je, te, v, types)
    old = (je.cfg.mdmode, te.cfg.mdmode, je.cfg.vsfact, te.cfg.vsfact)
    je.cfg.mdmode = te.cfg.mdmode = mode
    je.cfg.vsfact = te.cfg.vsfact = 0.97
    try:
        jv = np.asarray(je._thermostat(js, True).vel)
        out = te._thermostat(ts, True)
        tv = out.vel.numpy()
        # not do_scale: the state comes back as it was
        assert te._thermostat(ts, False) is ts
    finally:
        je.cfg.mdmode, te.cfg.mdmode, je.cfg.vsfact, te.cfg.vsfact = old
    # a new State: the input's velocity tensor is untouched
    assert out is not ts and np.array_equal(ts.vel.numpy(), v)
    assert np.abs(jv - tv).max() <= 1e-12 * np.abs(jv).max()
    assert not np.array_equal(tv, v)
    if deck == "singleton":
        # the single H atom got factor 0, so it carries only the common
        # momentum shift: every C atom is its factor times v plus that
        single = np.nonzero(types == 1)[0][0]
        ratio = (tv[types == 0] - tv[single]) / v[types == 0]
        assert np.isfinite(tv).all() and ratio.min() > 0
        assert np.abs(ratio - ratio.flat[0]).max() <= 1e-9 * ratio.flat[0]


@pytest.mark.parametrize("mode", [5, 7, 8])
def test_thermostat_at_rest(engines, mode):
    """A state at rest (geninit writes zero velocities) stays at rest and
    finite; rxmd_tpu scales it by sqrt(treq / 0) and gets NaN (a fault of
    the frozen reference, repaired in the port)."""
    je, te = engines
    js, ts = _states(je, te, np.zeros((te.state.n, 3)))
    old = (je.cfg.mdmode, te.cfg.mdmode)
    je.cfg.mdmode = te.cfg.mdmode = mode
    try:
        jv = np.asarray(je._thermostat(js, True).vel)
        tv = te._thermostat(ts, True).vel
    finally:
        je.cfg.mdmode, te.cfg.mdmode = old
    assert torch.equal(tv, torch.zeros_like(tv))
    assert np.isnan(jv).all()


def test_thermostat_within_five_percent_is_a_no_op(engines):
    _, te = engines
    te.cfg.mdmode = 8
    try:
        te.init_velocity(seed=3)    # exactly treq
        s = te.state
        assert torch.equal(te._thermostat(s, True).vel, s.vel)
    finally:
        te.cfg.mdmode = KW["mdmode"]


def test_momentum_removal(engines):
    je, te = engines
    v = _velocities(te)
    js, ts = _states(je, te, v)
    jv = np.asarray(je._zero_momentum(js.types, js.vel))
    tv = te._zero_momentum(ts.types, ts.vel).numpy()
    assert np.abs(jv - tv).max() <= 1e-12 * np.abs(jv).max()
    m = 2 * te.hmas.numpy()[ts.types.numpy()]
    assert np.abs((m[:, None] * tv).sum(0)).max() <= 1e-12

    je0, te0 = je.state, te.state
    je.state, te.state = js, ts
    try:
        je.remove_angular_momentum()
        te.remove_angular_momentum()
        jv, tv = np.asarray(je.state.vel), te.state.vel.numpy()
    finally:
        je.state, te.state = je0, te0
    assert np.abs(jv - tv).max() <= 1e-12 * np.abs(jv).max()
    assert np.array_equal(ts.vel.numpy(), v)


def test_mdmode6_redraws(engines):
    je, te = engines
    for seed in (0, 6):
        je.init_velocity(seed=seed)
        te.init_velocity(seed=seed)
        assert np.abs(np.asarray(je.state.vel)
                      - te.state.vel.numpy()).max() <= 1e-15


def test_mdmode6_run_redraws_on_the_host_step():
    """run() draws before prepare with seed 0, then with seed = step every
    sstep steps (rxmd_tpu's cadence); mdmode 0 forces full-CG QEq."""
    for mode in (6, 0):
        ff = tff.parse_ffield(FF)
        st = tsys.from_cellfile(CELL, ff.name_to_type)
        te = tmd.Engine(ff, st, tcfg.RunConfig(mdmode=mode, sstep=2,
                                               isQEq=2, NMAXQEq=3),
                        device="cpu")
        assert te.cfg.isQEq == (1 if mode == 0 else 2)
        seeds = []
        draw = te.init_velocity

        def spy(seed=0):
            seeds.append(seed)
            draw(seed=seed)
        te.init_velocity = spy
        te.run(5, log=None)
        assert seeds == [0, 2, 4]
        assert te.state.step == 5


def _trajectory(engine, to_np):
    engine.init_velocity(seed=1)
    comps = [to_np(engine.prepare())]
    pos = [to_np(engine.state.pos)]
    press = []
    for _ in range(NSTEPS):
        engine.run(1, log=None)
        comps.append(to_np(engine.comps))
        pos.append(to_np(engine.state.pos))
        press.append(engine.pressure_gpa())
    return np.array(comps), np.array(pos), np.array(press)


@pytest.fixture(scope="module")
def runs(engines):
    je, te = engines
    j = _trajectory(je, np.asarray)
    t = _trajectory(te, lambda x: x.cpu().numpy())
    return j, t


def test_run_pe_components(runs):
    (jc, _, _), (tc, _, _) = runs
    err = np.abs(jc - tc) / np.maximum(np.abs(jc), 1.0)
    assert err.max() <= 1e-8, (err.max(), np.unravel_index(err.argmax(),
                                                           err.shape))


def test_run_positions(runs):
    (_, jp, _), (_, tp, _) = runs
    assert np.abs(jp - tp).max() <= 1e-8


def test_run_pressure(runs):
    (_, _, jpr), (_, _, tpr) = runs
    assert np.isfinite(tpr).all()
    assert np.abs(jpr - tpr).max() <= 1e-8 * np.abs(jpr).max()


def test_field_and_springs_act(runs, engines):
    """The field and the springs are live: each adds a force that the
    plain potential does not have."""
    _, te = engines
    s = te.state
    f_extra = te._external_forces(s.pos, s.q)
    fe = torch.zeros_like(s.pos)
    fe[:, 2] = -s.q * 0.5 * junits.EEV_KCAL
    fs = -5.0 * (s.pos - te.ipos)
    fs[~torch.isin(s.types, torch.tensor([0, 2]))] = 0.0
    assert torch.allclose(f_extra, fe + fs, rtol=1e-13, atol=1e-13)
    assert float(fs.abs().max()) > 0 and float(fe.abs().max()) > 0


def test_stress(runs, engines):
    je, te = engines
    ts = te.stress()
    s = je.state
    _, _, w = jrx.energy_and_forces(
        s.pos, s.q, s.H, s.types, s.gid, je.img, je.nbrs, je.ffd,
        caps=je.caps, closed_form=True, with_virial=True)
    m = (2.0 * je.hmas)[s.types]
    kin = jnp.einsum("i,ia,ib->ab", m, s.vel, s.vel)
    vol = jnp.abs(jnp.linalg.det(s.H))
    js = np.asarray((kin + 0.5 * (w + w.T)) / vol * junits.USTRS)
    assert ts.shape == (3, 3) and np.allclose(ts, ts.T, rtol=0, atol=0)
    assert np.abs(ts - js).max() <= 1e-8 * np.abs(js).max()
    # rxmd_tpu's own stress() takes the interpolation-table nonbond, which
    # parts from the closed form by the table's interpolation error: 1.0e-3
    # of the largest component on this state, against a bar of 2e-3
    jt = je.stress()
    assert np.abs(ts - jt).max() <= 2e-3 * np.abs(jt).max()
