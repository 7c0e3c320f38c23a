"""ReaxFF-lg in rxmd_tpu_torch against rxmd_tpu, in float64 on the CPU,
and the routing that keeps PQEq and LG off the pair sweep.

Deck: tests/data/ffield_chon_synth_lg (ffield_chon_synth with synthetic LG
terms, written by make_chon_pqeq_lg.py) on the 168-atom cell and its
(2, 2, 2) replica (1,344 atoms, min L 21.4 A > 2 rctap: the dense route).

Bars: the LG columns of cf_pair equal exactly; `cf_nonbond` 1e-12 of the
largest magnitude; the closed form against the port's own tables within
the tables' interpolation error, as on the plain deck (1e-4 of the
largest vdW value, 2e-4 of the largest derivative, both at the shortest
bonded distances: 8.2e-5 and 1.5e-4 with or without LG), while the LG
terms move the vdW values by more than 1e-3; the dense form against the
pair-list form 1e-10.  The engine, on the tables (the float64 default)
and the dense forms (closed form): PE components per step within 1e-8
relative over 5 steps (CG capped at 8).  Float32 against float64 on the
closed-form pair list: each component within 1e-4 of |PE|, except Eclmb
and Echarge, held as their sum (the float32 CG stops at the 20-ulp floor
at another iterate than the capped float64 one, which moves ~9e-4 of |PE|
between the two and leaves their sum in place; chip_smoke holds them so
too) and each alone within 1e-3.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    neighbors as jnb, reax as jrx, system as jsys
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    neighbors as tnb, pairs as tpairs, reax as trx, system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
FF_LG = os.path.join(DATA, "ffield_chon_synth_lg")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
RCTAP = 10.0
SKIN = 0.4
NSTEPS = 5


def close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= tol * scale, (what, err, scale)


def t2j(x):
    x = x.numpy()
    return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)


def deck_arrays(mc, name_to_type):
    frac, types, cell = tsys.read_geninit_xyz(CELL, name_to_type)
    frac, types, cell = tsys.replicate(frac, types, cell, mc)
    H = tsys.box_matrix(*cell)
    return frac @ H.T, types, H


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ffdev_lg_columns(dtype):
    """The port's FFDev of the LG deck equals the one carried across from
    rxmd_tpu's, the five LG columns and is_lg included."""
    jf, tf = jff.parse_ffield(FF_LG, lg=True), tff.parse_ffield(FF_LG, lg=True)
    assert jf.is_lg and tf.is_lg
    jffd = jrx.ffdev_from(jf, dtype=getattr(jnp, dtype))
    a = trx.ffdev_from_numpy({k: np.asarray(v) for k, v in
                              jffd._asdict().items()},
                             dtype=getattr(torch, dtype))
    b = trx.ffdev_from(tf, dtype=getattr(torch, dtype))
    for f in dataclasses.fields(trx.FFDev):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, (int, bool)):
            assert x == y, f.name
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
    assert b.is_lg and float(b.cf_pair[..., 6:].abs().min()) > 0
    # the plain ffield's LG columns stay zero
    plain = trx.ffdev_from(tff.parse_ffield(FF))
    assert not plain.is_lg and not bool(plain.cf_pair[..., 6:].any())


def _make(mc):
    jf, tf = jff.parse_ffield(FF_LG, lg=True), tff.parse_ffield(FF_LG, lg=True)
    pos, types, H = deck_arrays(mc, tf.name_to_type)
    ts = tsys.make_state(pos, types, H)
    n = ts.n
    jffd = jrx.ffdev_from(jf, dtype=jnp.float64)
    tffd = trx.ffdev_from(tf)
    nimg = tnb.nimg_for_cutoff(H, RCTAP + SKIN)
    timg = tnb.make_image_table(n, nimg)
    kb, knb, _ = tmd.probe_capacities(tf, ts, tffd, RCTAP, skin=SKIN)
    rc2b, rctap2 = tmd._skinned_cutoffs(tffd, RCTAP, SKIN)
    grid = tmd._cell_grid(tf, ts, timg, SKIN, RCTAP)
    tn = tmd._build(ts, timg, grid, rc2b, rctap2, kb, knb)
    rng = np.random.default_rng(11)
    q = rng.normal(scale=0.3, size=n)
    q -= q.mean()
    amask = torch.ones(n, dtype=torch.bool)
    t = dict(pos=ts.pos, q=torch.tensor(q), H=ts.H, types=ts.types,
             gid=ts.gid, img=timg, nbrs=tn, ffd=tffd, amask=amask)
    j = dict(pos=t2j(ts.pos), q=jnp.asarray(q), H=t2j(ts.H),
             types=t2j(ts.types), gid=t2j(ts.gid),
             img=jnb.make_image_table(n, nimg, jnp.float64),
             nbrs=jnb.Neighbors(*(t2j(x) for x in tn)), ffd=jffd,
             amask=jnp.ones(n, bool))
    keys = ("pos", "q", "H", "types", "img", "nbrs", "gid", "amask", "ffd")
    return dict(t=t, j=j, tc=trx.nb_ctx(*[t[k] for k in keys]),
                jc=jrx.nb_ctx(*[j[k] for k in keys]), tf=tf)


@pytest.fixture(scope="module")
def cell():
    return _make((1, 1, 1))


def test_cf_nonbond_lg(cell):
    j, t, jc, tc = cell["j"], cell["t"], cell["jc"], cell["tc"]
    jp = jrx.ctx_prm(jc, j["types"], j["ffd"])
    tp = trx.ctx_prm(tc, t["types"], t["ffd"])
    assert tp.shape[-1] == 11 and np.array_equal(np.asarray(jp), tp.numpy())
    jo = jrx.cf_nonbond(jc.dr2, jp, j["ffd"], jc.mask & jc.notself)
    to = trx.cf_nonbond(tc.dr2, tp, t["ffd"], tc.mask & tc.notself)
    ok = np.asarray(jo[4])
    assert np.array_equal(ok, to[4].numpy()) and ok.any()
    for k, name in enumerate(("evdw", "eclmb", "devdw", "declmb")):
        close(np.where(ok, jo[k], 0.0), np.where(ok, to[k], 0.0), 1e-12, name)
        assert bool(torch.isfinite(to[k]).all()), name


def test_closed_form_against_tables(cell):
    """The LG closed form and the LG tables (ffield.build_tables) agree
    within the tables' interpolation error; the LG terms themselves move
    the vdW values far beyond it."""
    t, tc = cell["t"], cell["tc"]
    ffd = t["ffd"]
    m = tc.mask & tc.notself
    ev, _, dev, _, ok = trx.cf_nonbond(tc.dr2, trx.ctx_prm(tc, t["types"],
                                                           ffd), ffd, m)
    rows, rok = trx.pair_rows(tc, t["types"], ffd)
    both = (ok & rok).numpy()
    assert both.any()
    close(np.where(both, rows[..., 0], 0.0), np.where(both, ev, 0.0), 1e-4,
          "evdw")
    close(np.where(both, rows[..., 2], 0.0), np.where(both, dev, 0.0), 2e-4,
          "devdw")
    plain = dataclasses.replace(ffd, is_lg=False)
    ev0 = trx.cf_nonbond(tc.dr2, trx.ctx_prm(tc, t["types"], plain), plain,
                         m)[0]
    diff = np.abs(np.where(both, ev - ev0, 0.0)).max()
    assert diff > 1e-3 * np.abs(np.where(both, ev, 0.0)).max()


@pytest.fixture(scope="module")
def replica():
    return _make((2, 2, 2))


def test_dense_against_pair_list(replica):
    """nonbond_dense on the replica, all 11 parameter columns: against
    rxmd_tpu's, and against the port's closed form over the pair list."""
    j, t = replica["j"], replica["t"]
    jo = jrx.nonbond_dense(j["pos"], j["q"], j["H"], j["types"], j["amask"],
                           j["ffd"], with_virial=True)
    to = trx.nonbond_dense(t["pos"], t["q"], t["H"], t["types"], t["amask"],
                           t["ffd"], with_virial=True)
    lo = trx.nonbond_cf_energy_forces(replica["tc"], t["q"], t["types"],
                                      t["amask"], t["ffd"], with_virial=True,
                                      img=t["img"])
    for name, a, b, c in zip(("evdw", "eclmb", "echarge", "f", "virial"),
                             jo, to, lo):
        close(a, b, 1e-10, name)
        close(c, b, 1e-10, name + " (pair list)")


# ---------------------------------------------------------------------------
# the engine

CONFIGS = {
    # (mc, rxmd.in overrides, the pair engine both packages take)
    "tables": ((1, 1, 1), dict(isQEq=1), "ell"),
    "dense": ((2, 2, 2), dict(isQEq=2, nonbond_closed_form=True,
                              pair_kernel=False), "dense"),
    "closed_exl": ((1, 1, 1), dict(isQEq=2, nonbond_closed_form=True),
                   "ell"),
}


def _trajectory(engine, to_np, nsteps=NSTEPS):
    engine.init_velocity(seed=1)
    comps = [to_np(engine.prepare())]
    for _ in range(nsteps):
        engine.run(1, log=None)
        comps.append(to_np(engine.comps))
    return np.array(comps, np.float64)


def _engines(name, dtype="float64"):
    mc, over, _ = CONFIGS[name]
    kw = dict(dtype=dtype, QEq_tol=1e-12, NMAXQEq=8, rebuild_every=2,
              pstep=1, **over)
    jf, tf = jff.parse_ffield(FF_LG, lg=True), tff.parse_ffield(FF_LG, lg=True)
    pos, types, H = deck_arrays(mc, tf.name_to_type)
    return (lambda: jmd.Engine(jf, jsys.make_state(pos, types, H),
                               jcfg.RunConfig(block_steps=1, **kw)),
            lambda: tmd.Engine(tf, tsys.make_state(pos, types, H),
                               tcfg.RunConfig(block_steps=1, **kw),
                               device="cpu"))


@pytest.fixture(scope="module", params=["tables", "dense"])
def runs(request):
    mkj, mkt = _engines(request.param)
    je, te = mkj(), mkt()
    return dict(name=request.param, je=je, te=te,
                jc=_trajectory(je, np.asarray),
                tc=_trajectory(te, lambda x: x.cpu().numpy()))


def test_engine_pe_per_step(runs):
    je, te = runs["je"], runs["te"]
    want = CONFIGS[runs["name"]][2]
    assert te.pair_engine == want and te.ffd.is_lg
    assert ("dense" if je.dense_direct else "ell") == want
    assert je.pairk is None and not hasattr(te.pairs, "grid")
    jc, tc = runs["jc"], runs["tc"]
    assert np.isfinite(tc).all()
    err = np.abs(jc - tc) / np.maximum(np.abs(jc), 1.0)
    assert err.max() <= 1e-8, (err.max(), np.unravel_index(err.argmax(),
                                                            err.shape))


def test_engine_float32_against_float64():
    """The port's LG closed form in float32 (the pair list: the sweep
    does not take LG) against its float64 run."""
    runs = []
    for dtype in ("float64", "float32"):
        e = _engines("closed_exl", dtype)[1]()
        assert e.pair_engine == "ell"
        runs.append(_trajectory(e, lambda x: x.cpu().numpy()))
    def terms(c):
        return np.concatenate([c[:, :12], c[:, 12:].sum(1, keepdims=True)],
                              axis=1)
    scale = np.abs(runs[0][:, :1])
    err = np.abs(terms(runs[1]) - terms(runs[0])) / scale
    split = np.abs(runs[1][:, 12:] - runs[0][:, 12:]) / scale
    assert err.max() <= 1e-4 and split.max() <= 1e-3, (err.max(),
                                                       split.max())


@pytest.mark.parametrize("what", ["PQEq", "LG dispersion"])
def test_pqeq_and_lg_never_take_the_sweep(what):
    """float32 with the closed form would take the sweep; under PQEq or LG
    the engine takes the pair list instead (PQEq never the dense forms),
    and pair_kernel=True raises, naming the cause."""
    lg = what == "LG dispersion"
    kw = dict(dtype="float32") if lg else dict(
        dtype="float32", isPQEq=True, pqeq_parm_path=PAR)
    tf = tff.parse_ffield(FF_LG if lg else FF, lg=lg)
    for mc in ((1, 1, 1), (2, 2, 2)):
        pos, types, H = deck_arrays(mc, tf.name_to_type)
        e = tmd.Engine(tf, tsys.make_state(pos, types, H),
                       tcfg.RunConfig(**kw), device="cpu")
        assert e.pair_engine == ("dense" if lg and mc == (2, 2, 2)
                                 else "ell"), (mc, e.pair_engine)
        assert not hasattr(e.pairs, "grid") and what in e.describe()
    # a box the dense forms take (min L > 2 rctap), without PQEq
    cfg = tcfg.RunConfig(**kw)
    big = np.diag([30.0, 30.0, 30.0])
    assert tpairs.choose(cfg, True, big, 100, 12.5, lg, torch.device("cpu"),
                         torch.float32) == ("dense" if lg else "ell")
    pos, types, H = deck_arrays((1, 1, 1), tf.name_to_type)
    with pytest.raises(ValueError, match=what):
        tmd.Engine(tf, tsys.make_state(pos, types, H),
                   tcfg.RunConfig(pair_kernel=True, **kw), device="cpu")
