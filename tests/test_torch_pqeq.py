"""rxmd_tpu_torch.pqeq and the PQEq engine against rxmd_tpu, in float64 on
the CPU.

Deck: the 168-atom CHON cell with the synthetic core/shell parameters of
tests/data/pqeq_chon.par (written by make_chon_pqeq_lg.py), the 12.5 A
PQEq taper, the port's skinned neighbor list handed to both packages,
charges and shell displacements drawn from a seed.

Bars: the parameter file and the kernel tables equal exactly (both are
tabulated in float64 by numpy and math.erf); `pqeq_kernels` 1e-12; a solve
capped at 8 CG iterations (the CG amplifies summation-order rounding, see
test_torch_pairpath.py) the same iteration count, charges within 1e-10 of
max|q|, shells within 1e-12 A, Est within 1e-10 relative; the shell
forces and shell step 1e-10; `e_nonbond_pqeq` energies 1e-10 relative,
its autograd forces and strain virial against jax.grad 1e-9 of the
largest.  The engine (full CG; extended Lagrangian with a field; full
CG on the LG force field): PE components per step within 1e-8 relative
over 5 steps (CG capped at 8), float32 against float64 within 1e-4 of
|PE|.  The optimizer under PQEq: test_torch_pqeq_opt.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    neighbors as jnb, pqeq as jpq, reax as jrx, system as jsys
from rxmd_tpu.io import checkpoint as jck
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    neighbors as tnb, pqeq as tpq, reax as trx, system as tsys, units
from rxmd_tpu_torch.io import checkpoint as tck

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
FF_LG = os.path.join(DATA, "ffield_chon_synth_lg")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
RCTAP = units.RCTAP0_PQEQ
SKIN = 0.4
NMAX = 8
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


@pytest.fixture(scope="module")
def deck():
    """Both packages' parameters and the same geometry, list, charges and
    shells."""
    par = jpq.parse_pqeq_par(PAR)
    jf = jpq.apply_to_ff(jff.parse_ffield(FF), par)
    tf = tpq.apply_to_ff(tff.parse_ffield(FF), tpq.parse_pqeq_par(PAR))
    jffd = jrx.ffdev_from(jf, dtype=jnp.float64, rctap=RCTAP)
    tffd = trx.ffdev_from_numpy({k: np.asarray(v)
                                 for k, v in jffd._asdict().items()})
    jp = jpq.make_pqeq(par, dtype=jnp.float64, rctap=RCTAP)
    tp = tpq.pqeq_from_numpy({k: np.asarray(v) for k, v in
                              jp._asdict().items()})
    ts = tsys.from_cellfile(CELL, tf.name_to_type)
    n = ts.n
    H = ts.H.numpy()
    nimg = tnb.nimg_for_cutoff(H, RCTAP + SKIN)
    timg = tnb.make_image_table(n, nimg)
    jimg = jnb.make_image_table(n, nimg, jnp.float64)
    kb, knb, _ = tmd.probe_capacities(tf, ts, tffd, RCTAP, skin=SKIN)
    rc2b, rctap2 = tmd._skinned_cutoffs(tffd, RCTAP, SKIN)
    tn = tmd._build(ts, timg, None, rc2b, rctap2, kb, knb)
    rng = np.random.default_rng(5)
    q = rng.normal(scale=0.3, size=n)
    q -= q.mean()
    spos = rng.normal(scale=0.01, size=(n, 3))
    return dict(
        par=par, jf=jf, tf=tf, tp=tp, jp=jp, n=n,
        t=dict(pos=ts.pos, spos=torch.tensor(spos), q=torch.tensor(q),
               H=ts.H, types=ts.types, gid=ts.gid, img=timg, nbrs=tn,
               ffd=tffd, pq=tp, amask=torch.ones(n, dtype=torch.bool)),
        j=dict(pos=t2j(ts.pos), spos=jnp.asarray(spos), q=jnp.asarray(q),
               H=t2j(ts.H), types=t2j(ts.types), gid=t2j(ts.gid), img=jimg,
               nbrs=jnb.Neighbors(*(t2j(x) for x in tn)), ffd=jffd, pq=jp,
               amask=jnp.ones(n, bool)))


def test_parse_and_tables(deck):
    par = tpq.parse_pqeq_par(PAR)
    assert par["names"] == deck["par"]["names"] == ("C", "H", "O", "N")
    for k, v in deck["par"].items():
        assert np.array_equal(np.asarray(v), np.asarray(par[k])), k
    assert par["is_polar"].all()
    # the 2x eta convention, on both packages' force fields
    assert np.array_equal(deck["tf"].eta, deck["jf"].eta)
    assert np.array_equal(deck["tf"].eta, 2.0 * par["J0"])
    own = tpq.make_pqeq(par, rctap=RCTAP)
    for f in dataclasses.fields(tpq.PQEqParams):
        a, b = getattr(own, f.name), getattr(deck["tp"], f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    # every kernel is live and the core-core one stays finite at r = 0
    assert all(bool(torch.isfinite(getattr(own, k)).all()) and
               float(getattr(own, k).abs().max()) > 0
               for k in ("pcc", "dpcc", "psc", "dpsc", "pss", "dpss"))


def _geometry(d):
    """Per-pair (ti, tj, dr, mask) of the list, in one package's arrays."""
    pose = (tnb.ext_positions(d["pos"], d["H"], d["img"])
            if isinstance(d["pos"], torch.Tensor)
            else jnb.ext_positions(d["pos"], d["H"], d["img"]))
    nb = d["nbrs"]
    idx = nb.idxnb * nb.masknb
    oj = d["img"].owner_of(idx)
    return d["types"][:, None], d["types"][oj], \
        d["pos"][:, None, :] - pose[idx], nb.masknb


def test_pqeq_kernels(deck):
    jg, tg = _geometry(deck["j"]), _geometry(deck["t"])
    for tbl in ("pcc", "psc", "pss", "dpsc", "dpss"):
        a = jpq.pqeq_kernels(deck["jp"], getattr(deck["jp"], tbl), *jg)
        b = tpq.pqeq_kernels(deck["tp"], getattr(deck["tp"], tbl), *tg)
        close(a, b, 1e-12, tbl)
        assert float(b.abs().max()) > 0


SOLVE_ARGS = ("pos", "spos", "q", "q", "H", "types", "img", "nbrs", "ffd",
              "pq", "amask")


@pytest.mark.parametrize("isqeq,field", [(1, False), (1, True), (2, False),
                                         (2, True)])
def test_solve(deck, isqeq, field):
    kw = dict(isqeq=isqeq, nmax=NMAX, tol=1e-12, lex_fqs=0.7)
    if field:
        kw.update(efield_dir=2, efield_strength=0.05)
    jq, js, jit, je = jpq.solve(*[deck["j"][k] for k in SOLVE_ARGS], **kw)
    tq, ts_, tit, te = tpq.solve(*[deck["t"][k] for k in SOLVE_ARGS], **kw)
    assert int(jit) == tit == (NMAX if isqeq == 1 else 1)
    close(jq, tq, 1e-10, "q")
    assert float(np.abs(np.asarray(js) - ts_.numpy()).max()) <= 1e-12
    assert abs(float(je) - float(te)) <= 1e-10 * abs(float(je))
    # the shells moved, each by at most the 1e-3 A cap
    step = (ts_ - deck["t"]["spos"]).norm(dim=1)
    assert 0 < float(step.max()) <= 1e-3 + 1e-15


def test_solve_lmin_f32(deck):
    """lmin_f32 stores the CG step in float32 as the reference does
    (pqeq.F90:27): over NMAX iterations the port's charges and shells
    follow rxmd_tpu's, and part from the float64-step charges by far
    more than that bar."""
    kw = dict(isqeq=1, nmax=NMAX, tol=1e-12)
    jq, js, jit, je = jpq.solve(*[deck["j"][k] for k in SOLVE_ARGS],
                                lmin_f32=True, **kw)
    tq, ts_, tit, te = tpq.solve(*[deck["t"][k] for k in SOLVE_ARGS],
                                 lmin_f32=True, **kw)
    assert int(jit) == tit == NMAX
    close(jq, tq, 1e-10, "q")
    assert float(np.abs(np.asarray(js) - ts_.numpy()).max()) <= 1e-12
    assert abs(float(je) - float(te)) <= 1e-10 * abs(float(je))
    q64 = tpq.solve(*[deck["t"][k] for k in SOLVE_ARGS], **kw)[0]
    scale = float(tq.abs().max())
    assert float((q64 - tq).abs().max()) > 1e3 * 1e-10 * scale


SHELL_ARGS = ("pos", "spos", "q", "H", "types", "img", "nbrs", "pq", "amask")


@pytest.mark.parametrize("fn", ["shell_forces", "update_shells"])
def test_shells(deck, fn):
    kw = dict(efield_dir=0, efield_strength=0.05)
    a = getattr(jpq, fn)(*[deck["j"][k] for k in SHELL_ARGS], **kw)
    b = getattr(tpq, fn)(*[deck["t"][k] for k in SHELL_ARGS], **kw)
    close(a, b, 1e-10, fn)


NB_ARGS = ("spos", "q", "H", "types", "img", "nbrs", "gid", "amask", "ffd",
           "pq")


def test_e_nonbond_pqeq(deck):
    """Energies, and autograd forces and strain virial against jax.grad."""
    j, t = deck["j"], deck["t"]

    def jfun(pos, eps):
        strain = jnp.eye(3) + eps
        args = [j[k] for k in NB_ARGS]
        args[2] = strain @ args[2]
        e = jrx.e_nonbond_pqeq(pos @ strain.T, *args)
        return e[0] + e[1] + e[2], e
    (_, je), (jgp, jge) = jax.value_and_grad(jfun, argnums=(0, 1),
                                             has_aux=True)(
        j["pos"], jnp.zeros((3, 3)))
    p = t["pos"].clone().requires_grad_(True)
    eps = torch.zeros((3, 3), dtype=torch.float64, requires_grad=True)
    strain = torch.eye(3, dtype=torch.float64) + eps
    args = [t[k] for k in NB_ARGS]
    args[2] = strain @ args[2]
    te = trx.e_nonbond_pqeq(p @ strain.T, *args)
    tgp, tge = torch.autograd.grad(te[0] + te[1] + te[2], (p, eps))
    te = [x.detach() for x in te]
    for a, b, name in zip(je, te, ("evdw", "eclmb", "echarge")):
        assert abs(float(a) - float(b)) <= 1e-10 * abs(float(a)), name
        assert abs(float(b)) > 0
    close(jgp, tgp, 1e-9, "forces")
    close(jge, tge, 1e-9, "virial")


def test_checkpoint_carries_shells(deck, tmp_path):
    """A state with relaxed shells crosses between the packages' npz files
    both ways with its spos."""
    d = deck["t"]
    st = tsys.make_state(d["pos"].numpy(), d["types"].numpy(),
                         d["H"].numpy(), q=d["q"].numpy(),
                         spos=d["spos"].numpy(), step=12)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tck.save(a, st)
    assert np.array_equal(np.asarray(jck.load(a).spos), d["spos"].numpy())
    jck.save(b, jck.load(a))
    back = tck.load(b)
    assert torch.equal(back.spos, d["spos"]) and back.step == 12
    assert torch.equal(tck.load(a).spos, d["spos"])


# ---------------------------------------------------------------------------
# the engine

CONFIGS = {
    "cg": dict(isQEq=1),
    "exl_field": dict(isQEq=2, isEfield=True, eFieldDir=1,
                      eFieldStrength=0.05),
    "cg_lg": dict(isQEq=1),      # PQEq on the LG force field
}


def _trajectory(engine, to_np, nsteps=NSTEPS):
    engine.init_velocity(seed=1)
    comps = [to_np(engine.prepare())]
    for _ in range(nsteps):
        engine.run(1, log=None)
        comps.append(to_np(engine.comps))
    return np.array(comps, np.float64), to_np(engine.state.spos)


def _engines(over, dtype="float64", lg=False):
    kw = dict(dtype=dtype, QEq_tol=1e-12, NMAXQEq=NMAX, rebuild_every=2,
              pstep=1, isPQEq=True, pqeq_parm_path=PAR, **over)
    path = FF_LG if lg else FF
    jf = jff.parse_ffield(path, lg=lg)
    tf = tff.parse_ffield(path, lg=lg)
    js = jsys.from_cellfile(CELL, jf.name_to_type)
    ts = tsys.from_cellfile(CELL, tf.name_to_type)
    return (lambda: jmd.Engine(jf, js, jcfg.RunConfig(block_steps=1, **kw)),
            lambda: tmd.Engine(tf, ts, tcfg.RunConfig(block_steps=1, **kw),
                               device="cpu"))


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    mkj, mkt = _engines(CONFIGS[request.param],
                        lg=request.param.endswith("lg"))
    te = mkt()
    jc, js = _trajectory(mkj(), np.asarray)
    tc, ts_ = _trajectory(te, lambda x: x.cpu().numpy())
    return dict(name=request.param, te=te, jc=jc, tc=tc, js=js, ts=ts_)


def test_engine_pe_per_step(runs):
    te, jc, tc = runs["te"], runs["jc"], runs["tc"]
    assert te.pair_engine == "ell" and not hasattr(te.pairs, "grid") \
        and te.pq is not None
    assert te.ffd.is_lg == runs["name"].endswith("lg")
    assert te.rctap == RCTAP and float(te.ffd.rctap2) == RCTAP ** 2
    assert np.isfinite(tc).all()
    err = np.abs(jc - tc) / np.maximum(np.abs(jc), 1.0)
    assert err.max() <= 1e-8, (err.max(), np.unravel_index(err.argmax(),
                                                            err.shape))
    assert np.abs(runs["js"] - runs["ts"]).max() <= 1e-10
    assert np.abs(runs["ts"]).max() > 0


def test_engine_float32_against_float64(runs):
    """The port in float32 against its own float64 run of the same
    configuration."""
    _, mkt = _engines(CONFIGS[runs["name"]], dtype="float32",
                      lg=runs["name"].endswith("lg"))
    c32, _ = _trajectory(mkt(), lambda x: x.cpu().numpy())
    err = np.abs(c32 - runs["tc"]) / np.abs(runs["tc"][:, :1])
    assert err.max() <= 1e-4, err.max()
