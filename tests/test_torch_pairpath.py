"""rxmd_tpu_torch's pair-list engine, dense forms and uncached terms
against rxmd_tpu, function by function, in float64 on the CPU.

Decks: the 168-atom cell ("cell"), the same fractional coordinates under
the lattice angles (95, 100, 105) degrees ("tric"), and the cell's
(2, 2, 2) replica (1,344 atoms, min L 21.4 A > 2 rctap) for the dense
forms.  Both packages get the same numpy inputs: positions, charges drawn
from a seed, the port's neighbor lists and capacities.

Bars: 1e-10 relative (of the largest magnitude of a quantity) for values,
forces and virials: the same float64 expressions, summed in another
order, part by ~1e-14.  Index tables and masks are equal.  QEq, every
branch: 8 CG iterations (or exL's one) give charges within 1e-10, and a
tol-1e-12 solve the same charges within 1e-6 (see test_qeq_converged).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import ffield as jff, neighbors as jnb, qeq as jqeq, \
    reax as jrx, system as jsys
from rxmd_tpu_torch import ffield as tff, md as tmd, neighbors as tnb, \
    pairs as tpairs, qeq as tqeq, reax as trx, system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4
RCTAP = 10.0
TRICLINIC = (95.0, 100.0, 105.0)
TOL = 1e-10


def deck_arrays(kind, name_to_type):
    """(pos, types, H) of a deck: "cell", "tric" or "x2" (see above)."""
    frac, types, cell = tsys.read_geninit_xyz(CELL, name_to_type)
    if kind == "tric":
        cell = cell[:3] + TRICLINIC
    frac, types, cell = tsys.replicate(frac, types, cell,
                                       (2, 2, 2) if kind == "x2" else (1,) * 3)
    H = tsys.box_matrix(*cell)
    return frac @ H.T, types, H


def close(a, b, tol=TOL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= tol * scale, (what, err, scale)


def t2j(x, dtype=None):
    x = x.numpy()
    if x.dtype == np.int64:
        x = x.astype(np.int32)
    return jnp.asarray(x, dtype)


def _make_deck(kind):
    jf = jff.parse_ffield(FF)
    tf = tff.parse_ffield(FF)
    pos, types, H = deck_arrays(kind, tf.name_to_type)
    ts = tsys.make_state(pos, types, H)
    n = ts.n
    jffd = jrx.ffdev_from(jf, dtype=jnp.float64)
    tffd = trx.ffdev_from_numpy({k: np.asarray(v)
                                 for k, v in jffd._asdict().items()})
    nimg = tnb.nimg_for_cutoff(H, RCTAP + SKIN)
    timg = tnb.make_image_table(n, nimg)
    jimg = jnb.make_image_table(n, nimg, jnp.float64)
    kb, knb, caps = tmd.probe_capacities(tf, ts, tffd, RCTAP, skin=SKIN,
                                         term_slack=1.0)
    rc2b, rctap2 = tmd._skinned_cutoffs(tffd, RCTAP, SKIN)
    grid = tmd._cell_grid(tf, ts, timg, SKIN, RCTAP)
    tn = tmd._build(ts, timg, grid, rc2b, rctap2, kb, knb)
    rng = np.random.default_rng(11)
    q = rng.normal(scale=0.3, size=n)
    q -= q.mean()
    tq = torch.tensor(q)
    return dict(
        kind=kind, n=n, caps=caps, kb=kb, knb=knb, rc2b=rc2b, rctap2=rctap2,
        t=dict(pos=ts.pos, q=tq, H=ts.H, types=ts.types, gid=ts.gid,
               img=timg, nbrs=tn, ffd=tffd,
               amask=torch.ones(n, dtype=torch.bool)),
        j=dict(pos=t2j(ts.pos), q=jnp.asarray(q), H=t2j(ts.H),
               types=t2j(ts.types), gid=t2j(ts.gid), img=jimg,
               nbrs=jnb.Neighbors(*(t2j(x) for x in tn)), ffd=jffd,
               amask=jnp.ones(n, bool)))


@pytest.fixture(scope="module", params=["cell", "tric"])
def deck(request):
    return _make_deck(request.param)


@pytest.fixture(scope="module")
def replica():
    return _make_deck("x2")


def _args(d, keys):
    return [d[k] for k in keys]


CTX_ARGS = ("pos", "q", "H", "types", "img", "nbrs", "gid", "amask", "ffd")


@pytest.fixture(scope="module")
def ctxs(deck):
    return (jrx.nb_ctx(*_args(deck["j"], CTX_ARGS)),
            trx.nb_ctx(*_args(deck["t"], CTX_ARGS)))


def test_nb_ctx(deck, ctxs):
    jc, tc = ctxs
    for f in ("idx", "mask", "notself"):
        assert np.array_equal(np.asarray(getattr(jc, f)),
                              getattr(tc, f).numpy()), f
    assert tc.mask.any() and (~tc.notself).any()
    close(np.moveaxis(np.asarray(jc.dr), 0, -1), tc.dr, what="dr")
    close(jc.dr2, tc.dr2, what="dr2")
    close(jc.qj, tc.qj, what="qj")
    assert np.array_equal(np.asarray(jc.tjf).astype(np.int64), tc.tj.numpy())
    assert np.array_equal(np.asarray(jrx.pair_bond_type(jc, deck["j"]["types"],
                                                        deck["j"]["ffd"])),
                          trx.pair_bond_type(tc, deck["t"]["types"],
                                             deck["t"]["ffd"]).numpy())


def test_closed_form_kernels(deck, ctxs):
    jc, tc = ctxs
    j, t = deck["j"], deck["t"]
    jp = jrx.ctx_prm(jc, j["types"], j["ffd"])
    tp = trx.ctx_prm(tc, t["types"], t["ffd"])
    assert np.array_equal(np.asarray(jp)[..., :6], tp.numpy())
    m = jc.mask & jc.notself
    jo = jrx.cf_nonbond(jc.dr2, jp, j["ffd"], m)
    to = trx.cf_nonbond(tc.dr2, tp, t["ffd"], tc.mask & tc.notself)
    ok = np.asarray(jo[4])
    assert np.array_equal(ok, to[4].numpy()) and ok.any()
    for k, name in enumerate(("evdw", "eclmb", "devdw", "declmb")):
        close(np.where(ok, jo[k], 0.0), np.where(ok, to[k], 0.0), what=name)
    close(jrx.cf_qeq_kernel(jc.dr2, jp, j["ffd"], jc.mask),
          trx.cf_qeq_kernel(tc.dr2, tp, t["ffd"], tc.mask), what="hqeq")


def test_table_rows(deck, ctxs):
    jc, tc = ctxs
    jr, jok = jrx.pair_rows(jc, deck["j"]["types"], deck["j"]["ffd"])
    tr, tok = trx.pair_rows(tc, deck["t"]["types"], deck["t"]["ffd"])
    ok = np.asarray(jok)
    assert np.array_equal(ok, tok.numpy())
    for k in range(5):
        close(np.where(ok, jr[..., k], 0.0), np.where(ok, tr[..., k], 0.0),
              what=f"table column {k}")


@pytest.mark.parametrize("form", ["closed", "tables", "tables_pre"])
def test_nonbond_energy_forces(deck, ctxs, form):
    jc, tc = ctxs
    j, t = deck["j"], deck["t"]
    ja = (j["q"], j["types"], j["amask"], j["ffd"])
    ta = (t["q"], t["types"], t["amask"], t["ffd"])
    if form == "closed":
        jo = jrx.nonbond_cf_energy_forces(jc, *ja, with_virial=True)
        to = trx.nonbond_cf_energy_forces(tc, *ta, with_virial=True)
    else:
        jpre = tpre = None
        if form == "tables_pre":
            jpre = jrx.pair_rows(jc, j["types"], j["ffd"])
            tpre = trx.pair_rows(tc, t["types"], t["ffd"])
        jo = jrx.nonbond_tbl_energy_forces(jc, *ja, with_virial=True,
                                           pre=jpre)
        to = trx.nonbond_tbl_energy_forces(tc, *ta, with_virial=True,
                                           pre=tpre)
    for name, a, b in zip(("evdw", "eclmb", "echarge", "f", "virial"), jo, to):
        close(a, b, what=name)
    assert abs(float(to[0])) > 0 and abs(float(to[1])) > 0


def test_dense_forms(replica):
    """qeq_dense_direct and nonbond_dense where the engines take them (the
    replica); on the 168-atom cell (min L 10.7 A) the minimum image is
    not unique and the engines never call them."""
    j, t = replica["j"], replica["t"]
    jh = jrx.qeq_dense_direct(j["pos"], j["H"], j["types"], j["ffd"])
    th = trx.qeq_dense_direct(t["pos"], t["H"], t["types"], t["ffd"])
    close(jh[0], th[0], what="Hd")
    close(jh[1], th[1], what="Hw")
    jo = jrx.nonbond_dense(j["pos"], j["q"], j["H"], j["types"], j["amask"],
                           j["ffd"], with_virial=True)
    to = trx.nonbond_dense(t["pos"], t["q"], t["H"], t["types"], t["amask"],
                           t["ffd"], with_virial=True)
    for name, a, b in zip(("evdw", "eclmb", "echarge", "f", "virial"), jo, to):
        close(a, b, what=name)


# qeq.solve's branches, as rxmd_tpu.qeq.solve's keywords; the port builds
# each one's operator (`_operator`)
QEQ_BRANCHES = {
    "direct": dict(direct=True),
    "ell_fold_closed": dict(closed_form=True),
    "ell_fold_tables": dict(closed_form=False),
    "ell_closed": dict(closed_form=True, dense_max=0),
    "ell_tables": dict(closed_form=False, dense_max=0),
    "pre_closed": dict(pre="closed"),
    "pre_tables": dict(pre="tables"),
}


def _operator(t, kw, ctx, isqeq):
    """The port's hessian operator of a branch (`kw`, rxmd_tpu.qeq.solve's
    keywords): the dense form, or the pair context (`ctx`, else built from
    the deck's lists as rxmd_tpu's solve builds it) with the closed form
    or the tables, folded into a dense matrix up to `dense_max` atoms (the
    default of both packages' RunConfig.qeq_dense_max)."""
    if kw.get("direct"):
        return tpairs.Dense.operator(t["pos"], t["H"], t["types"], t["ffd"])
    if ctx is None:
        ctx = trx.nb_ctx(t["pos"], None, t["H"], t["types"], t["img"],
                         t["nbrs"], torch.zeros_like(t["types"]), t["amask"],
                         t["ffd"])
    rows = None if kw["closed_form"] else trx.pair_rows(ctx, t["types"],
                                                        t["ffd"])
    return tpairs.PairList.operator(ctx, rows, t["types"], t["ffd"],
                                    t["img"], t["nbrs"], isqeq,
                                    kw.get("dense_max", 8192))


def _solve_both(deck, isqeq, kw, tol=1e-12, lmin_f32=False, nmax=500):
    j, t = deck["j"], deck["t"]
    n = deck["n"]
    rng = np.random.default_rng(5)
    qsfp = rng.normal(scale=0.2, size=n)
    qsfp -= qsfp.mean()
    kw = dict(kw)
    jkw, tc = dict(kw), None
    if kw.get("pre"):
        form = kw.pop("pre")
        jc = jrx.nb_ctx(*_args(j, CTX_ARGS[:1]), None,
                        *_args(j, CTX_ARGS[2:]))
        tc = trx.nb_ctx(*_args(t, CTX_ARGS[:1]), None,
                        *_args(t, CTX_ARGS[2:]))
        kw["closed_form"] = form == "closed"
        if form == "closed":
            jkw = dict(pre=(jc, None, None))
        else:
            jkw = dict(pre=(jc, *jrx.pair_rows(jc, j["types"], j["ffd"])))
    common = dict(isqeq=isqeq, nmax=nmax, tol=tol, lmin_f32=lmin_f32)
    jr = jqeq.solve(j["pos"], jnp.zeros(n), jnp.asarray(qsfp), j["H"],
                    j["types"], j["img"], j["nbrs"], j["ffd"], **common,
                    **jkw)
    tr = tqeq.solve(torch.zeros(n, dtype=torch.float64), torch.tensor(qsfp),
                    t["types"], t["ffd"], _operator(t, kw, tc, isqeq),
                    **common)
    return jr, tr


# CG iterations of the capped solves: short enough that the two packages'
# summation orders still agree to ~1e-12 (the CG amplifies rounding ~10x
# per iteration early on: 3e-16 after 3 iterations, 3e-11 after 10, 1e-6
# after 20, before both settle on the solution)
NCAP = 8


LIST_BRANCHES = [b for b in QEQ_BRANCHES if b != "direct"]


def _check_capped(deck, branch, isqeq):
    jr, tr = _solve_both(deck, isqeq, QEQ_BRANCHES[branch],
                         nmax=NCAP if isqeq == 1 else 500)
    assert int(jr.iters) == tr.iters == (NCAP if isqeq == 1 else 1)
    close(jr.q, tr.q, what="q")
    close(jr.qt, tr.qt, what="qt")
    close(jr.est, tr.est, what="est")


def _check_converged(deck, branch):
    jr, tr = _solve_both(deck, 1, QEQ_BRANCHES[branch])
    assert 0 < tr.iters < 500 and 0 < int(jr.iters) < 500
    close(jr.q, tr.q, tol=1e-6, what="q")
    assert abs(float(tr.q.sum())) < 1e-9


@pytest.mark.parametrize("isqeq", [1, 2], ids=["fullCG", "exL"])
@pytest.mark.parametrize("branch", LIST_BRANCHES)
def test_qeq_branches(deck, branch, isqeq):
    """Each branch's hessian, matvec, Est and CG updates: NCAP full-CG
    iterations (or exL's one) give the same charges within 1e-10.  The
    extended Lagrangian never folds: its "fold" cases run the list."""
    _check_capped(deck, branch, isqeq)


@pytest.mark.parametrize("isqeq", [1, 2], ids=["fullCG", "exL"])
def test_qeq_direct(replica, isqeq):
    _check_capped(replica, "direct", isqeq)


@pytest.mark.parametrize("branch", LIST_BRANCHES)
def test_qeq_converged(deck, branch):
    """Full CG to tol 1e-12: both packages reach the same charges and
    stay neutral.  Where the stop test fires is set by rounding once Est
    changes by ~1e-12 relative (measured 77-84 against 80-83 iterations on
    the cell, 100-114 against 100-109 on the triclinic cell, 109 against
    83 on the replica), so the counts are held by the capped solves above,
    and the charges within 1e-6 of max|q|: an iterate that stops 26
    iterations early lies 1.9e-7 e from the other (replica, direct);
    the list forms agree within 2e-9 e."""
    _check_converged(deck, branch)


def test_qeq_direct_converged(replica):
    _check_converged(replica, "direct")


def test_qeq_lmin_f32(deck):
    """lmin_f32 stores the CG step in float32 as the reference does
    (qeq.F90:23): over NCAP iterations the port's charges follow
    rxmd_tpu's within 1e-10, with the same iteration count, and part from
    the float64-step charges by far more."""
    kw = dict(closed_form=False)
    jr, tr = _solve_both(deck, 1, kw, nmax=NCAP, lmin_f32=True)
    assert int(jr.iters) == tr.iters == NCAP
    close(jr.q, tr.q, what="q")
    _, t64 = _solve_both(deck, 1, kw, nmax=NCAP)
    assert float((t64.q - tr.q).abs().max()) > 1e3 * TOL


def _bond_orders(deck):
    j, t = deck["j"], deck["t"]
    ka = ("pos", "H", "types", "img", "nbrs", "ffd")
    return jrx.bond_order(*_args(j, ka)), trx.bond_order(*_args(t, ka))


@pytest.mark.parametrize("mode", ["grid", "compacted"])
def test_e_hbond(deck, ctxs, mode):
    """The uncached hydrogen bonds, energy and forces (autograd against
    jax.grad), in the pair context's grid mode and the compacted mode."""
    j, t = deck["j"], deck["t"]
    caps = deck["caps"]
    jc, tc = ctxs if mode == "grid" else (None, None)

    def jfun(pos):
        bo = jrx.bond_order(pos, *_args(j, ("H", "types", "img", "nbrs",
                                            "ffd")))
        return jrx.e_hbond(pos, j["H"], j["types"], j["img"], j["nbrs"], bo,
                           j["amask"], j["ffd"], cap=caps["hb"],
                           kh=caps["kh"], ctx=jc)
    je, jg = jax.value_and_grad(jfun)(j["pos"])
    p = t["pos"].clone().requires_grad_(True)
    bo = trx.bond_order(p, *_args(t, ("H", "types", "img", "nbrs", "ffd")))
    te = trx.e_hbond(p, t["H"], t["types"], t["img"], t["nbrs"], bo,
                     t["amask"], t["ffd"], cap=caps["hb"], kh=caps["kh"],
                     ctx=tc)
    (tg,) = torch.autograd.grad(te, p)
    assert abs(float(te.detach())) > 0
    close(je, te.detach(), what="Ehb")
    close(jg, tg, what="dEhb/dpos")


@pytest.mark.parametrize("closed_form,fast", [
    (True, True), (False, True), (False, False)],
    ids=["closed", "tables", "autograd"])
def test_energy_and_forces_uncached(deck, closed_form, fast):
    """energy_and_forces with lists=None: the angle, torsion and hbond
    terms enumerated in the call, and the nonbond from the pair context
    (fast_nonbond) or through the table energy's autograd (e_nonbond,
    always the tables)."""
    j, t = deck["j"], deck["t"]
    caps = {k: deck["caps"][k] for k in ("ks", "kh", "hb")}
    ka = ("pos", "q", "H", "types", "gid", "img", "nbrs", "ffd")
    cj, fj, wj = jrx.energy_and_forces(
        *_args(j, ka), caps=caps, closed_form=closed_form,
        fast_nonbond=fast, with_virial=True)
    ct, ft, wt = trx.energy_and_forces(
        *_args(t, ka), caps=caps, closed_form=closed_form,
        fast_nonbond=fast, with_virial=True)
    cj = np.asarray(cj)
    for k in range(14):
        assert abs(cj[k] - float(ct[k])) <= TOL * max(abs(cj[k]), 1e-3), k
    assert all(abs(cj[k]) > 0 for k in (1, 5, 8, 10, 11, 12, 13))
    close(fj, ft, what="forces")
    close(wj, wt, what="virial")


def test_tighten(deck):
    caps = deck["caps"]
    j, t = deck["j"], deck["t"]
    jt = jnb.tighten(j["pos"], j["H"], j["types"], j["img"], j["nbrs"],
                     j["ffd"].rc2b, j["ffd"].rctap2, caps["kb_t"],
                     caps["knb_t"])
    tt = tnb.tighten(t["pos"], t["H"], t["types"], t["img"], t["nbrs"],
                     t["ffd"].rc2b, t["ffd"].rctap2, caps["kb_t"],
                     caps["knb_t"])
    for a, b in zip(jt, tt):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(tt.cntnb.max()) < int(t["nbrs"].cntnb.max())
    assert int(tt.cntnb.max()) <= caps["knb_t"]


def test_brute_build_chunked(deck, monkeypatch):
    """Row blocks of any size give the same lists as one block, and
    rxmd_tpu's brute-force build gives them too."""
    t = deck["t"]
    args = (t["pos"], t["H"], t["types"], t["img"], deck["rc2b"],
            deck["rctap2"], deck["kb"], deck["knb"])
    m = t["img"].owner.shape[0]

    def build(rows):
        monkeypatch.setattr(tnb, "BRUTE_BLOCK", rows * m)
        return tnb.build_neighbors_brute(*args)
    whole = build(deck["n"])
    for rows in (1, 7, 64):
        for a, b in zip(whole, build(rows)):
            assert torch.equal(a, b), rows
    j = deck["j"]
    jn = jnb.build_neighbors_brute(j["pos"], j["H"], j["types"], j["img"],
                                   t2j(deck["rc2b"]), float(deck["rctap2"]),
                                   deck["kb"], deck["knb"])
    for a, b in zip(jn, whole):
        assert np.array_equal(np.asarray(a), b.numpy())
