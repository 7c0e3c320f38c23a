"""The three float32 guards of the bonded terms, in the port against
float64 and against rxmd_tpu's float32.

* `_ratio23`, (2 + e^a) / (1 + e^a + e^b): the valence term's fn8j takes
  a = pval6 * Delta_ang.  With pval6 ~ 34 the naive form's backward
  squares e^a and overflows float32 (e^88.7) once a > 44.4.
* the atan2 angle of `e_3body`: d(arccos)/dcos ~ 1/sqrt(1 - c^2) is
  unbounded at a linear angle, where float32 rounds cos to -1.
* the cos clamp (`_cos_bound` / `_clip_cos`): 1 - 1e-12 rounds to 1 in
  float32, so the bound is 1 - 2e-6 there; the torsion's cos_w and its
  leg angles go through it.

The deck test takes a copy of the in-repo force field with pval6 = 34 for
every angle type and Valangle lowered by 2 for C, O and N, so that
Delta_ang reaches ~2 and a ~ 68 (the naive backward would give inf/NaN).
One valence angle of the 168-atom cell is opened to pi - delta: 1e-3 rad
(near-linear: cos rounds to -1 + 5e-7 in float32) and 1e-7 rad
(near-collinear: below float32's resolution, cos rounds to -1, and each
torsion through the angle has a vanishing cross product).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import neighbors as jnb, reax as jrx
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    reax as trx, system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")


def _ratio_args():
    # a = pval6 * da and b = -pval7 * da over the reachable range of da
    da = np.linspace(-3.0, 3.0, 601)
    return 34.0 * da, -1.5 * da


def test_ratio23_float32():
    """Value and both partial derivatives finite, each within 2e-5 of its
    largest float64 magnitude: float32 rounds |a| <= 102 to an ulp of
    7.6e-6, which moves e^a by that much relative; and equal to rxmd_tpu's
    float32 within 1e-6 (the same expression, the same rounding)."""
    a64, b64 = _ratio_args()
    out = {}
    for dt in (torch.float32, torch.float64):
        a = torch.tensor(a64, dtype=dt, requires_grad=True)
        b = torch.tensor(b64, dtype=dt, requires_grad=True)
        r = trx._ratio23(a, b)
        ga, gb = torch.autograd.grad(r.sum(), (a, b))
        out[dt] = [x.detach().double().numpy() for x in (r, ga, gb)]
    f32, f64 = out[torch.float32], out[torch.float64]
    for x, y in zip(f32, f64):
        assert np.isfinite(x).all()
        assert np.abs(x - y).max() <= 2e-5 * np.abs(y).max()

    ja, jb = jnp.asarray(a64, jnp.float32), jnp.asarray(b64, jnp.float32)
    jr = jrx._ratio23(ja, jb)
    jga, jgb = jax.grad(lambda x, y: jrx._ratio23(x, y).sum(),
                        argnums=(0, 1))(ja, jb)
    # the max-shift's own derivative cancels only in exact arithmetic:
    # O(1) terms cancel, so the two packages part by ~1 float32 ulp of 1
    for x, y in zip(f32, (jr, jga, jgb)):
        y = np.asarray(y, np.float64)
        assert np.abs(x - y).max() <= 1e-6 * max(np.abs(y).max(), 1.0)


def test_cos_bound():
    """The clamp keeps 1 - c^2 representable in each precision."""
    for dt in (torch.float32, torch.float64):
        b = trx._cos_bound(dt)
        assert b == jrx._cos_bound(jnp.float32 if dt == torch.float32
                                   else jnp.float64)
        c = trx._clip_cos(torch.tensor([-1.0, 1.0], dtype=dt))
        assert bool((1.0 - c * c > 0).all())


def _hot_ff():
    ff = tff.parse_ffield(FF)
    va = ff.Valangle.copy()
    va[va > 2.0] -= 2.0
    return dataclasses.replace(ff, pval6=np.full_like(ff.pval6, 34.0),
                               Valangle=va)


def _open_angle(st, va, vc, c, delta):
    """Move atom c (bond vector vc from the center, the other leg va) about
    the center, keeping |vc|, so that the angle is pi - delta in the plane
    of the two legs."""
    u = va / np.linalg.norm(va)
    r = np.linalg.norm(vc)
    perp = vc - (vc @ u) * u
    perp /= np.linalg.norm(perp)
    pos = st.pos.numpy().copy()
    pos[c] += r * (-np.cos(delta) * u + np.sin(delta) * perp) - vc
    return dataclasses.replace(st, pos=torch.as_tensor(pos))


def _lists32(lists):
    return tuple(lst._replace(**{f: getattr(lst, f).float()
                                 for f in lst._fields
                                 if getattr(lst, f).is_floating_point()})
                 for lst in lists)


@pytest.fixture(scope="module")
def pipeline():
    ff = _hot_ff()
    st0 = tsys.from_cellfile(CELL, ff.name_to_type)
    cfg = dict(isQEq=0, term_slack=1.0)
    e = tmd.Engine(ff, st0, tcfg.RunConfig(**cfg), device="cpu")
    e._rebuild(e.state)
    s = e.state
    al = e.tlists[0]
    # an angle at a carbon, over-coordinated for the lowered Valangle
    k = int(torch.argmax(e.ffd.Val[s.types[al.j]]))
    j, a, c = (int(al.j[k]), int(al.oi[k]), int(al.ok[k]))
    drb = trx.bond_order(s.pos, s.H, s.types, e.img, e.nbrs, e.ffd).drb
    va = -drb[j, int(al.a[k])].numpy()
    vc = -drb[j, int(al.c[k])].numpy()
    out = {}
    for delta in (1e-3, 1e-7):
        st = _open_angle(s, va, vc, c, delta)
        eng = tmd.Engine(ff, st, tcfg.RunConfig(**cfg), device="cpu")
        eng._rebuild(eng.state)
        s = eng.state
        res = {}
        for dt in (torch.float64, torch.float32):
            ffd = trx.ffdev_from(ff, dtype=dt)
            img = eng.img._replace(shift=eng.img.shift.to(dt))
            lists = eng.tlists if dt == torch.float64 else \
                _lists32(eng.tlists)
            zero = torch.zeros((), dtype=dt)
            comps, f = trx.energy_and_forces(
                s.pos.to(dt), s.q.to(dt), s.H.to(dt), s.types, s.gid, img,
                eng.nbrs, ffd, lists, external_nonbond=(
                    zero, zero, zero, torch.zeros_like(s.pos.to(dt)), None))
            res[dt] = comps.double().numpy(), f.double().numpy()
        out[delta] = dict(res=res, eng=eng, ff=ff, angle=(j, a, c))
    return out


@pytest.mark.parametrize("delta", [1e-3, 1e-7],
                         ids=["near-linear", "near-collinear"])
def test_bonded_float32_against_float64(pipeline, delta):
    """Energy terms within 2e-6 of |PE| (float32 sums of ~1e4 kcal/mol),
    forces within 1e-3 of max|f|: the opened angle's own forces are
    float32-rounded geometry (|r| ~ 1.4 A, 7 digits) times O(100)
    kcal/mol/A, and no guard may let them blow up."""
    c64, f64 = pipeline[delta]["res"][torch.float64]
    c32, f32 = pipeline[delta]["res"][torch.float32]
    assert np.isfinite(c32).all() and np.isfinite(f32).all()
    assert np.abs(c32 - c64).max() <= 2e-6 * abs(c64[0])
    err = np.abs(f32 - f64).max()
    assert err <= 1e-3 * np.abs(f64).max(), (err, np.abs(f64).max())
    j, a, c = pipeline[delta]["angle"]
    assert np.abs(f32[[j, a, c]] - f64[[j, a, c]]).max() <= \
        1e-3 * np.abs(f64).max()


def _rxmd_tpu_bonded(d, jdt):
    """rxmd_tpu's bonded energy terms and forces on the pipeline's inputs
    (the port's neighbor and term lists, cast to `jdt`)."""
    eng = d["eng"]
    s = eng.state
    jffd = jrx.ffdev_from(d["ff"], dtype=jdt)
    jimg = jnb.make_image_table(s.n, eng.img.nimg, jdt)
    jn = jnb.Neighbors(*(jnp.asarray(x.numpy().astype(np.int32))
                         for x in eng.nbrs))
    lists = _lists32(eng.tlists) if jdt == jnp.float32 else eng.tlists
    cls = (jrx.AngleList, jrx.TorsionList, jrx.HBondList)
    jl = tuple(k(**{f: jnp.asarray(getattr(lst, f).numpy())
                    for f in lst._fields}) for k, lst in zip(cls, lists))
    zero = (0.0, 0.0, 0.0, jnp.zeros((s.n, 3), jdt), None)
    cj, fj = jrx.energy_and_forces(
        jnp.asarray(s.pos.numpy(), jdt), jnp.asarray(s.q.numpy(), jdt),
        jnp.asarray(s.H.numpy(), jdt),
        jnp.asarray(s.types.numpy().astype(np.int32)),
        jnp.asarray(s.gid.numpy().astype(np.int32)), jimg, jn, jffd,
        lists=jl, external_nonbond=zero)
    return np.asarray(cj, np.float64), np.asarray(fj, np.float64)


@pytest.mark.parametrize("delta", [1e-3, 1e-7],
                         ids=["near-linear", "near-collinear"])
def test_bonded_float32_against_rxmd_tpu(pipeline, delta):
    """The same float32 inputs through rxmd_tpu's bonded terms: the same
    expressions in another summation order, so energies within 1e-6 of
    |PE|, and the port's float32 forces within 1e-3 of max|f| of
    rxmd_tpu's float64 forces (the float32 bar above).

    Forces against rxmd_tpu's float32: within 1e-4 of max|f| at the
    near-linear angle.  At the near-collinear one rxmd_tpu's own float32
    forces are wrong: the bond-order gradient on the angle's center (seen
    in Ebond, Eover, Eunder, Etors) is ~100x its float64 value, while the
    port's float32 agrees with both float64 runs.  That is a fault of the
    frozen reference outside the three guards, so there the port is held
    to float64 only."""
    d = pipeline[delta]
    c32, f32 = d["res"][torch.float32]
    cj, fj = _rxmd_tpu_bonded(d, jnp.float32)
    _, fj64 = _rxmd_tpu_bonded(d, jnp.float64)
    assert np.isfinite(cj).all()
    assert np.abs(c32[:11] - cj[:11]).max() <= 1e-6 * abs(cj[0])
    assert np.abs(f32 - fj64).max() <= 1e-3 * np.abs(fj64).max()
    if delta == 1e-3:
        assert np.abs(f32 - fj).max() <= 1e-4 * np.abs(fj).max()
