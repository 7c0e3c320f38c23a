"""Polarizable charge equilibration (PQEq), the core/shell model
(counterpart of rxmd_tpu.pqeq; ref: src/pqeq.F90, module.F90:336-613).

Each polarizable atom carries a Gaussian core of charge q_i + Z_i at pos
and a shell of charge -Z_i at pos + spos.  Charges are solved by the
two-vector CG of QEq with erf-screened Coulomb kernels and a constant
gradient term (Eq. 30 of the PQEq paper, ref: pqeq.F90:326-334); then the
shells take one damped steepest-descent step, capped at 1e-3 A (ref:
pqeq.F90:187-259).  The pair terms run over the skinned nonbonded list
(the ELL form); the kernels are tabulated on an r^2 grid in float64 with
numpy and `math.erf`, then cast, so both packages interpolate the same
numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import qeq, units
from .neighbors import ImageTable, Neighbors, ext_positions
from .reax import FFDev


@dataclasses.dataclass
class PQEqParams:
    """PQEq constants as tensors on one device."""
    ntype: int
    names: tuple
    is_polar: torch.Tensor   # (nt,) bool
    X0: torch.Tensor         # electronegativity override [eV]
    J0: torch.Tensor         # hardness override [eV]
    Z: torch.Tensor          # core charge
    Ks: torch.Tensor         # shell spring constant
    alphacc: torch.Tensor    # (nt, nt) screening parameters
    alphasc: torch.Tensor
    alphass: torch.Tensor
    # kernels on the r^2 grid, (nt, nt, NTABLE+1): value and derivative/r
    pcc: torch.Tensor
    dpcc: torch.Tensor
    psc: torch.Tensor
    dpsc: torch.Tensor
    pss: torch.Tensor
    dpss: torch.Tensor
    udr: torch.Tensor
    udri: torch.Tensor
    rctap2: torch.Tensor


def pqeq_from_numpy(d: dict, dtype=torch.float64, device="cpu") -> PQEqParams:
    """PQEqParams from a dict of numpy arrays keyed by field name, e.g.
    ``{k: np.asarray(v) for k, v in jax_pq._asdict().items()}``."""
    kw = {}
    for f in dataclasses.fields(PQEqParams):
        v = d[f.name]
        if f.name == "ntype":
            kw[f.name] = int(v)
        elif f.name == "names":
            kw[f.name] = tuple(str(x) for x in v)
        elif f.name == "is_polar":
            kw[f.name] = torch.as_tensor(np.array(v, bool), device=device)
        else:
            kw[f.name] = torch.as_tensor(np.array(v, np.float64),
                                         dtype=dtype, device=device)
    return PQEqParams(**kw)


def parse_pqeq_par(path: str):
    """Parse a pqeq1.par file (ref: cmdline.F90:168-236): an NPARMS line,
    then name, P, X0, J0, Z, Rc, Rs, Ks per type in the ffield's order.
    The reference ignores the P column and marks every listed type
    polarizable (cmdline.F90:216); so does this."""
    rows = []
    nparms = None
    with open(path) as fh:
        for line in fh:
            t = line.strip()
            if not t or t.startswith("#"):
                continue
            if t.startswith("NPARMS"):
                nparms = int(t.split()[1])
                continue
            tok = t.split()
            rows.append((tok[0], True, *(float(x) for x in tok[2:8])))
            if nparms and len(rows) == nparms:
                break
    names = tuple(r[0] for r in rows)
    arr = np.array([r[2:] for r in rows])
    return {
        "names": names,
        "is_polar": np.array([r[1] for r in rows]),
        "X0": arr[:, 0], "J0": arr[:, 1], "Z": arr[:, 2],
        "Rc": arr[:, 3], "Rs": arr[:, 4], "Ks": arr[:, 5],
    }


def make_pqeq(par: dict, dtype=torch.float64, rctap: float = None,
              ntable: int = units.NTABLE, device="cpu") -> PQEqParams:
    """Screening alphas (ref: module.F90:448-485) and the tabulated
    kernels (ref: initialize_pqeq module.F90:537-612)."""
    if rctap is None:
        rctap = units.RCTAP0_PQEQ
    nt = len(par["names"])
    polar = np.asarray(par["is_polar"], bool)
    Z = np.where(polar, par["Z"], 0.0)        # ref: module.F90:503-507
    Ks = np.where(polar, par["Ks"], 0.0)
    lam = units.LAMBDA_PQEQ
    a_c = 0.5 * lam / np.asarray(par["Rc"]) ** 2
    a_s = 0.5 * lam / np.asarray(par["Rs"]) ** 2

    def comb(x, y):
        return np.sqrt(x[:, None] * y[None, :] / (x[:, None] + y[None, :]))
    alphacc = comb(a_c, a_c)
    alphass = np.where(polar[:, None] & polar[None, :], comb(a_s, a_s), 0.0)
    alphasc = np.where(polar[:, None], comb(a_s, a_c), 0.0)

    ctap = np.array(units.taper_coeffs(rctap))
    udr = rctap * rctap / ntable
    k = np.arange(ntable + 1, dtype=np.float64)
    dr2 = np.maximum(udr * k, 1e-12)
    dr1 = np.sqrt(dr2)
    dr3, dr4 = dr1 * dr2, dr2 * dr2
    dr5 = dr1 * dr4
    dr6 = dr2 * dr4
    dr7 = dr1 * dr6
    tap = (ctap[7] * dr7 + ctap[6] * dr6 + ctap[5] * dr5 + ctap[4] * dr4
           + ctap[0])
    dtap = (7 * ctap[7] * dr5 + 6 * ctap[6] * dr4 + 5 * ctap[5] * dr3
            + 4 * ctap[4] * dr2)
    erf = np.vectorize(math.erf)

    def kernel(alpha):
        # E = erf(a r)/r * Tap;  dE = (dE/dr)/r  (ref: module.F90:573-607)
        clmb = 1.0 / dr1
        dclmb = -clmb ** 3
        screen = erf(alpha * dr1)
        dscreen = (2.0 * alpha / np.sqrt(np.pi) * np.exp(-alpha * alpha * dr2)
                   / dr1)
        E = clmb * screen * tap
        dE = dclmb * screen * tap + clmb * dscreen * tap + clmb * screen * dtap
        return E, dE

    tabs = {k: np.zeros((nt, nt, ntable + 1))
            for k in ("pcc", "dpcc", "psc", "dpsc", "pss", "dpss")}
    for i in range(nt):
        for j in range(nt):
            for name, alpha in (("cc", alphacc), ("sc", alphasc),
                                ("ss", alphass)):
                tabs["p" + name][i, j], tabs["dp" + name][i, j] = kernel(
                    max(alpha[i, j], 1e-10))

    def f(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                               device=device)
    return PQEqParams(
        ntype=nt, names=tuple(par["names"]),
        is_polar=torch.as_tensor(polar, device=device),
        X0=f(par["X0"]), J0=f(par["J0"]), Z=f(Z), Ks=f(Ks),
        alphacc=f(alphacc), alphasc=f(alphasc), alphass=f(alphass),
        **{k: f(v) for k, v in tabs.items()},
        udr=f(udr), udri=f(1.0 / udr), rctap2=f(rctap * rctap))


def apply_to_ff(ff, par):
    """Override chi/eta of the polarizable types in place (ref:
    module.F90:502-523, including the 2x eta convention)."""
    for i, polar in enumerate(par["is_polar"]):
        if i >= ff.nso:
            break
        if polar:
            ff.chi[i] = par["X0"][i]
            ff.eta[i] = 2.0 * par["J0"][i]
    return ff


def _lerp2(tblE, ti, tj, dr2, udr, udri, mask):
    """Linear interpolation of an (nt, nt, NTABLE+1) kernel table at r^2,
    differentiable in dr2."""
    x = torch.where(mask, dr2, 0.5 * udr) * udri
    itb = torch.clamp(torch.floor(x.detach()).to(torch.int64), 0,
                      tblE.shape[-1] - 2)
    w = x - itb.to(x.dtype)
    return (1.0 - w) * tblE[ti, tj, itb] + w * tblE[ti, tj, itb + 1]


def pqeq_kernels(pq: PQEqParams, tblE, ti, tj, dvec, mask):
    """Tabulated screened-Coulomb value for displacement vectors `dvec`,
    zero beyond the taper cutoff (ref: module.F90:399-416)."""
    dr2 = torch.sum(dvec * dvec, dim=-1)
    m = mask & (dr2 <= pq.rctap2)
    return torch.where(m, _lerp2(tblE, ti, tj, dr2, pq.udr, pq.udri, m), 0.0)


class PQEqCarry(NamedTuple):
    """PQEq's CG loop state (rxmd_tpu pqeq.py:262-266), on the device."""
    it: torch.Tensor      # () int32 completed updates
    qs: torch.Tensor      # (n,) the s and t iterates
    qt: torch.Tensor
    qcur: torch.Tensor    # (n,) their charges
    hs: torch.Tensor      # (n,) search directions
    ht: torch.Tensor
    gs: torch.Tensor      # (n,) gradients
    gt: torch.Tensor
    gnew: torch.Tensor    # (2,) g.g of both
    gest2: torch.Tensor   # () Est of the previous update
    est: torch.Tensor     # () Est of the last iteration run
    done: torch.Tensor    # () bool: a stop test fired
    fin: torch.Tensor     # () bool: the loop has ended


def solve(pos, spos, q, qsfp, H, types, img: ImageTable, nbrs: Neighbors,
          ffd: FFDev, pq: PQEqParams, amask=None, isqeq: int = 1,
          nmax: int = 500, tol: float = 1e-7, lex_fqs: float = 1.0,
          efield_dir=None, efield_strength: float = 0.0,
          lmin_f32: bool = False, allreduce=None, refresh=None,
          loop=None):
    """PQEq CG solve + one shell relaxation step (ref: pqeq.F90:2-259).
    Returns (q, spos_new, iters, Est), iters and Est on the device.

    isqeq=1: full CG from q; isqeq=2: the extended-Lagrangian warm start,
    one iteration.  The loop is rxmd_tpu.pqeq's `lax.while_loop`
    (pqeq.py:275-308) as a masked update, as qeq._cg runs QEq's: each
    iteration tests the stop on Est (ref: pqeq.F90:114-115) and, on a
    stop, keeps the previous iterate; the gradient is recomputed from the
    new iterate, not carried by the residual recurrence of qeq._cg.  The
    iterations run in chunks of qeq.CG_CHUNK, driven by `loop(run_chunk,
    carry, nchunks)` (qeq.eager_loop if None: one host read of the
    finished flag between chunks; a CUDA graph capture passes its own).
    `efield_dir`/`efield_strength`: a constant field on the shell charges
    (ref: pqeq.F90:205).  `lmin_f32` stores the line-minimization step in
    float32 as the reference does (pqeq.F90:27).

    `pos`, `spos` and `types` cover the atoms `img` maps, the center rows
    (`nbrs.center_rows`) first; `q`, `qsfp` and `amask` cover the center
    rows (on one device both are all atoms).  Multi-domain hooks
    (rxmd_tpu pqeq.py:168-179), each None on one device: `allreduce` sums
    a tensor over the domains (three reductions an iteration), `refresh`
    maps a vector over the rows to the extended rows (the ghost exchange,
    ref: MODE_QCOPY1/2, pqeq.F90:89-165)."""
    n = nbrs.center_rows
    dtype = pos.dtype
    dev = pos.device
    multi = allreduce is not None
    if allreduce is None:
        allreduce = lambda x: x
    if refresh is None:
        refresh = lambda x: x
    # float32 floor on the relative-change stop tests (see qeq.solve)
    tol = max(tol, 20.0 * float(torch.finfo(dtype).eps))
    if amask is None:
        amask = torch.ones((n,), dtype=torch.bool, device=dev)
    w = amask.to(dtype)

    pose = ext_positions(pos, H, img)
    mask = nbrs.masknb
    idx = torch.where(mask, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    sposj = spos[oj]                 # shells ride their owner's image
    tr = types[:n]
    ti = tr[:, None]
    tj = types[oj]
    dr = pos[:n, None, :] - pose[idx]
    dr2 = torch.sum(dr * dr, dim=-1)
    mask = mask & (dr2 < pq.rctap2)

    # hessian rows: core-core screened kernel in eV (ref: pqeq.F90:322-324)
    hcc = units.CCLMB0_QEQ * pqeq_kernels(pq, pq.pcc, ti, tj, dr, mask)

    # constant gradient term fpqeq (Eq. 30, ref: pqeq.F90:326-334)
    drcs = dr - sposj                # core(i) - shell(j)
    psc_ji = units.CCLMB0_QEQ * pqeq_kernels(pq, pq.psc, tj, ti, drcs, mask)
    zj = pq.Z[tj]
    polar_j = pq.is_polar[tj]
    fpqeq = torch.sum(torch.where(mask, hcc * zj, 0.0)
                      - torch.where(mask & polar_j, psc_ji * zj, 0.0), dim=1)
    fpqeq = torch.where(amask, fpqeq, 0.0)

    eta = torch.where(amask, ffd.eta[tr], 0.0)
    chi = torch.where(amask, ffd.chi[tr], 0.0)

    def matvec(x):
        xs = torch.where(mask, refresh(x)[oj], 0.0)
        return eta * x + torch.sum(hcc * xs, dim=1)

    def gradient(qs, qt):
        gs = torch.where(amask, -chi - matvec(qs) - fpqeq, 0.0)
        gt = torch.where(amask, -1.0 * w - matvec(qt), 0.0)
        return gs, gt, allreduce(torch.stack([torch.sum(gs * gs),
                                              torch.sum(gt * gt)]))

    # electrostatic energy (ref: get_hsh pqeq.F90:361-435): every directed
    # pair counted once with weight 0.5 for cc and ss, 1.0 for sc
    zi = pq.Z[tr][:, None]
    polar_i = pq.is_polar[tr][:, None]
    drsc = dr + spos[:n, None, :]    # shell(i) - core(j)
    drss = drsc - sposj              # shell(i) - shell(j)
    csc = torch.where(
        mask & polar_i,
        -units.CCLMB0_QEQ * pqeq_kernels(pq, pq.psc, ti, tj, drsc, mask) * zi,
        0.0)
    css = torch.where(
        mask & polar_i & polar_j,
        units.CCLMB0_QEQ * pqeq_kernels(pq, pq.pss, ti, tj, drss, mask)
        * zi * zj, 0.0)
    zt = pq.Z[tr]
    del dr, dr2, drcs, drsc, drss, psc_ji, sposj

    def electrostatic(qcur):
        """This domain's share of Est (the caller reduces it)."""
        qic = qcur + zt
        qjc = torch.where(mask, refresh(qcur)[oj], 0.0) + zj
        pair = 0.5 * (hcc * qic[:, None] * qjc + css) + csc * qjc
        per_atom = (chi * qcur + 0.5 * eta * qcur * qcur
                    + torch.sum(torch.where(mask, pair, 0.0), dim=1))
        return torch.sum(torch.where(amask, per_atom, 0.0))

    def line_products(gs, gt, hs, ht):
        """(g.h, h.Hh) of the two CG directions."""
        hshs_v, hsht_v = matvec(hs), matvec(ht)
        return torch.stack([torch.sum(gs * hs), torch.sum(gt * ht),
                            torch.sum(hs * hshs_v), torch.sum(ht * hsht_v)])

    if isqeq == 2:
        qs0 = torch.where(amask, lex_fqs * qsfp + (1.0 - lex_fqs) * q, 0.0)
        nmax_eff = 1
    else:
        qs0 = torch.where(amask, q, 0.0)
        nmax_eff = int(nmax)
    qt0 = torch.zeros_like(q)
    gs0, gt0, gnew0 = gradient(qs0, qt0)
    scalar = lambda v, dt: torch.full((), v, dtype=dt, device=dev)
    # "never converged yet" sentinel (ref GEst2=1.d99, pqeq.F90:98), the
    # dtype's own max so float32 does not overflow
    carry = PQEqCarry(it=scalar(0, torch.int32), qs=qs0, qt=qt0, qcur=q,
                      hs=gs0, ht=gt0, gs=gs0, gt=gt0, gnew=gnew0,
                      gest2=scalar(torch.finfo(dtype).max, dtype),
                      est=scalar(0.0, dtype), done=scalar(False, torch.bool),
                      fin=scalar(nmax_eff <= 0, torch.bool))

    def body(c):
        """rxmd_tpu's loop body (pqeq.py:279-306) as a masked update."""
        est = electrostatic(c.qcur)
        prods = line_products(c.gs, c.gt, c.hs, c.ht)
        if multi:
            # Est and the four line-search products in one reduction,
            # before the stop test, as in rxmd_tpu's loop body
            red = allreduce(torch.cat([est[None], prods]))
            est, prods = red[0], red[1:]
        ex1 = 0.5 * (torch.abs(c.gest2) + torch.abs(est)) < tol
        ex2 = ((torch.abs(c.gest2) > 0.0)
               & (torch.abs(est / c.gest2 - 1.0) < tol))
        g_h, h_hsh = prods[:2], prods[2:]
        lmin = g_h / torch.where(h_hsh != 0.0, h_hsh, 1.0)
        if lmin_f32:
            lmin = lmin.to(torch.float32).to(dtype)    # ref: pqeq.F90:27
        qs1 = c.qs + lmin[0] * c.hs
        qt1 = c.qt + lmin[1] * c.ht
        st = allreduce(torch.stack([torch.sum(qs1), torch.sum(qt1)]))
        mu = st[0] / st[1]
        q1 = torch.where(amask, qs1 - mu * qt1, 0.0)
        gs1, gt1, gnew1 = gradient(qs1, qt1)
        gsafe = torch.where(torch.abs(c.gnew) > 0.0, c.gnew, 1.0)
        hs1 = gs1 + (gnew1[0] / gsafe[0]) * c.hs
        ht1 = gt1 + (gnew1[1] / gsafe[1]) * c.ht
        # rxmd_tpu's cond (it < nmax and not done); a stop keeps the
        # previous iterate.  `fin` comes from all-reduced scalars alone
        # (Est and the products above): under `allreduce` every domain
        # reads the same flag and runs (or replays) the same number of
        # chunks; a domain running one chunk more would wait forever in
        # its collectives
        run = (c.it < nmax_eff) & ~c.done
        take = run & ~(ex1 | ex2)
        sel = lambda new, old: torch.where(take, new, old)
        it = c.it + take.to(torch.int32)
        done = c.done | (run & ~take)
        return PQEqCarry(it=it, qs=sel(qs1, c.qs), qt=sel(qt1, c.qt),
                         qcur=sel(q1, c.qcur), hs=sel(hs1, c.hs),
                         ht=sel(ht1, c.ht), gs=sel(gs1, c.gs),
                         gt=sel(gt1, c.gt), gnew=sel(gnew1, c.gnew),
                         gest2=sel(est, c.gest2),
                         est=torch.where(run, est, c.est), done=done,
                         fin=done | (it >= nmax_eff))

    if nmax_eff > 0:
        size = min(qeq.CG_CHUNK, nmax_eff)

        def run_chunk(c):
            for _ in range(size):
                c = body(c)
            return c
        carry = (loop or qeq.eager_loop)(run_chunk, carry,
                                         math.ceil(nmax_eff / size))
    qcur = carry.qcur

    spos_new = update_shells(pos, spos, refresh(qcur), H, types, img, nbrs,
                             pq, amask, efield_dir=efield_dir,
                             efield_strength=efield_strength)
    return qcur, spos_new, carry.it, carry.est


def shell_forces(pos, spos, q, H, types, img, nbrs, pq: PQEqParams, amask,
                 efield_dir=None, efield_strength=0.0):
    """Total force on each shell of the center rows: spring + screened
    Coulomb from every neighbor core and shell, + the optional field
    (ref: pqeq.F90:197-238 Eqs. 37-38 + :205).  `pos`, `spos`, `q` and
    `types` cover the atoms `img` maps (see `solve`)."""
    n = nbrs.center_rows
    pose = ext_positions(pos, H, img)
    mask = nbrs.masknb
    idx = torch.where(mask, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    tr = types[:n]
    ti = tr[:, None]
    tj = types[oj]
    zi = pq.Z[tr]
    zj = pq.Z[tj]
    qjc = torch.where(mask, q[oj], 0.0) + zj

    shelli = pos[:n] + spos[:n]
    drsc = shelli[:, None, :] - pose[idx]            # shell(i) - core(j)
    drss = drsc - spos[oj]                           # shell(i) - shell(j)

    def dkern(tbl, dvec):
        dr2 = torch.sum(dvec * dvec, dim=-1)
        m = mask & (dr2 <= pq.rctap2)
        return torch.where(m, _lerp2(tbl, ti, tj, dr2, pq.udr, pq.udri, m),
                           0.0)

    dsc = dkern(pq.dpsc, drsc)[..., None] * drsc
    ff_sc = -units.CCLMB0 * dsc * (qjc * zi[:, None])[..., None]
    dss = dkern(pq.dpss, drss)[..., None] * drss
    polar_j = pq.is_polar[tj]
    ff_ss = torch.where(polar_j[..., None],
                        units.CCLMB0 * dss * (zi[:, None] * zj)[..., None],
                        0.0)
    sforce = -pq.Ks[tr][:, None] * spos[:n] - torch.sum(ff_sc + ff_ss, dim=1)
    if efield_dir is not None and efield_strength != 0.0:
        sforce = sforce.clone()
        sforce[:, efield_dir] += -zi * efield_strength * units.EEV_KCAL
    return sforce


def update_shells(pos, spos, q, H, types, img, nbrs, pq: PQEqParams, amask,
                  efield_dir=None, efield_strength=0.0):
    """One damped steepest-descent shell relaxation, displacement capped at
    1e-3 A (ref: update_shell_positions pqeq.F90:187-259, Eq. 39)."""
    max_disp = 1e-3
    n = nbrs.center_rows
    tr = types[:n]
    sforce = shell_forces(pos, spos, q, H, types, img, nbrs, pq, amask,
                          efield_dir, efield_strength)
    ks = torch.clamp(pq.Ks[tr], min=1e-10)
    dr = sforce / ks[:, None]
    ddr = torch.sqrt(torch.clamp(torch.sum(dr * dr, dim=-1), min=1e-30))
    scale = torch.where(ddr > max_disp, max_disp / ddr, 1.0)
    dr = dr * scale[:, None]
    polar_i = pq.is_polar[tr] & amask
    return torch.where(polar_i[:, None], spos[:n] + dr, spos[:n])
