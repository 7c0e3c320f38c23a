"""ReaxFF potential: bond-order pipeline, bonded energy terms, the
cached many-body lists, and the nonbonded pair forms over the neighbor
list (the pair context) and over dense minimum-image matrices
(counterpart of rxmd_tpu.reax).

Everything works on padded tensors.  Energies reproduce the reference
expressions (ref: src/bo.F90, src/pot.F90) as rxmd_tpu writes them;
bonded forces and the strain virial are the exact negative gradient of
the energy, taken with torch.autograd; the nonbond forces come from the
analytic derivative columns (or, with fast_nonbond=False, the table
energy's autograd); on a card the closed form over the pair list is one
CUDA kernel (ops/nonbond_list).  `energy_and_forces` splices in the
nonbond of whichever pair engine the caller runs (the cell-column sweep
of ops/pairsweep, the dense forms, or the pair context).

Out-of-range scatters (JAX's ``mode="drop"``) write into one extra dump
slot that is sliced off; out-of-range gathers are masked or clamped
explicitly, since torch raises where JAX clamps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import native, units
from .ffield import ForceField, build_tables
from .neighbors import ImageTable, Neighbors, ext_positions
from .ops import hbond as hbond_op
from .ops import nonbond_list as nonbond_op
from .ops import torsion as torsion_op
from .utils import timers as trace


@dataclasses.dataclass
class FFDev:
    """Force-field constants as tensors on one device (the fields of
    rxmd_tpu.reax.FFDev that this engine reads)."""
    vpar1: torch.Tensor
    vpar2: torch.Tensor
    cutoff_vpar30: torch.Tensor
    # per-type (nso,)
    Val: torch.Tensor
    Vale: torch.Tensor
    Valangle: torch.Tensor
    Valval: torch.Tensor
    mass: torch.Tensor
    plp1: torch.Tensor
    plp2: torch.Tensor
    nlpopt: torch.Tensor
    povun2: torch.Tensor
    povun3: torch.Tensor
    povun4: torch.Tensor
    povun5: torch.Tensor
    povun6: torch.Tensor
    povun7: torch.Tensor
    povun8: torch.Tensor
    pval3: torch.Tensor
    pval5: torch.Tensor
    chi: torch.Tensor
    eta: torch.Tensor
    # bond types
    inxn2: torch.Tensor           # (nso, nso) int64, -1 = none
    rc2b: torch.Tensor            # (nso, nso) squared bond cutoff (0 if none)
    cBOp1: torch.Tensor
    cBOp3: torch.Tensor
    cBOp5: torch.Tensor
    pbo2h: torch.Tensor
    pbo4h: torch.Tensor
    pbo6h: torch.Tensor
    switch: torch.Tensor          # (nboty, 3)
    ovc: torch.Tensor
    v13cor: torch.Tensor
    pboc3: torch.Tensor
    pboc4: torch.Tensor
    pboc5: torch.Tensor
    Desig: torch.Tensor
    Depi: torch.Tensor
    Depipi: torch.Tensor
    pbe1: torch.Tensor
    pbe2: torch.Tensor
    povun1: torch.Tensor
    # interaction-type tables
    inxn3: torch.Tensor           # (nso, nso, nso) int64
    inxn4: torch.Tensor           # (nso, nso, nso, nso) int64
    inxn3hb: torch.Tensor         # (nso, nso, nso) int64 (directional)
    h_type: int                   # type index of hydrogen
    # nonbonded interpolation tables (nboty, NTABLE+1) on an r^2 grid
    # (ref: POTENTIALTABLE init.F90:421-522)
    tbl_evdw: torch.Tensor
    tbl_eclmb: torch.Tensor
    tbl_devdw: torch.Tensor       # (dE/dr)/r columns
    tbl_declmb: torch.Tensor
    tbl_eclmb_qeq: torch.Tensor
    udr: torch.Tensor             # r^2 step of the grid
    udri: torch.Tensor
    # the five tables row-packed, (nboty*(NTABLE+1), 5): evdw, eclmb,
    # devdw, declmb, eclmb_qeq
    tblpack: torch.Tensor
    # closed-form nonbond constants
    rctap2: torch.Tensor
    pvdW1h: torch.Tensor
    pvdW1inv: torch.Tensor
    ctap: torch.Tensor            # (8,) taper coefficients
    cf_pair: torch.Tensor         # (nso, nso, 11): [exists, gamW^-p, alpha,
                                  #  1/rvdW, Dij, gamij, C_lg, dr6_lg, ecore,
                                  #  acore, 1/rcore]; 6-10 zero unless LG
    is_lg: bool                   # ReaxFF-lg: the kernels read columns 6-10
    # packed per-interaction-type parameter rows
    angprm: torch.Tensor          # (nanty, 17)
    torprm: torch.Tensor          # (ntoty, 9)
    hbprm: torch.Tensor           # (nhbty, 4)
    hbok: torch.Tensor            # (nso, nso, nso) 1.0 where an hbond exists
    t4ok: torch.Tensor            # (nso, nso, nso, nso) 1.0 where a torsion exists


_INT_FIELDS = ("inxn2", "inxn3", "inxn4", "inxn3hb")


def ffdev_from_numpy(d: dict, dtype=torch.float64, device="cpu") -> FFDev:
    """FFDev from a dict of numpy arrays keyed by field name — e.g. the
    fields of rxmd_tpu's FFDev, ``{k: np.asarray(v) for k, v in
    jax_ffd._asdict().items()}``.  Fields this engine does not read are
    ignored."""
    kw = {}
    for f in dataclasses.fields(FFDev):
        v = d[f.name]
        if f.name == "h_type":
            kw[f.name] = int(v)
        elif f.name == "is_lg":
            kw[f.name] = bool(v)
        elif f.name in _INT_FIELDS:
            kw[f.name] = torch.as_tensor(np.array(v), dtype=torch.int64,
                                         device=device)
        else:
            kw[f.name] = torch.as_tensor(np.array(v, np.float64),
                                         dtype=dtype, device=device)
    return FFDev(**kw)


def ffdev_from(ff: ForceField, dtype=torch.float64, rctap: float = None,
               device="cpu") -> FFDev:
    if rctap is None:
        rctap = units.RCTAP0
    nso = ff.nso
    rc2b = np.zeros((nso, nso))
    for i in range(nso):
        for j in range(nso):
            b = ff.inxn2[i, j]
            if b >= 0:
                rc2b[i, j] = ff.rc2[b]
    try:
        h_type = ff.atom_names.index("H")
    except ValueError:
        h_type = 1  # the reference hardcodes type 2 (1-based) as H
                    # (ref: pot.F90:595 and comment pot.F90:561-567)
    cf = np.zeros((nso, nso, 11))
    for i in range(nso):
        for j in range(nso):
            b = ff.inxn2[i, j]
            if b < 0:
                continue
            cf[i, j, 0] = 1.0
            cf[i, j, 1] = (1.0 / ff.gamW[i, j]) ** ff.pvdW1
            cf[i, j, 2] = ff.alpij[i, j]
            cf[i, j, 3] = 1.0 / ff.rvdW[i, j]
            cf[i, j, 4] = ff.Dij[i, j]
            cf[i, j, 5] = ff.gamij[i, j]
            if ff.is_lg and i < 4 and j < 4:
                cf[i, j, 6] = ff.C_lg[i, j]
                cf[i, j, 7] = (2.0 * np.sqrt(ff.Re_lg[i] * ff.Re_lg[j])) ** 6
                cf[i, j, 8] = ff.ecore[i, j]
                cf[i, j, 9] = ff.acore[i, j]
                cf[i, j, 10] = 1.0 / ff.rcore[i, j] if ff.rcore[i, j] else 0.0
    angprm = np.stack([
        ff.theta00, ff.pval1, ff.pval2, ff.pval4, ff.pval6, ff.pval7,
        ff.pval8, ff.pval9, ff.pval10, ff.ppen1, ff.ppen2, ff.ppen3,
        ff.ppen4, ff.pcoa1, ff.pcoa2, ff.pcoa3, ff.pcoa4], axis=-1)
    torprm = np.stack([ff.V1, ff.V2, ff.V3, ff.ptor1, ff.ptor2, ff.ptor3,
                       ff.ptor4, ff.pcot1, ff.pcot2], axis=-1)
    if ff.r0hb.shape[0] > 0:
        hbprm = np.stack([ff.r0hb, ff.phb1, ff.phb2, ff.phb3], axis=-1)
    else:
        hbprm = np.zeros((0, 4))
    tables = build_tables(ff, rctap=rctap)
    tbl = {k: tables[k] for k in ("evdw", "eclmb", "devdw", "declmb",
                                  "eclmb_qeq")}
    d = {name: getattr(ff, name) for name in (
        "vpar1", "vpar2", "cutoff_vpar30", "Val", "Vale", "Valangle",
        "Valval", "mass", "plp1", "plp2", "nlpopt", "povun2", "povun3",
        "povun4", "povun5", "povun6", "povun7", "povun8", "pval3", "pval5",
        "chi", "eta", "inxn2", "cBOp1", "cBOp3", "cBOp5", "pbo2h", "pbo4h",
        "pbo6h", "switch", "ovc", "v13cor", "pboc3", "pboc4", "pboc5",
        "Desig", "Depi", "Depipi", "pbe1", "pbe2", "povun1", "inxn3",
        "inxn4", "inxn3hb")}
    d.update(rc2b=rc2b, h_type=h_type, rctap2=rctap * rctap,
             pvdW1h=0.5 * ff.pvdW1, pvdW1inv=1.0 / ff.pvdW1,
             ctap=np.array(units.taper_coeffs(rctap)), cf_pair=cf,
             is_lg=bool(ff.is_lg),
             angprm=angprm, torprm=torprm, hbprm=hbprm,
             hbok=(ff.inxn3hb >= 0).astype(np.float64),
             t4ok=(ff.inxn4 >= 0).astype(np.float64),
             udr=tables["udr"], udri=tables["udri"],
             tblpack=np.stack(list(tbl.values()), axis=-1).reshape(-1, 5),
             **{"tbl_" + k: v for k, v in tbl.items()})
    return ffdev_from_numpy(d, dtype=dtype, device=device)


# ----------------------------------------------------------------------------
# small numerics helpers (NaN-safe under autograd).  torch.where has the
# same trap as jnp.where: the unselected branch's derivative still enters
# the backward pass (0 * inf = NaN), so every nonlinear op on masked lanes
# sees a benign base first — the double where.
# ----------------------------------------------------------------------------

def _safe(x, mask, safe_val=1.0):
    """Replace masked-out lanes with a benign value before nonlinear ops so
    neither the forward pass nor the gradient produces NaN/Inf there."""
    return torch.where(mask, x, safe_val)


def _powm(x, p, mask):
    """x**p with masked lanes forced to a safe base."""
    return torch.where(mask, _safe(x, mask) ** p, 0.0)


# exp clamp at +-85 (exp(85) = 8.2e36 < f32 max): a no-op for every
# physically reachable argument, but keeps padding lanes (delta ~ -Val,
# vpar1 = 50) finite in f32 and their gradients free of inf * 0 = NaN
_EXP_CAP = 85.0


def _exp(x):
    return torch.exp(torch.clamp(x, -_EXP_CAP, _EXP_CAP))


def _ratio23(a, b):
    """(2 + e^a) / (1 + e^a + e^b), overflow-free in the forward AND the
    backward pass (softmax-style max-shift: every exponent <= 0)."""
    m = torch.clamp(torch.maximum(a, b), min=0.0)
    ea = torch.exp(a - m)
    eb = torch.exp(b - m)
    e0 = torch.exp(-m)
    return (2.0 * e0 + ea) / (e0 + ea + eb)


def _logistic(u):
    """1/(1+exp(u)) via sigmoid: overflow-free forward AND backward."""
    return torch.sigmoid(-u)


def _take(x, idx):
    """x[idx] along dim 0 for differentiable x.  Its backward is an atomic
    index_add_; the backward of x[idx] sorts the indices and walks each run
    of repeats serially on CUDA, and padded lanes all repeat one index
    (measured on an H100: 1.3 s of a 1.6 s step at 8,064 atoms)."""
    return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def charge_energy(q, types, amask, ffd: FFDev):
    """Charge self-energy, eV -> kcal (ref: pot.F90:708)."""
    return torch.sum(torch.where(
        amask,
        units.CECHRGE * (ffd.chi[types] * q + 0.5 * ffd.eta[types] * q * q),
        0.0))


# ----------------------------------------------------------------------------
# The nonbonded pair context: one (n, knb) pass over the nonbonded list whose
# geometry the QEq hessian, the nonbond kernels and the hydrogen bonds share
# (the ELL pair engine).  Per-pair type parameters are direct gathers of the
# (nso, nso) tables, which give exactly the values of rxmd_tpu's one-hot
# contractions.
# ----------------------------------------------------------------------------

class NbCtx(NamedTuple):
    idx: torch.Tensor      # (n, knb) clamped ext indices
    mask: torch.Tensor     # (n, knb) slot valid & within taper & live row
    notself: torch.Tensor  # (n, knb) excludes periodic self-images (ref:
                           # pot.F90:715): QEq keeps them, ENbond drops them
    dr: torch.Tensor       # (n, knb, 3) r_i - r_j, no gradient
    dr2: torch.Tensor      # (n, knb)
    qj: torch.Tensor       # (n, knb) neighbor charges, or None
    tj: torch.Tensor       # (n, knb) neighbor types, int64
    src: nonbond_op.NonbondInputs = None  # what the context was made from:
                                          # the nonbond kernel reads it


def nb_ctx(pos, q, H, types, img: ImageTable, nbrs: Neighbors, gid, amask,
           ffd: FFDev) -> NbCtx:
    """The shared pair data over the nonbonded list; q=None leaves the
    charges out (gather them later with `ctx_qj`).  Not differentiable:
    the nonbond forces come from the analytic derivative columns (ref:
    pot.F90:736-761).  Rows: `nbrs.center_rows`."""
    n = nbrs.center_rows
    pos = pos.detach()
    pose = ext_positions(pos, H.detach(), img)
    idx = torch.where(nbrs.masknb, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    dr = pos[:n, None, :] - pose[idx]
    dr2 = torch.sum(dr * dr, dim=-1)
    if img.n_images > 1:
        # image mode: same owner <=> same global id
        notself = oj != torch.arange(n, device=pos.device)[:, None]
    else:
        notself = gid[idx] != gid[:n, None]
    mask = nbrs.masknb & (dr2 <= ffd.rctap2) & amask[:n, None]
    src = nonbond_op.NonbondInputs(pos.contiguous(), H.detach().contiguous(),
                                   types, gid, amask, img, nbrs, ffd)
    return NbCtx(idx=idx, mask=mask, notself=notself, dr=dr, dr2=dr2,
                 qj=None if q is None else q[oj], tj=types[oj], src=src)


def _n_prm(ffd: FFDev):
    """The columns of cf_pair the kernels read: all 11 under LG, else the
    first 6 (an (n, n, 6) float32 stack at 8,064 atoms is 1.56 GB)."""
    return 11 if ffd.is_lg else 6


def ctx_prm(ctx: NbCtx, types, ffd: FFDev):
    """Closed-form pair parameters (n, knb, 6 or 11): the columns of
    cf_pair the vdW, Coulomb and QEq kernels read."""
    return ffd.cf_pair[types[:, None], ctx.tj, :_n_prm(ffd)]


def ctx_qj(ctx: NbCtx, q, img: ImageTable):
    """Neighbor charges (n, knb) for a charge vector: QEq (pre-solve q) and
    the nonbond kernels (post-solve q) share one context."""
    return q[img.owner_of(ctx.idx)]


def pair_bond_type(ctx: NbCtx, types, ffd: FFDev):
    """Per-pair bond-type index (n, knb), -1 where the pair has none."""
    return ffd.inxn2[types[:, None], ctx.tj]


def _table_rows(ffd: FFDev, bc, dr2, mask):
    """The 5 tabulated kernel columns at r^2 (..., 5) by linear
    interpolation between two packed table rows (ref: pot.F90:729-743);
    `bc` must be a valid bond type on every lane."""
    nrows = ffd.tbl_evdw.shape[1]                         # NTABLE+1
    x = _safe(dr2, mask, 0.5 * ffd.udr) * ffd.udri
    itb = torch.clamp(torch.floor(x).to(torch.int64), 0, nrows - 2)
    w = (x - itb)[..., None]
    base = bc * nrows + itb
    return (1.0 - w) * ffd.tblpack[base] + w * ffd.tblpack[base + 1]


def pair_rows(ctx: NbCtx, types, ffd: FFDev):
    """(table rows (n, knb, 5), pair-exists mask) over the context: built
    once per step and shared by the QEq hessian and the nonbond kernels."""
    bc = pair_bond_type(ctx, types, ffd)
    ok = ctx.mask & (bc >= 0)
    return _table_rows(ffd, torch.where(ok, bc, 0), ctx.dr2, ok), ok


def _taper_pair(dr2, dr1, ctap):
    """Taper polynomial and its r-derivative/r (ref: init.F90:437-439)."""
    dr3 = dr1 * dr2
    dr4 = dr2 * dr2
    dr5 = dr1 * dr4
    dr6 = dr2 * dr4
    dr7 = dr1 * dr6
    tap = (ctap[7] * dr7 + ctap[6] * dr6 + ctap[5] * dr5 + ctap[4] * dr4
           + ctap[0])
    dtap = (7.0 * ctap[7] * dr5 + 6.0 * ctap[6] * dr4 + 5.0 * ctap[5] * dr3
            + 4.0 * ctap[4] * dr2)
    return tap, dtap


def cf_nonbond(dr2, prm, ffd: FFDev, mask):
    """Closed-form vdW and Coulomb kernels and their (dE/dr)/r columns: the
    analytic content of the reference's tables (ref: init.F90:440-514, with
    the LG dispersion and inner-core terms :496-514 when `ffd.is_lg`).
    Returns (evdw, eclmb per unit q_i q_j, devdw, declmb, ok)."""
    ok = mask & (prm[..., 0] > 0.5)
    dr2s = _safe(dr2, ok)
    dr1 = torch.sqrt(dr2s)
    tap, dtap = _taper_pair(dr2s, dr1, ffd.ctap)
    gamwinvp = _safe(prm[..., 1], ok)
    alpha = prm[..., 2]
    rvdwi = prm[..., 3]
    dij = prm[..., 4]
    rij_vd1 = dr2s ** ffd.pvdW1h
    fn13 = (rij_vd1 + gamwinvp) ** ffd.pvdW1inv
    exp1 = torch.exp(alpha * (1.0 - fn13 * rvdwi))
    exp2 = torch.sqrt(exp1)
    dr3gam = (dr1 * dr2s + _safe(prm[..., 5], ok)) ** (-1.0 / 3.0)
    evdw = tap * dij * (exp1 - 2.0 * exp2)
    eclmb1 = tap * units.CCLMB0 * dr3gam
    dfn13 = ((rij_vd1 + gamwinvp) ** (ffd.pvdW1inv - 1.0)
             * dr2s ** (ffd.pvdW1h - 1.0))
    devdw = dij * (dtap * (exp1 - 2.0 * exp2)
                   - tap * (alpha * rvdwi) * (exp1 - exp2) * dfn13)
    declmb1 = units.CCLMB0 * dr3gam * (dtap - dr3gam ** 3 * tap * dr1)
    if ffd.is_lg:
        dr3 = dr1 * dr2s
        clg = prm[..., 6]
        den = dr3 * dr3 + _safe(prm[..., 7], ok)
        elg = -clg / den
        acore = _safe(prm[..., 9], ok, 0.0)
        rcorei = _safe(prm[..., 10], ok, 0.0)
        ecore = prm[..., 8] * torch.exp(acore * (1.0 - dr1 * rcorei))
        delg = clg * 6.0 * dr2s * dr2s / den ** 2
        decore = -acore * ecore * rcorei / dr1
        evdw = evdw + tap * (elg + ecore)
        devdw = devdw + dtap * (elg + ecore) + tap * (delg + decore)
    return evdw, eclmb1, devdw, declmb1, ok


def cf_qeq_kernel(dr2, prm, ffd: FFDev, mask):
    """Closed-form QEq hessian kernel Tap(r) * 14.4 / (r^3+gamma)^(1/3)
    (ref: init.F90:487-489), zero off `mask`."""
    ok = mask & (prm[..., 0] > 0.5)
    dr2s = _safe(dr2, ok)
    dr1 = torch.sqrt(dr2s)
    tap, _ = _taper_pair(dr2s, dr1, ffd.ctap)
    dr3gam = (dr1 * dr2s + _safe(prm[..., 5], ok)) ** (-1.0 / 3.0)
    return torch.where(ok, tap * units.CCLMB0_QEQ * dr3gam, 0.0)


def _pair_virial(ffac, dr):
    """Pair virial W_ab = -dE/deps_ab over directed rows: each undirected
    pair appears twice, hence the 0.5 (ref: the Σ pos·f accumulation incl.
    ghost rows, pot.F90:65-72)."""
    return -0.5 * torch.einsum("nk,nka,nkb->ab", ffac, dr, dr)


def _nonbond_rows(ctx: NbCtx, m, q, img, e_vdw, e_clmb1, d_vdw, d_clmb1,
                  types, amask, ffd, with_virial):
    """Energies, row-local forces [and virial] from per-pair kernel columns
    over the mask `m` of directed pairs (energies carry the 0.5
    double-count factor; ref force expression: pot.F90:736-761)."""
    qj = ctx.qj if ctx.qj is not None else ctx_qj(ctx, q, img)
    qq = q[:, None] * qj
    evdw = 0.5 * torch.sum(torch.where(m, e_vdw, 0.0))
    eclmb = 0.5 * torch.sum(torch.where(m, e_clmb1 * qq, 0.0))
    ffac = torch.where(m, d_vdw + d_clmb1 * qq, 0.0)
    f = -torch.einsum("nk,nka->na", ffac, ctx.dr)
    echarge = charge_energy(q, types, amask, ffd)
    if with_virial:
        return evdw, eclmb, echarge, f, _pair_virial(ffac, ctx.dr)
    return evdw, eclmb, echarge, f


def nonbond_tbl_energy_forces(ctx: NbCtx, q, types, amask, ffd: FFDev,
                              with_virial=False, pre=None, img=None):
    """vdW + Coulomb energies and row-local forces from the reference's
    interpolation tables over the pair context; `pre=(rows, ok)` reuses the
    rows of `pair_rows` (shared with the QEq hessian)."""
    if pre is not None:
        rows, ok = pre
        m = ok & ctx.notself & ctx.mask
    else:
        bc = pair_bond_type(ctx, types, ffd)
        m = ctx.mask & ctx.notself & (bc >= 0)
        rows = _table_rows(ffd, torch.where(m, bc, 0), ctx.dr2, m)
    return _nonbond_rows(ctx, m, q, img, rows[..., 0], rows[..., 1],
                         rows[..., 2], rows[..., 3], types, amask, ffd,
                         with_virial)


def nonbond_cf_energy_forces(ctx: NbCtx, q, types, amask, ffd: FFDev,
                             with_virial=False, img=None):
    """vdW + Coulomb energies and row-local forces from the closed-form
    kernels over the pair context."""
    m = ctx.mask & ctx.notself
    evdw_p, eclmb1, devdw, declmb1, ok = cf_nonbond(
        ctx.dr2, ctx_prm(ctx, types, ffd), ffd, m)
    return _nonbond_rows(ctx, m & ok, q, img, evdw_p, eclmb1, devdw,
                         declmb1, types, amask, ffd, with_virial)


def nonbond_ctx_energy_forces(ctx: NbCtx, q, types, amask, ffd: FFDev,
                              closed_form, with_virial=False, pre=None,
                              img=None):
    """(evdw, eclmb, echarge, f[, virial]) over the pair context: the
    closed form, or the tables (`pre` as in nonbond_tbl_energy_forces).
    The closed form without LG on a card is one CUDA kernel over the rows
    the context was made from (ops/nonbond_list, `ctx.src`)."""
    if (closed_form and not ffd.is_lg
            and native.device_kind(q, "nonbond_list") == "cuda"):
        evdw, eclmb, f, w = nonbond_op.nonbond_list(ctx.src, q, ctx.qj,
                                                    with_virial)
        echarge = charge_energy(q, types, amask, ffd)
        return (evdw, eclmb, echarge, f, w)[:5 if with_virial else 4]
    if closed_form:
        return nonbond_cf_energy_forces(ctx, q, types, amask, ffd,
                                        with_virial=with_virial, img=img)
    return nonbond_tbl_energy_forces(ctx, q, types, amask, ffd,
                                     with_virial=with_virial, pre=pre,
                                     img=img)


# ----------------------------------------------------------------------------
# Dense minimum-image forms: (n, n) pair matrices with no neighbor list, for
# an orthogonal box with min(L) > 2*rctap (each pair has at most one image
# within the cutoff).  The physics is the closed-form pair path's; only the
# summation order differs.
# ----------------------------------------------------------------------------

def _type_prm_dense(types, P):
    """(n, n[, k]) per-pair parameters P[t_i, t_j] of an (nso, nso[, k])
    table."""
    return P[types[:, None], types[None, :]]


def _min_image_ax(pos, H, ax):
    """Per-axis minimum-image difference and wrap count (diagonal box)."""
    La = H[ax, ax]
    d = pos[:, None, ax] - pos[None, :, ax]
    s = torch.round(d / La)
    return d - s * La, s


def _min_image(pos, H):
    """((dx, dy, dz), unwrapped mask, dr2) over all (n, n) pairs."""
    ds, ss = zip(*(_min_image_ax(pos, H, ax) for ax in range(3)))
    unwrapped = (ss[0] == 0) & (ss[1] == 0) & (ss[2] == 0)
    return ds, unwrapped, ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2]


def qeq_dense_direct(pos, H, types, ffd: FFDev):
    """(Hd, Hw): the dense (n, n) QEq hessian Tap(r)*14.4/(r^3+gam)^(1/3)
    (ref kernel: init.F90:487-489) at minimum-image distances, and its
    Est-weighted copy: 1.0 for unwrapped pairs, 0.5 for image pairs (the
    ELL form's ext-index < n rule, ref: qeq.F90:304-306)."""
    n = pos.shape[0]
    _, unwrapped, dr2 = _min_image(pos, H)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    ok = ((_type_prm_dense(types, ffd.cf_pair[..., 0]) > 0.5)
          & (dr2 < ffd.rctap2) & ~eye)
    dr2s = _safe(dr2, ok)
    dr1 = torch.sqrt(dr2s)
    tap, _ = _taper_pair(dr2s, dr1, ffd.ctap)
    gam = _safe(_type_prm_dense(types, ffd.cf_pair[..., 5]), ok)
    hm = torch.where(ok, tap * units.CCLMB0_QEQ
                     * (dr1 * dr2s + gam) ** (-1.0 / 3.0), 0.0)
    return hm, torch.where(unwrapped, hm, 0.5 * hm)


def nonbond_dense(pos, q, H, types, amask, ffd: FFDev, with_virial=False):
    """Dense minimum-image closed-form vdW + Coulomb: energies, row-local
    forces [and pair virial], the dense analog of
    `nonbond_cf_energy_forces` (force expression ref: pot.F90:736-761)."""
    n = pos.shape[0]
    ds, _, dr2 = _min_image(pos, H)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = ((dr2 <= ffd.rctap2) & ~eye & amask[:, None] & amask[None, :])
    prm = _type_prm_dense(types, ffd.cf_pair[..., :_n_prm(ffd)])
    evdw_p, eclmb1, devdw, declmb1, ok = cf_nonbond(dr2, prm, ffd, mask)
    del prm
    m = mask & ok
    qq = q[:, None] * q[None, :]
    evdw = 0.5 * torch.sum(torch.where(m, evdw_p, 0.0))
    eclmb = 0.5 * torch.sum(torch.where(m, eclmb1 * qq, 0.0))
    ffac = torch.where(m, devdw + declmb1 * qq, 0.0)
    fd = [ffac * d for d in ds]
    f = -torch.stack([torch.sum(x, dim=1) for x in fd], dim=-1)
    echarge = charge_energy(q, types, amask, ffd)
    if with_virial:
        w = torch.stack([torch.stack([torch.sum(fd[a] * ds[b])
                                      for b in range(3)]) for a in range(3)])
        return evdw, eclmb, echarge, f, -0.5 * w
    return evdw, eclmb, echarge, f


# ----------------------------------------------------------------------------
# Bond-order pipeline (ref: bo.F90)
# ----------------------------------------------------------------------------

class BondOrder(NamedTuple):
    bo: torch.Tensor       # (N, kb, 4): full BO, sigma, pi, pipi
    delta: torch.Tensor    # (N,) -Val + sum BO0   (ref: bo.F90:291-296)
    deltap1: torch.Tensor  # (N,) uncorrected Delta' (ref: bo.F90:41-45)
    mask: torch.Tensor     # (N, kb) pair validity (includes BO'>cutoff gate)
    drb: torch.Tensor      # (N, kb, 3) r_center - r_neighbor, differentiable


def bond_order(pos, H, types, img: ImageTable, nbrs: Neighbors,
               ffd: FFDev) -> BondOrder:
    """BO' then corrected BO per directed bonded pair (ref: bo.F90:28-298),
    on owner rows: dr = pos_i - (pos[owner] + shift @ H^T) with the
    constant shift table, so gradients land in the (n, 3) owner rows."""
    mask = nbrs.maskb
    idx = torch.where(mask, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    ti = types[:, None]
    tj = types[oj]
    b = ffd.inxn2[ti, tj].clamp(min=0)       # bond type; valid where mask

    shg = img.shift.to(pos.dtype)[idx]       # (N, kb, 3), constant
    dr = (pos[:, None, :] - _take(pos, oj)
          - torch.einsum("nka,ba->nkb", shg, H))
    dr2 = torch.sum(dr * dr, dim=-1)
    # re-check the true sigma-bond cutoff (ref: bo.F90:65)
    mask = mask & (dr2 <= ffd.rc2b[ti, tj])
    dr2s = _safe(dr2, mask)

    # --- BO' (ref: bo.F90:62-110)
    arg1 = ffd.cBOp1[b] * _powm(dr2s, ffd.pbo2h[b], mask)
    arg2 = ffd.cBOp3[b] * _powm(dr2s, ffd.pbo4h[b], mask)
    arg3 = ffd.cBOp5[b] * _powm(dr2s, ffd.pbo6h[b], mask)
    bop1 = ffd.switch[b, 0] * torch.exp(arg1)
    bop2 = ffd.switch[b, 1] * torch.exp(arg2)
    bop3 = ffd.switch[b, 2] * torch.exp(arg3)
    # sigma-prime energy modification (ref: bo.F90:73-99)
    bop1 = (1.0 + ffd.cutoff_vpar30) * bop1
    above = (bop1 + bop2 + bop3) > ffd.cutoff_vpar30
    gate = mask & above
    bop1 = torch.where(gate, bop1 - ffd.cutoff_vpar30, 0.0)
    bop2 = torch.where(gate, bop2, 0.0)
    bop3 = torch.where(gate, bop3, 0.0)
    bop0 = bop1 + bop2 + bop3

    deltap1 = -ffd.Val[types] + torch.sum(bop0, dim=1)
    deltap2 = deltap1 + ffd.Val[types] - ffd.Valval[types]  # (bo.F90:151)

    # --- corrected BO (ref: bo.F90:156-217)
    d1i = deltap1[:, None]
    d1j = _take(deltap1, oj)
    dp2j = _take(deltap2, oj)
    e1i = _exp(-ffd.vpar1 * d1i)
    e1j = _exp(-ffd.vpar1 * d1j)
    e2i = _exp(-ffd.vpar2 * d1i)
    e2j = _exp(-ffd.vpar2 * d1j)
    fn2 = e1i + e1j
    fn3 = (-1.0 / ffd.vpar2) * torch.log(0.5 * (e2i + e2j))
    fn23 = fn2 + fn3
    vi = ffd.Val[ti]
    vj = ffd.Val[tj]
    fn1 = 0.5 * ((vi + fn2) / (vi + fn23) + (vj + fn2) / (vj + fn23))
    fn1 = torch.where(ffd.ovc[b] < 1e-3, 1.0, fn1)

    bopsqr = bop0 * bop0
    u4 = -ffd.pboc3[b] * (ffd.pboc4[b] * bopsqr - deltap2[:, None]) \
        + ffd.pboc5[b]
    u5 = -ffd.pboc3[b] * (ffd.pboc4[b] * bopsqr - dp2j) + ffd.pboc5[b]
    fn4 = _logistic(u4)
    fn5 = _logistic(u5)
    no_v13 = ffd.v13cor[b] < 1e-3
    fn4 = torch.where(no_v13, 1.0, fn4)
    fn5 = torch.where(no_v13, 1.0, fn5)

    fn45 = fn4 * fn5
    fn145 = fn1 * fn45
    fn1145 = fn1 * fn145

    bo0 = bop0 * fn145
    bo2 = bop2 * fn1145
    bo3 = bop3 * fn1145
    bo0 = torch.where(bo0 < 1e-10, 0.0, bo0)       # floors (bo.F90:210-212)
    bo2 = torch.where(bo2 < 1e-10, 0.0, bo2)
    bo3 = torch.where(bo3 < 1e-10, 0.0, bo3)
    bo1 = bo0 - bo2 - bo3
    bo = torch.stack([bo0, bo1, bo2, bo3], dim=-1)
    bo = torch.where(gate[..., None], bo, 0.0)

    delta = -ffd.Val[types] + torch.sum(bo[..., 0], dim=1)
    return BondOrder(bo=bo, delta=delta, deltap1=deltap1, mask=gate, drb=dr)


class LonePair(NamedTuple):
    nlp: torch.Tensor      # (N,)
    deltalp: torch.Tensor  # (N,)
    dDlp: torch.Tensor     # (N,) dnlp/ddelta


def lone_pair(types, delta, ffd: FFDev) -> LonePair:
    """Lone-pair preparation shared by Elnpr and E3b (ref: pot.F90:181-209)."""
    deltaE = -ffd.Vale[types] + ffd.Val[types] + delta
    dEh = 0.5 * deltaE
    idEh = torch.trunc(dEh).detach()             # Fortran int() truncation
    x = 2.0 + deltaE - 2.0 * idEh
    explp1 = torch.exp(-ffd.plp1[types] * x * x)
    clp = 2.0 * ffd.plp1[types] * explp1 * x
    nlp = explp1 - idEh
    deltalp = ffd.nlpopt[types] - nlp
    deltalp = torch.where(ffd.mass[types] > 21.0, 0.0, deltalp)  # pot.F90:207
    return LonePair(nlp=nlp, deltalp=deltalp, dDlp=clp)


def e_bond(types, img, nbrs, bo: BondOrder, gid, amask, ffd: FFDev):
    """Sigma/pi/pipi bond energy (ref: pot.F90:926-977)."""
    mask = bo.mask
    idx = torch.where(mask, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    b = ffd.inxn2[types[:, None], types[oj]].clamp(min=0)
    # count each bond once via global-id ordering (ref: pot.F90:949)
    mask = mask & (gid[oj] < gid[:, None]) & amask[:, None]
    bo1, bo2, bo3 = bo.bo[..., 1], bo.bo[..., 2], bo.bo[..., 3]
    # guard sigma-BO**pbe2 against 0**(p-1) gradient blowup at BO1 == 0
    mpos = mask & (bo1 > 0.0)
    exp_be12 = torch.exp(ffd.pbe1[b] * (1.0 - _powm(bo1, ffd.pbe2[b], mpos)))
    pebo = (-ffd.Desig[b] * bo1 * exp_be12
            - ffd.Depi[b] * bo2 - ffd.Depipi[b] * bo3)
    return torch.sum(torch.where(mask, pebo, 0.0))


def e_lnpr(types, img, nbrs, bo: BondOrder, lp: LonePair, amask,
           ffd: FFDev):
    """Lone-pair, over- and under-coordination energies
    (ref: pot.F90:213-259)."""
    idx = torch.where(bo.mask, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    t = types
    b = ffd.inxn2[t[:, None], types[oj]].clamp(min=0)

    sum_ovun1 = torch.sum(torch.where(
        bo.mask, ffd.povun1[b] * ffd.Desig[b] * bo.bo[..., 0], 0.0), dim=1)
    dmdlp_j = _take(bo.delta, oj) - _take(lp.deltalp, oj)
    sum_ovun2 = torch.sum(torch.where(
        bo.mask, dmdlp_j * (bo.bo[..., 2] + bo.bo[..., 3]), 0.0), dim=1)

    pelp = ffd.plp2[t] * lp.deltalp * _logistic(-75.0 * lp.deltalp)

    expovun1 = ffd.povun3[t] * _exp(ffd.povun4[t] * sum_ovun2)
    deltalpcorr = bo.delta - lp.deltalp / (1.0 + expovun1)
    expovun2 = _exp(ffd.povun2[t] * deltalpcorr)
    dlpv = 1.0 / (deltalpcorr + ffd.Val[t] + 1e-8)
    expovun2n = _exp(-ffd.povun2[t] * deltalpcorr)
    expovun6 = _exp(ffd.povun6[t] * deltalpcorr)
    expovun8 = ffd.povun7[t] * _exp(ffd.povun8[t] * sum_ovun2)

    peover = sum_ovun1 * dlpv * deltalpcorr / (1.0 + expovun2)
    peunder = (-ffd.povun5[t] * (1.0 - expovun6)
               / (1.0 + expovun2n) / (1.0 + expovun8))

    w = amask.to(pelp.dtype)
    return (torch.sum(w * pelp), torch.sum(w * peover),
            torch.sum(w * peunder))


def _shift_code(shift):
    """Pack an integer periodic shift (components in [-4,4]) into one int."""
    si = torch.round(shift).to(torch.int64)
    return ((si[..., 0] + 4) * 9 + (si[..., 1] + 4)) * 9 + (si[..., 2] + 4)


def _ext_key(img):
    """Unique integer identity of each extended entry: owner*729 + shift."""
    return img.owner * 729 + _shift_code(img.shift)


def _row_topk_slots(mask2d, cap):
    """Per-row compaction: indices of up to `cap` True entries of a (n, S)
    boolean mask, lowest index first (lax.top_k's tie order, through a
    stable sort).  Returns (idx (n,cap), valid (n,cap), counts (n,))."""
    order = torch.argsort(mask2d.to(torch.int8), dim=1, descending=True,
                          stable=True)[:, :cap]
    valid = torch.gather(mask2d, 1, order)
    return torch.where(valid, order, 0), valid, mask2d.sum(dim=1)


def _cos_bound(dtype):
    """Angle clamp (ref: module.F90:85-86), widened for single precision
    where 1-1e-12 rounds to exactly 1."""
    return units.MAXANGLE if dtype == torch.float64 else 1.0 - 2e-6


def _clip_cos(cos):
    b = _cos_bound(cos.dtype)
    return torch.clamp(cos, -b, b)


def _angle_cos(rij, rjk, mask):
    """cos(theta_ijk) = -rij.rjk/(|rij||rjk|) with reference clamping
    (ref: pot.F90:394-396)."""
    nij = torch.sqrt(_safe(torch.sum(rij * rij, dim=-1), mask))
    njk = torch.sqrt(_safe(torch.sum(rjk * rjk, dim=-1), mask))
    cos = -torch.sum(rij * rjk, dim=-1) / (nij * njk)
    return _clip_cos(cos), nij, njk


def strong_slots(bo: BondOrder, ks: int):
    """Per-atom compaction of bonded slots with BO0 > cutof2_esub."""
    okb = bo.mask & (bo.bo[..., 0].detach() > units.CUTOF2_ESUB)
    return _row_topk_slots(okb, ks)


# ----------------------------------------------------------------------------
# Many-body interaction lists: built (integer slot selection, no gradient)
# on the rebuild cadence with slackened gates, re-gated exactly with live
# bond orders at evaluation (see rxmd_tpu.reax for the caching contract).
# ----------------------------------------------------------------------------

def _flat_compact(mask_flat, cap):
    """Pack the indices of True entries of a flat mask into a fixed-size
    list, in index order.  Returns (idx (cap,), valid (cap,), count);
    entries past `cap` are dropped and surface as cnt > cap."""
    pos = torch.cumsum(mask_flat, dim=0) - 1
    src = torch.arange(mask_flat.shape[0], device=mask_flat.device)
    dst = torch.where(mask_flat & (pos < cap), pos, cap)      # cap: dump
    idx = torch.zeros((cap + 1,), dtype=torch.int64, device=mask_flat.device)
    idx.scatter_(0, dst, src)
    cnt = mask_flat.sum()
    valid = torch.arange(cap, device=mask_flat.device) < cnt
    return idx[:cap], valid, cnt


def _count(counts, name, value):
    """Keep the largest `value` under `name` in the dict `counts` (device
    tensors: no host read)."""
    old = counts.get(name)
    counts[name] = value if old is None else torch.maximum(old, value)


def _check_ks(cand_cnt, ks):
    """Raise where a center has more than `ks` candidate bonds
    (`cand_cnt`, a count per row): one host read."""
    kmax = int(cand_cnt.max()) if cand_cnt.numel() else 0
    if kmax > ks:
        raise RuntimeError(f"many-body candidate overflow: {kmax} bonds at "
                           f"one center > ks={ks} (raise caps['ks'])")


def _exact_compact(mask_flat, cand_cnt, ks):
    """Indices of every True entry of a flat mask, in index order, for the
    uncached terms' per-step lists.  A center with more than `ks`
    candidate bonds (`cand_cnt`) would lose entries: that raises, where
    rxmd_tpu drops them."""
    _check_ks(cand_cnt, ks)
    fidx = torch.nonzero(mask_flat).reshape(-1)
    valid = torch.ones(fidx.shape, dtype=torch.bool, device=fidx.device)
    return fidx, valid, torch.tensor(fidx.shape[0], device=fidx.device)


# sentinel `cnt` of _flat_compact_rows when a single row exceeds its rowcap,
# so the engine names the right knob (ang_row/tor_row/hb_row)
ROW_OVERFLOW = 2 ** 30


def _flat_compact_rows(mask, cap, rowcap):
    """Two-stage pack of a (R, S) mask into flat R*S indices — identical to
    `_flat_compact(mask.reshape(-1), cap)` while no row holds more than
    `rowcap` true entries; a row overflow returns cnt = ROW_OVERFLOW."""
    R, S = mask.shape
    dev = mask.device
    rowcap = int(min(rowcap, S))
    posr = torch.cumsum(mask, dim=1) - 1                       # (R, S)
    rowmax = torch.max(posr[:, -1]) + 1
    rows = torch.arange(R, device=dev)[:, None]
    src = rows * S + torch.arange(S, device=dev)[None, :]
    dst = torch.where(mask & (posr < rowcap), rows * rowcap + posr,
                      R * rowcap)                              # dump slot
    stage = torch.full((R * rowcap + 1,), -1, dtype=torch.int64, device=dev)
    stage.scatter_(0, dst.reshape(-1), src.reshape(-1))
    stage = stage[:-1]
    m2 = stage >= 0
    pos2 = torch.cumsum(m2, dim=0) - 1
    dst2 = torch.where(m2 & (pos2 < cap), pos2, cap)
    idx = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    idx.scatter_(0, dst2, stage.clamp(min=0))
    cnt_true = mask.sum()
    cnt = torch.where(rowmax > rowcap, ROW_OVERFLOW, cnt_true)
    valid = torch.arange(cap, device=dev) < cnt
    return idx[:cap], valid, cnt


class AngleList(NamedTuple):
    """Flat valence-angle list: one entry per (center j, bond a, bond c)."""
    j: torch.Tensor       # (M,) center row
    a: torch.Tensor       # (M,) slot of bond j-i in nbrs.idxb
    c: torch.Tensor       # (M,) slot of bond j-k
    oi: torch.Tensor      # (M,) owner row of i
    ok: torch.Tensor      # (M,) owner row of k
    valid: torch.Tensor   # (M,)
    prm: torch.Tensor     # (M, 17) angle-type params
    cnt: torch.Tensor     # () true count (overflow check: cnt <= M)


class TorsionList(NamedTuple):
    """Flat torsion list: one entry per (center j, a, c, e) with e indexing
    owner(k)'s bonded list."""
    j: torch.Tensor
    a: torch.Tensor
    c: torch.Tensor
    ok: torch.Tensor      # (M,) owner row of k
    e: torch.Tensor       # (M,) slot of l in owner(k)'s bonded list
    valid: torch.Tensor
    prm: torch.Tensor     # (M, 9) torsion-type params
    cnt: torch.Tensor


def _term_candidates(types, img, nbrs, bo: BondOrder, ffd: FFDev, ks: int,
                     slack: float, margin: float):
    """Bonded-slot candidates for many-body enumeration: strong now
    (BO > slack*cutof2_esub) or within `margin` [A] of the sigma cutoff."""
    maskb = nbrs.maskb
    idx = torch.where(maskb, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    bo0 = bo.bo[..., 0].detach()
    strong = bo.mask & (bo0 > units.CUTOF2_ESUB * slack)
    if margin > 0.0:
        dr2 = torch.sum(bo.drb * bo.drb, dim=-1).detach()
        rcm2 = (torch.sqrt(ffd.rc2b[types[:, None], types[oj]]) + margin) ** 2
        cand = maskb & (strong | (dr2 <= rcm2))
        bo_eff = torch.where(cand, torch.clamp(bo0, min=0.11), 0.0)
    else:
        cand = strong
        bo_eff = torch.where(cand, bo0, 0.0)
    sslot, svalid, cnt = _row_topk_slots(cand, min(ks, maskb.shape[1]))
    return sslot, svalid, cnt, bo_eff, oj, idx


def _angle_mask(types, img, nbrs, bo, amask, ffd, ks, slack, margin):
    """(n, ks, ks) build-time angle validity on the candidate sublist, n
    the center rows (`Neighbors.center_rows`)."""
    n = nbrs.center_rows
    row = torch.arange(n, device=types.device)[:, None]
    sslot, svalid, cnt, bo_eff, oj, idx = _term_candidates(
        types, img, nbrs, bo, ffd, ks, slack, margin)
    sslot, svalid, cnt = sslot[:n], svalid[:n], cnt[:n]
    bo_s = bo_eff[row, sslot]
    tn_s = types[oj][row, sslot]
    pm = (svalid[:, :, None] & svalid[:, None, :]
          & (sslot[:, :, None] < sslot[:, None, :])
          & (bo_s[:, :, None] * bo_s[:, None, :]
             > units.CUTOF2_ESUB * slack)
          & amask[:n, None, None])
    a3_s = ffd.inxn3[tn_s[:, :, None], types[:n, None, None],
                     tn_s[:, None, :]]
    return pm & (a3_s >= 0), sslot, cnt


def build_angle_list(types, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
                     cap: int = 4096, ks: int = 12, slack: float = 1.0,
                     margin: float = 0.0, rowcap: int = 0,
                     counts=None) -> AngleList:
    """Compact flat angle list (ref enumeration: pot.F90:369-399).
    `cap` is the TOTAL entry capacity; `rowcap` > 0 bounds the per-center
    count and selects the two-stage pack.  `cap=None` builds the exact
    list, every entry and no padding, and raises where a center has more
    than `ks` candidate bonds.  With `counts` (a dict) the most candidate
    bonds at one center go to counts["ks"], a device tensor, for the
    caller to hold against `ks` (a list of a capacity drops the excess,
    as rxmd_tpu's does)."""
    n = nbrs.center_rows
    pm, sslot, cand_cnt = _angle_mask(types, img, nbrs, bo, amask, ffd, ks,
                                      slack, margin)
    ks = sslot.shape[1]
    if counts is not None and cand_cnt.numel():
        _count(counts, "ks", cand_cnt.max())
    if cap is None:
        fidx, valid, cnt = _exact_compact(pm.reshape(-1), cand_cnt, ks)
    elif rowcap > 0:
        fidx, valid, cnt = _flat_compact_rows(pm.reshape(n, -1), cap, rowcap)
    else:
        fidx, valid, cnt = _flat_compact(pm.reshape(-1), cap)
    j = fidx // (ks * ks)
    s = fidx % (ks * ks)
    a = sslot[j, s // ks]
    c = sslot[j, s % ks]
    idx = torch.where(nbrs.maskb, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    tnbr = types[oj]
    a3 = ffd.inxn3[tnbr[j, a], types[j], tnbr[j, c]]
    a3 = torch.where(valid & (a3 >= 0), a3, 0)
    return AngleList(j=j, a=a, c=c, oi=oj[j, a], ok=oj[j, c], valid=valid,
                     prm=ffd.angprm[a3], cnt=cnt)


def e_3body(pos, H, types, img, nbrs, bo: BondOrder, lp: LonePair, amask,
            ffd: FFDev, al: AngleList = None, ks: int = 12, cap: int = None,
            counts=None):
    """Valence angle + penalty + 3-body conjugation (ref: pot.F90:355-549)
    over the cached flat angle list, re-gated with live bond orders, or
    over a list built here when `al` is None (`ks` candidate bonds per
    center): of capacity `cap`, its count in counts["ang"] (see
    build_angle_list), or exact when `cap` is None.  Geometry comes from
    the differentiable bond table bo.drb."""
    if al is None:
        al = build_angle_list(types, img, nbrs, bo, amask, ffd, cap=cap,
                              ks=ks, counts=counts)
        if counts is not None:
            _count(counts, "ang", al.cnt)
    j, a, c = al.j, al.a, al.c
    bo0 = bo.bo[..., 0]
    esub = units.CUTOF2_ESUB
    maskp = bo.mask
    n, kb = bo0.shape

    # center sums (ref: pot.F90:359-365)
    sum_bo8 = torch.sum(torch.where(maskp, -_powm(bo0, 8.0, maskp), 0.0),
                        dim=1)
    prod_sbo = torch.exp(sum_bo8)
    sum_sbo1 = torch.sum(torch.where(maskp, bo.bo[..., 2] + bo.bo[..., 3],
                                     0.0), dim=1)
    delta_ang_n = bo.delta + ffd.Val[types] - ffd.Valangle[types]

    bpack = torch.cat([bo.bo[..., 0:1], bo.drb], dim=-1).reshape(n * kb, 4)
    rowa = _take(bpack, j * kb + a)
    rowc = _take(bpack, j * kb + c)
    dpv = bo.delta + ffd.Val[types]
    cpack = torch.stack([
        ffd.pval3[types], ffd.pval5[types], delta_ang_n, sum_sbo1,
        prod_sbo, lp.nlp, bo.delta,
        dpv - ffd.Valval[types], dpv], dim=-1)          # (n, 9)
    rj = _take(cpack, j)
    dv = _take(dpv, al.oi)
    dk = _take(dpv, al.ok)

    boij_raw = rowa[:, 0]
    bojk_raw = rowc[:, 0]
    # live gates: exact reference semantics regardless of list staleness
    valid = (al.valid & (boij_raw > esub) & (bojk_raw > esub)
             & (boij_raw * bojk_raw > esub))
    boij = boij_raw - esub
    bojk = bojk_raw - esub

    (theta00_, pval1_, pval2_, pval4_, pval6_, pval7_, pval8_, pval9_,
     pval10_, ppen1_, ppen2_, ppen3_, ppen4_, pcoa1_, pcoa2_, pcoa3_,
     pcoa4_) = al.prm.unbind(-1)

    rij = -rowa[:, 1:4]
    rjk = rowc[:, 1:4]
    # theta via atan2(|rij x rjk|, -rij.rjk): stable at the linear limit,
    # where d(arccos)/dcos ~ 1/sqrt(1-c^2) fabricates f32 forces
    dotp = -torch.sum(rij * rjk, dim=-1)
    crs = torch.linalg.cross(rij, rjk, dim=-1)
    floor = 1e-20 if rij.dtype == torch.float64 else 1e-12
    sn = torch.sqrt(torch.clamp(
        _safe(torch.sum(crs * crs, dim=-1), valid), min=floor))
    theta = torch.atan2(sn, dotp)

    boij_s = _safe(boij, valid)
    bojk_s = _safe(bojk, valid)

    # --- PEval (ref: pot.F90:404-427)
    pv3j = rj[:, 0]
    fn7ij = 1.0 - torch.exp(-pv3j * _powm(boij_s, pval4_, valid))
    fn7jk = 1.0 - torch.exp(-pv3j * _powm(bojk_s, pval4_, valid))
    da = rj[:, 2]
    pv5j = rj[:, 1]
    fn8j = pv5j - (pv5j - 1.0) * _ratio23(pval6_ * da, -pval7_ * da)

    sbo = rj[:, 3] + (1.0 - rj[:, 4]) * (-da - pval8_ * rj[:, 5])
    sbo_s = torch.clamp(sbo, 0.0, 2.0)
    sbo2 = torch.where(
        sbo <= 0.0, 0.0,
        torch.where(sbo <= 1.0, _powm(sbo_s, pval9_, valid & (sbo > 0.0)),
                    torch.where(sbo <= 2.0,
                                2.0 - _powm(2.0 - sbo_s, pval9_,
                                            valid & (sbo < 2.0)), 2.0)))
    theta0 = np.pi - theta00_ * (1.0 - torch.exp(-pval10_ * (2.0 - sbo2)))
    tdiff = theta0 - theta
    exp2 = torch.exp(-pval2_ * tdiff * tdiff)
    peval = fn7ij * fn7jk * fn8j * (pval1_ - pval1_ * exp2)

    # --- PEpen (ref: pot.F90:460-466)
    dj = rj[:, 6]
    fn9 = _ratio23(-ppen3_ * dj, ppen4_ * dj)
    pepen = (ppen1_ * fn9
             * torch.exp(-ppen2_ * (boij - 2.0) ** 2)
             * torch.exp(-ppen2_ * (bojk - 2.0) ** 2))

    # --- PEcoa (ref: pot.F90:479-489)
    delta_val = rj[:, 7]
    pecoa = (pcoa1_ * _logistic(pcoa2_ * delta_val)
             * torch.exp(-pcoa3_ * (-boij + dv) ** 2)
             * torch.exp(-pcoa3_ * (-bojk + dk) ** 2)
             * torch.exp(-pcoa4_ * (boij - 1.5) ** 2)
             * torch.exp(-pcoa4_ * (bojk - 1.5) ** 2))

    return (torch.sum(torch.where(valid, peval, 0.0)),
            torch.sum(torch.where(valid, pepen, 0.0)),
            torch.sum(torch.where(valid, pecoa, 0.0)))


def _cross_floor(dtype):
    """The floor of a squared cross-product norm under its sqrt."""
    return 1e-20 if dtype == torch.float64 else 1e-12


def _unit_cross(u, v, mask):
    """Cross product of normalized inputs with norm floored at NSMALL
    (ref: pot.F90:1524-1543), the floor inside the sqrt."""
    c = torch.linalg.cross(u, v, dim=-1)
    nrm = torch.sqrt(torch.clamp(_safe(torch.sum(c * c, dim=-1), mask),
                                 min=_cross_floor(c.dtype)))
    return c, torch.clamp(nrm, min=units.NSMALL)


def _torsion_mask_rows(rows, cand, types, gid, img, bo: BondOrder, amask,
                       ffd: FFDev, slack: float):
    """(B, a, c, e) torsion validity for the given center rows over the
    global candidate tables `cand` (from _term_candidates)."""
    sslot, svalid, _, bo_eff, oj, idx = cand
    ks = sslot.shape[1]
    dev = types.device
    esub = units.CUTOF2_ESUB * slack
    r = rows[:, None]
    sslot_r = sslot[rows]                              # (B, ks)
    svalid_r = svalid[rows]
    bo_s = bo_eff[r, sslot_r]
    idx_s = idx[r, sslot_r]                            # ext index per slot
    oj_s = oj[r, sslot_r]                              # owner rows (global)
    key_ext = _ext_key(img)

    # l-side: candidate slots of owner(k), translated by k's shift
    sslot_l = sslot[oj_s]                              # (B, c, e)
    svalid_l = svalid[oj_s]
    bo_kl = bo_eff[oj_s[:, :, None], sslot_l]
    idx_le = idx[oj_s[:, :, None], sslot_l]            # ext index of l
    shift_k = img.shift[idx_s]                         # (B, c, 3)
    key_l = (img.owner_of(idx_le) * 729
             + _shift_code(img.shift[idx_le] + shift_k[:, :, None, :]))

    def A(x):
        return x[:, :, None, None]

    def E(x):
        return x[:, None, :, :]

    mask_jk = svalid_r & (gid[rows][:, None] < gid[oj_s]) & amask[rows][:, None]
    ar = torch.arange(ks, device=dev)
    same_ik = (ar[:, None] == ar[None, :])[None, :, :, None]
    key_j = (rows * 729 + _shift_code(torch.zeros(3, device=dev)))[:, None,
                                                                     None]
    mask4 = (A(svalid_r) & mask_jk[:, None, :, None] & E(svalid_l)
             & (bo_s[:, :, None, None] * bo_s[:, None, :, None] > esub)
             & (bo_s[:, None, :, None] * E(bo_kl) > esub)
             & ~same_ik
             & (bo_s[:, :, None, None] * bo_s[:, None, :, None] ** 2
                * E(bo_kl) > units.MINBO0 * slack)
             & (A(key_ext[idx_s]) != E(key_l))          # i != l
             & (key_j[:, None] != E(key_l)))            # j != l
    # torsion-type existence t4ok[type i, type j, type k, type l] on the
    # (a, c, e) grid; i and k both come from j's candidate slots
    tn_s = types[oj_s]                                  # (B, ks)
    tle = types[img.owner_of(idx_le)]                   # (B, c, e)
    exists4 = ffd.t4ok[tn_s[:, :, None, None],
                       types[rows][:, None, None, None],
                       tn_s[:, None, :, None],
                       tle[:, None, :, :]] > 0.5
    return mask4 & exists4


def _torsion_mask(types, gid, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
                  ks: int = 12, slack: float = 1.0, margin: float = 0.0):
    """Compact (n, a, c, e) torsion validity mask over candidate sublists,
    n the center rows (all reference enumeration gates, ref:
    pot.F90:1019-1081)."""
    n = nbrs.center_rows
    cand = _term_candidates(types, img, nbrs, bo, ffd, ks, slack, margin)
    mask4 = _torsion_mask_rows(torch.arange(n, device=types.device), cand,
                               types, gid, img, bo, amask, ffd, slack)
    return mask4, cand[0], cand[2]


def build_torsion_list(types, gid, img, nbrs, bo: BondOrder, amask,
                       ffd: FFDev, cap: int = 8192, ks: int = 12,
                       slack: float = 1.0, margin: float = 0.0,
                       rowcap: int = 0, counts=None) -> TorsionList:
    """Compact flat torsion list (ref enumeration: pot.F90:1019-1081).

    Center j, bond c -> k (counted once via gid(j) < gid(k)), slot a -> i in
    j's list, slot e -> l in owner(k)'s list.  `cap` is the TOTAL entry
    capacity; `rowcap` (> 0, required) bounds the per-center count.
    `cap=None` builds the exact list; `counts` as in build_angle_list."""
    if cap is not None and rowcap <= 0:
        raise ValueError("build_torsion_list needs rowcap > 0 (the two-stage "
                         "pack); size it with md.probe_capacities")
    n = nbrs.center_rows
    mask4, sslot, cand_cnt = _torsion_mask(types, gid, img, nbrs, bo, amask,
                                           ffd, ks, slack, margin)
    ks = sslot.shape[1]
    if counts is not None and cand_cnt.numel():
        _count(counts, "ks", cand_cnt.max())
    if cap is None:
        fidx, valid, cnt = _exact_compact(mask4.reshape(-1), cand_cnt, ks)
    else:
        fidx, valid, cnt = _flat_compact_rows(mask4.reshape(n, -1), cap,
                                              rowcap)
    j = fidx // (ks * ks * ks)
    s = fidx % (ks * ks * ks)
    a = sslot[j, s // (ks * ks)]
    c = sslot[j, (s // ks) % ks]
    idx = torch.where(nbrs.maskb, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    ok = oj[j, c]
    e = sslot[ok, s % ks]
    idx_l = idx[ok, e]
    t4 = ffd.inxn4[types[oj[j, a]], types[j], types[ok],
                   types[img.owner_of(idx_l)]]
    t4 = torch.where(valid & (t4 >= 0), t4, 0)
    return TorsionList(j=j, a=a, c=c, ok=ok, e=e, valid=valid,
                       prm=ffd.torprm[t4], cnt=cnt)


def e_4body(pos, H, types, img, nbrs, bo: BondOrder, amask, gid,
            ffd: FFDev, tl: TorsionList = None, ks: int = 12,
            cap: int = None, rowcap: int = 0, counts=None):
    """Torsion + 4-body conjugation (ref: pot.F90:1012-1219) over the
    cached flat torsion list with live BO re-gating (`torsion_energy`), or,
    when `tl` is None, over every torsion of the bonded lists in one pass
    over the central bonds (ops/torsion.py: the CUDA kernel on a card; on
    the CPU its plain version, `torsion_energy` over the list of capacity
    `cap` (rows `rowcap`), or exact when `cap` is None), differentiable in
    the bond table through the gradients it returns
    (`torsion_op.TorsionEnergy`).  A center with more than `ks` candidate
    bonds raises, where rxmd_tpu drops them; with `counts` (a dict) their
    maximum goes to counts["ks"] instead, and the torsions' count to
    counts["tor"] as build_torsion_list reports it (ROW_OVERFLOW where a
    center holds more than `rowcap`): device tensors the caller holds
    against the caps."""
    if tl is not None:
        return torsion_energy(tl, bo.bo[..., 0], bo.bo[..., 2], bo.drb,
                              bo.delta, types, ffd)
    bo0 = bo.bo[..., 0]
    cand_cnt = (bo.mask & (bo0.detach() > units.CUTOF2_ESUB)).sum(dim=1)
    if counts is not None:
        if cand_cnt.numel():
            _count(counts, "ks", cand_cnt.max())
    else:
        _check_ks(cand_cnt, ks)
    tab = torsion_op.TorsionTables(
        types=types, gid=gid, amask=amask, maskb=bo.mask.contiguous(),
        img=img._replace(shift=img.shift.to(bo0.dtype)), nbrs=nbrs, ffd=ffd,
        ks=ks, cap=cap, rowcap=rowcap)
    etors, econj, cnt = torsion_op.TorsionEnergy.apply(
        bo0.contiguous(), bo.bo[..., 2].contiguous(), bo.drb.contiguous(),
        bo.delta.contiguous(), tab)
    if counts is not None:
        _count(counts, "tor", cnt)
    return etors, econj


def torsion_energy(tl: TorsionList, bo0, bopi, drb, delta, types,
                   ffd: FFDev):
    """(E_tors, E_conj) over the flat torsion list `tl`, re-gated with the
    live bond orders: BO0 `bo0` and pi BO `bopi` (N, kb), bond vectors
    `drb` (N, kb, 3) and `delta` (N,)."""
    j, a, c, ok, e = tl.j, tl.a, tl.c, tl.ok, tl.e
    esub = units.CUTOF2_ESUB
    n, kb = bo0.shape
    delta_ang_n = delta + ffd.Val[types] - ffd.Valangle[types]

    bpack = torch.cat([bo0[..., None], bopi[..., None], drb],
                      dim=-1).reshape(n * kb, 5)
    rowa = _take(bpack, j * kb + a)
    rowc = _take(bpack, j * kb + c)
    rowe = _take(bpack, ok * kb + e)
    boij_raw = rowa[:, 0]
    bojk_raw = rowc[:, 0]
    bokl_raw = rowe[:, 0]
    valid = (tl.valid
             & (boij_raw > esub) & (bojk_raw > esub) & (bokl_raw > esub)
             & (boij_raw * bojk_raw > esub)
             & (bojk_raw * bokl_raw > esub)
             & (boij_raw * bojk_raw * bojk_raw * bokl_raw > units.MINBO0))
    boij = boij_raw - esub
    bojk = bojk_raw - esub
    bokl = bokl_raw - esub
    bo_pi_jk = rowc[:, 1]
    (V1_, V2_, V3_, ptor1_, ptor2_, ptor3_, ptor4_, pcot1_,
     pcot2_) = tl.prm.unbind(-1)

    rij = -rowa[:, 2:5]                                # r_i - r_j
    rjk = rowc[:, 2:5]                                 # r_j - r_k
    rkl = rowe[:, 2:5]                                 # r_k - r_l

    cos_ijk, nij, njk = _angle_cos(rij, rjk, valid)
    cos_jkl, _, nkl = _angle_cos(rjk, rkl, valid)
    sin_ijk = torch.sqrt(torch.clamp(1.0 - cos_ijk * cos_ijk, min=0.0))
    sin_jkl = torch.sqrt(torch.clamp(1.0 - cos_jkl * cos_jkl, min=0.0))

    uij = rij / nij[..., None]
    ujk = rjk / njk[..., None]
    ukl = rkl / nkl[..., None]
    crs1, n1 = _unit_cross(uij, ujk, valid)
    crs2, n2 = _unit_cross(ujk, ukl, valid)
    cos_w = _clip_cos(torch.sum(crs1 * crs2, dim=-1) / (n1 * n2))
    omega = torch.arccos(cos_w)
    cos_2w = torch.cos(2.0 * omega)
    cos_3w = torch.cos(3.0 * omega)

    # --- torsion energy (ref: pot.F90:1086-1129)
    boij_s = _safe(boij, valid, 1.0)
    bojk_s = _safe(bojk, valid, 1.0)
    bokl_s = _safe(bokl, valid, 1.0)
    exp_tor2_ij = torch.exp(-ptor2_ * boij_s)
    exp_tor2_jk = torch.exp(-ptor2_ * bojk_s)
    exp_tor2_kl = torch.exp(-ptor2_ * bokl_s)
    dajk = _take(delta_ang_n, j) + _take(delta_ang_n, ok)
    fn10 = (1.0 - exp_tor2_ij) * (1.0 - exp_tor2_jk) * (1.0 - exp_tor2_kl)
    fn11 = _ratio23(-ptor3_ * dajk, ptor4_ * dajk)
    fn12 = torch.exp(-pcot2_ * ((boij_s - 1.5) ** 2
                                + (bojk_s - 1.5) ** 2
                                + (bokl_s - 1.5) ** 2))
    # uses the raw pi BO of the j-k bond (ref: pot.F90:1102 remark)
    btb2 = 2.0 - bo_pi_jk - fn11
    exp_tor1 = torch.exp(ptor1_ * btb2 * btb2)

    petors = 0.5 * fn10 * sin_ijk * sin_jkl * (
        V1_ * (1.0 + cos_w)
        + V2_ * exp_tor1 * (1.0 - cos_2w)
        + V3_ * (1.0 + cos_3w))
    peconj = (pcot1_ * fn12
              * (1.0 + (cos_w * cos_w - 1.0) * sin_ijk * sin_jkl))

    return (torch.sum(torch.where(valid, petors, 0.0)),
            torch.sum(torch.where(valid, peconj, 0.0)))


class HBondList(NamedTuple):
    """Flat hydrogen-bond list: one entry per (donor i, H-slot a, acceptor
    slot c), built with slackened gates and re-gated live."""
    i: torch.Tensor       # (M,) donor row
    a: torch.Tensor       # (M,) bonded slot of hydrogen j in nbrs.idxb[i]
    c: torch.Tensor       # (M,) nonbonded slot of acceptor k in nbrs.idxnb[i]
    prm: torch.Tensor     # (M, 4) r0, phb1, phb2, phb3
    valid: torch.Tensor   # (M,)
    cnt: torch.Tensor     # () true candidate count


def _hbond_tables(pos, H, types, img, nbrs, bo: BondOrder, amask,
                  ffd: FFDev, kh: int, slack: float):
    """Per-atom tables of the hbond build: compacted central-H slots,
    nonbonded indices, ext positions, acceptor types."""
    kh = min(kh, nbrs.idxb.shape[1])
    maskb = bo.mask
    idxb = torch.where(maskb, nbrs.idxb, 0)
    tj = types[img.owner_of(idxb)]
    bo0_sg = bo.bo[..., 0].detach()
    mask_ij = (maskb & (tj == ffd.h_type)
               & (bo0_sg > units.MINBO0 * slack) & amask[:, None])
    hslot, hvalid, _ = _row_topk_slots(mask_ij, kh)
    row = torch.arange(maskb.shape[0], device=types.device)[:, None]
    idx_h = idxb[row, hslot]
    th = tj[row, hslot]
    idxnb = torch.where(nbrs.masknb, nbrs.idxnb, 0)
    pose = ext_positions(pos, H, img).detach()
    tk = types[img.owner_of(idxnb)]                         # (n, knb)
    return hslot, hvalid, idx_h, th, idxnb, pose, tk


def _hbond_rows_m(rows, tab, pos, types, nbrs, ffd: FFDev, margin: float):
    """(B, kh, knb) hbond candidate mask for the given donor rows
    (ref enumeration: pot.F90:587-631)."""
    hslot, hvalid, idx_h, th, idxnb, pose, tk = tab
    idxnb_r = idxnb[rows]
    rik = pos.detach()[rows][:, None, :] - pose[idxnb_r]
    rik2 = torch.sum(rik * rik, dim=-1)
    rchb2_m = (float(np.sqrt(units.RCHB2)) + margin) ** 2
    ok_t = ffd.hbok[types[rows][:, None, None], th[rows][:, :, None],
                    tk[rows][:, None, :]] > 0.5
    return (hvalid[rows][:, :, None] & nbrs.masknb[rows][:, None, :] & ok_t
            & (idx_h[rows][:, :, None] != idxnb_r[:, None, :])
            & (rik2 < rchb2_m)[:, None, :])


def _hbond_mask(pos, H, types, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
                kh: int, slack: float = 1.0, margin: float = 0.0):
    """(n, kh, knb) hbond candidate validity over compacted H slots: donor
    i, central H j bonded to i, acceptor k from i's nonbonded list."""
    tab = _hbond_tables(pos, H, types, img, nbrs, bo, amask, ffd, kh, slack)
    n = nbrs.center_rows             # donors
    m = _hbond_rows_m(torch.arange(n, device=types.device), tab, pos, types,
                      nbrs, ffd, margin)
    return m, tab[0], tab[6]


def build_hbond_list(pos, H, types, img, nbrs, bo: BondOrder, amask,
                     ffd: FFDev, cap: int = 1024, kh: int = 4,
                     slack: float = 1.0, margin: float = 0.0,
                     rowcap: int = 0) -> HBondList:
    """Compact flat hbond list; `cap` is the TOTAL entry capacity and
    `rowcap` (> 0, required) the per-donor bound of the two-stage pack."""
    n = nbrs.center_rows
    dev = types.device
    if ffd.hbprm.shape[0] == 0:
        z = torch.zeros((cap,), dtype=torch.int64, device=dev)
        return HBondList(i=z, a=z, c=z,
                         prm=torch.zeros((cap, 4), dtype=pos.dtype,
                                         device=dev),
                         valid=torch.zeros((cap,), dtype=torch.bool,
                                           device=dev),
                         cnt=torch.zeros((), dtype=torch.int64, device=dev))
    if rowcap <= 0:
        raise ValueError("build_hbond_list needs rowcap > 0 (the two-stage "
                         "pack); size it with md.probe_capacities")
    knb = nbrs.idxnb.shape[1]
    m, hslot, tk = _hbond_mask(pos, H, types, img, nbrs, bo, amask, ffd, kh,
                               slack, margin)
    kh = hslot.shape[1]
    fidx, valid, cnt = _flat_compact_rows(m.reshape(n, -1), cap, rowcap)
    i = fidx // (kh * knb)
    s = fidx % (kh * knb)
    c = s % knb
    a = hslot[i, s // knb]
    th_c = types[img.owner_of(torch.where(valid, nbrs.idxb[i, a], 0))]
    hbty_c = ffd.inxn3hb[types[i], th_c, tk[i, c]]
    prm = ffd.hbprm[torch.where(valid & (hbty_c >= 0), hbty_c, 0)]
    return HBondList(i=i, a=a, c=c, prm=prm, valid=valid, cnt=cnt)


def e_hbond_list(pos, H, types, img, nbrs, bo: BondOrder, hl: HBondList,
                 ffd: FFDev):
    """Hydrogen-bond energy over a cached flat list with live re-gating
    (ref: pot.F90:587-665)."""
    if ffd.hbprm.shape[0] == 0:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    i, a, c = hl.i, hl.a, hl.c
    j_idx = torch.where(hl.valid, nbrs.idxb[i, a], 0)
    k_idx = torch.where(hl.valid, nbrs.idxnb[i, c], 0)
    kb = bo.bo.shape[1]
    bo_ij = _take(bo.bo[..., 0].reshape(-1), i * kb + a)
    # ghost positions via the constant shift table (cf. bond_order)
    shift = img.shift.to(pos.dtype)
    pj = _take(pos, img.owner_of(j_idx)) + shift[j_idx] @ H.T
    pk = _take(pos, img.owner_of(k_idx)) + shift[k_idx] @ H.T
    pi = _take(pos, i)
    rik = pi - pk
    rik2_sg = torch.sum(rik * rik, dim=-1).detach()
    valid = (hl.valid & (bo_ij.detach() > units.MINBO0)
             & (rik2_sg < units.RCHB2))
    r0, phb1_, phb2_, phb3_ = hl.prm.unbind(-1)
    rij = pi - pj
    rjk = pj - pk
    cos_ijk, _, njk = _angle_cos(rij, rjk, valid)
    sin_xhz4 = ((1.0 - cos_ijk) * 0.5) ** 2        # sin^4(theta/2)
    exp_hb2 = torch.exp(-phb2_ * bo_ij)
    r0 = torch.where(valid & (r0 > 0.0), r0, 1.0)
    exp_hb3 = torch.exp(-phb3_ * (r0 / njk + njk / r0 - 2.0))
    pehb = phb1_ * (1.0 - exp_hb2) * exp_hb3 * sin_xhz4
    return torch.sum(torch.where(valid, pehb, 0.0))


def e_hbond(pos, H, types, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
            cap: int = 64, kh: int = 6, ctx: NbCtx = None, counts=None):
    """Hydrogen-bond energy without a cached list (ref: pot.F90:587-665):
    donor i, central hydrogen j bonded to i (up to `kh` per donor),
    acceptor k from i's nonbonded list within rchb.  With `ctx` the
    (donor, H slot, acceptor slot) grid is evaluated directly, acceptor
    types and distances from the pair context; without it the valid
    entries are compacted per donor into `cap` slots.  A donor with more
    hydrogens than `kh` or entries than `cap` raises, where rxmd_tpu
    drops them; with `counts` (a dict) their maxima go to counts["kh"]
    and counts["hb"] instead, device tensors the caller holds against
    the caps.  Donors: `nbrs.center_rows`."""
    if ffd.hbprm.shape[0] == 0:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    n, knb = nbrs.center_rows, nbrs.idxnb.shape[1]
    kb = nbrs.idxb.shape[1]
    dev = pos.device
    maskb = bo.mask[:n]
    idxb = torch.where(maskb, nbrs.idxb[:n], 0)
    bo0 = bo.bo[:n, :, 0]
    tr = types[:n]
    pr = pos[:n]
    masknb = nbrs.masknb
    idxnb = torch.where(masknb, nbrs.idxnb, 0)
    shift = img.shift.to(pos.dtype)

    def ghost(idx):
        """Differentiable positions of ext entries, via their owner rows
        and the constant shift table (cf. e_hbond_list)."""
        return _take(pos, img.owner_of(idx)) + shift[idx] @ H.T

    tj = types[img.owner_of(idxb)]                        # (n, kb)
    bo0_sg = bo0.detach()
    mask_ij = (maskb & (tj == ffd.h_type) & (bo0_sg > units.MINBO0)
               & amask[:n, None])
    kh = min(kh, kb)
    hslot, hvalid, hcnt = _row_topk_slots(mask_ij, kh)
    if counts is not None:
        _count(counts, "kh", hcnt.max())
    elif int(hcnt.max()) > kh:
        raise RuntimeError(f"hbond overflow: {int(hcnt.max())} hydrogens on "
                           f"one donor > kh={kh} (raise caps['kh'])")
    row = torch.arange(n, device=dev)[:, None]
    idx_h = idxb[row, hslot]                              # (n, kh)
    th = tj[row, hslot]

    if ctx is not None:
        # grid mode: every (H slot, acceptor slot) lane of each donor
        tk = ctx.tj[:, None, :]
        ti = tr[:, None, None]
        okt = ffd.hbok[ti, th[:, :, None], tk] > 0.5
        valid = (hvalid[:, :, None] & masknb[:, None, :] & okt
                 & (idx_h[:, :, None] != idxnb[:, None, :])    # j != k
                 & (ctx.dr2 < units.RCHB2)[:, None, :])
        hbt = ffd.inxn3hb[ti, th[:, :, None], tk]
        prm = ffd.hbprm[torch.where(hbt >= 0, hbt, 0)]     # (n, kh, knb, 4)
        r0 = torch.where(valid & (prm[..., 0] > 0.0), prm[..., 0], 1.0)
        phb1_, phb2_, phb3_ = prm[..., 1], prm[..., 2], prm[..., 3]
        pose_j = ghost(idx_h)                              # (n, kh, 3)
        pose_k = ghost(idxnb)                              # (n, knb, 3)
        rij = pr[:, None, :] - pose_j
        rjk = pose_j[:, :, None, :] - pose_k[:, None, :, :]
        cos_ijk, _, njk = _angle_cos(rij[:, :, None, :], rjk, valid)
        bo_ij = bo0[row, hslot][:, :, None]                # (n, kh, 1)
    else:
        # compacted mode: per-donor padded pair list
        tk_full = types[img.owner_of(idxnb)]               # (n, knb)
        okt = ffd.inxn3hb[tr[:, None, None], th[:, :, None],
                          tk_full[:, None, :]] >= 0
        pose_sg = ext_positions(pos.detach(), H.detach(), img)
        rik = pr.detach()[:, None, :] - pose_sg[idxnb]
        rik2 = torch.sum(rik * rik, dim=-1)
        mask = (hvalid[:, :, None] & masknb[:, None, :] & okt
                & (idx_h[:, :, None] != idxnb[:, None, :])     # j != k
                & (rik2 < units.RCHB2)[:, None, :])
        s, valid, cnt = _row_topk_slots(mask.reshape(n, kh * knb), cap)
        if counts is not None:
            _count(counts, "hb", cnt.max())
        elif int(cnt.max()) > s.shape[1]:
            raise RuntimeError(f"hbond overflow: {int(cnt.max())} entries at "
                               f"one donor > cap={cap} (raise caps['hb'])")
        b_slot = hslot[row, s // knb]
        idx_j = idxb[row, b_slot]
        idx_k = idxnb[row, s % knb]
        hbt = ffd.inxn3hb[tr[:, None], tj[row, b_slot],
                          types[img.owner_of(idx_k)]]
        hp = ffd.hbprm[torch.where(valid & (hbt >= 0), hbt, 0)]
        r0 = torch.where(valid & (hp[..., 0] > 0.0), hp[..., 0], 1.0)
        phb1_, phb2_, phb3_ = hp[..., 1], hp[..., 2], hp[..., 3]
        pose_j = ghost(idx_j)                              # (n, cap, 3)
        rij = pr[:, None, :] - pose_j
        rjk = pose_j - ghost(idx_k)
        cos_ijk, _, njk = _angle_cos(rij, rjk, valid)
        bo_ij = bo0[row, b_slot]
    sin_xhz4 = ((1.0 - cos_ijk) * 0.5) ** 2                # sin^4(theta/2)
    exp_hb2 = torch.exp(-phb2_ * bo_ij)
    exp_hb3 = torch.exp(-phb3_ * (r0 / njk + njk / r0 - 2.0))
    pehb = phb1_ * (1.0 - exp_hb2) * exp_hb3 * sin_xhz4
    return torch.sum(torch.where(valid, pehb, 0.0))


def hbond_tables(pos, types, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
                 kh: int = 6):
    """The hydrogen bonds' inputs that carry no gradient
    (`hbond_op.HBondTables`) and each donor's count of hydrogens: bonded
    slots of type h_type with BO0 > MINBO0 on a live donor.  Donors:
    `nbrs.center_rows`."""
    n = nbrs.center_rows
    maskb = bo.mask[:n]
    idxb = nbrs.idxb[:n]
    tj = types[img.owner_of(torch.where(maskb, idxb, 0))]
    hmask = (maskb & (tj == ffd.h_type)
             & (bo.bo[:n, :, 0].detach() > units.MINBO0) & amask[:n, None])
    tab = hbond_op.HBondTables(
        shift=img.shift.to(pos.dtype), types=types, idxb=idxb.contiguous(),
        hmask=hmask.contiguous(), idxnb=nbrs.idxnb.contiguous(),
        inxn3hb=ffd.inxn3hb, hbprm=ffd.hbprm, h_type=int(ffd.h_type),
        nown=img.n_own, kh=min(kh, idxb.shape[1]),
        cos_bound=_cos_bound(pos.dtype))
    return tab, hmask.sum(dim=1)


def e_hbond_rows(pos, H, types, img, nbrs, bo: BondOrder, amask,
                 ffd: FFDev, kh: int = 6, counts=None):
    """Hydrogen-bond energy without a cached list (ref: pot.F90:587-665),
    e_hbond's grid semantics in one pass over the donors' nonbonded rows
    (ops/hbond.py: the CUDA kernel on a card, its plain version on the
    CPU), differentiable in pos, H and the bond orders through the
    gradients it returns (`hbond_op.HBondEnergy`).  A donor with more
    hydrogens than `kh` raises, where rxmd_tpu drops them; with `counts` (a
    dict) their maximum goes to counts["kh"] instead, a device tensor the
    caller holds against the cap.  Donors: `nbrs.center_rows`."""
    if ffd.hbprm.shape[0] == 0:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    tab, hcnt = hbond_tables(pos, types, img, nbrs, bo, amask, ffd, kh)
    if counts is not None:
        _count(counts, "kh", hcnt.max())
    elif int(hcnt.max()) > tab.kh:
        raise RuntimeError(f"hbond overflow: {int(hcnt.max())} hydrogens on "
                           f"one donor > kh={tab.kh} (raise caps['kh'])")
    bo0 = bo.bo[:nbrs.center_rows, :, 0]
    return hbond_op.HBondEnergy.apply(pos.contiguous(), H.contiguous(),
                                      bo0.contiguous(), tab)


def _table_lerp(tbl, b, dr2, udr, udri, mask):
    """r^2-indexed linear interpolation of one table (ref:
    pot.F90:729-743), differentiable in dr2."""
    x = _safe(dr2, mask, 0.5 * udr) * udri
    itb = torch.clamp(torch.floor(x.detach()).to(torch.int64), 0,
                      tbl.shape[1] - 2)
    w = x - itb.to(x.dtype)
    return (1.0 - w) * tbl[b, itb] + w * tbl[b, itb + 1]


def e_nonbond(pos, q, H, types, img, nbrs, gid, amask, ffd: FFDev):
    """van der Waals + Coulomb from the tables, each unordered pair once,
    + charge self-energy (ref: pot.F90:702-773): the energy whose autograd
    gives the nonbond forces when `energy_and_forces` runs with
    fast_nonbond=False.  Pair geometry on owner rows (cf. bond_order)."""
    masknb = nbrs.masknb
    idx = torch.where(masknb, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    # each unordered (image) pair counted once (ref: pot.F90:715 jid<iid)
    mask = masknb & (gid[oj] < gid[:, None]) & amask[:, None]
    shg = img.shift.to(pos.dtype)[idx]
    dr = (pos[:, None, :] - _take(pos, oj)
          - torch.einsum("nka,ba->nkb", shg, H))
    dr2 = torch.sum(dr * dr, dim=-1)
    mask = mask & (dr2 <= ffd.rctap2)
    b = ffd.inxn2[types[:, None], types[oj]]
    bc = torch.where(b >= 0, b, 0)
    pevdw = _table_lerp(ffd.tbl_evdw, bc, dr2, ffd.udr, ffd.udri, mask)
    peclmb = _table_lerp(ffd.tbl_eclmb, bc, dr2, ffd.udr, ffd.udri, mask)
    peclmb = peclmb * q[:, None] * q[oj]
    evdw = torch.sum(torch.where(mask, pevdw, 0.0))
    eclmb = torch.sum(torch.where(mask, peclmb, 0.0))
    return evdw, eclmb, charge_energy(q, types, amask, ffd)


def e_nonbond_pqeq(pos, spos, q, H, types, img, nbrs, gid, amask,
                   ffd: FFDev, pq):
    """van der Waals from the tables + the 4-term core/shell Coulomb +
    charge self-energy and shell spring (ref: ENbond_PQEq pot.F90:784-923),
    each unordered pair once, differentiable in `pos`.  Pair geometry on
    owner rows; shells ride their owner's image.  Rows:
    `nbrs.center_rows`."""
    from .pqeq import pqeq_kernels
    masknb = nbrs.masknb
    n = nbrs.center_rows
    idx = torch.where(masknb, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    mask = masknb & (gid[oj] < gid[:n, None]) & amask[:n, None]
    shg = img.shift.to(pos.dtype)[idx]
    dr = (pos[:n, None, :] - _take(pos, oj)
          - torch.einsum("nka,ba->nkb", shg, H))
    spose_r = _take(spos, oj)
    dr2 = torch.sum(dr * dr, dim=-1)
    mask = mask & (dr2 <= ffd.rctap2)
    tr = types[:n]
    b = ffd.inxn2[tr[:, None], types[oj]]
    bc = torch.where(b >= 0, b, 0)
    pevdw = _table_lerp(ffd.tbl_evdw, bc, dr2, ffd.udr, ffd.udri, mask)
    evdw = torch.sum(torch.where(mask, pevdw, 0.0))

    ti = tr[:, None]
    tj = types[oj]
    zi = pq.Z[tr][:, None]
    zj = pq.Z[tj]
    qic = q[:n, None] + zi
    qjc = torch.where(mask, q[oj], 0.0) + zj
    polar_i = pq.is_polar[tr][:, None]
    polar_j = pq.is_polar[tj]
    C0 = units.CCLMB0
    ecc = C0 * pqeq_kernels(pq, pq.pcc, ti, tj, dr, mask) * qic * qjc
    drsc = dr + spos[:n, None, :]
    esc = torch.where(mask & polar_i,
                      -C0 * pqeq_kernels(pq, pq.psc, ti, tj, drsc, mask)
                      * zi * qjc, 0.0)
    drcs = dr - spose_r
    ecs = torch.where(mask & polar_j,
                      -C0 * pqeq_kernels(pq, pq.psc, tj, ti, drcs, mask)
                      * qic * zj, 0.0)
    drss = drsc - spose_r
    ess = torch.where(mask & polar_i & polar_j,
                      C0 * pqeq_kernels(pq, pq.pss, ti, tj, drss, mask)
                      * zi * zj, 0.0)
    eclmb = torch.sum(torch.where(mask, ecc + esc + ecs + ess, 0.0))

    # self-energy + shell spring (ref: pot.F90:819-825)
    eshell = torch.where(pq.is_polar[types],
                         0.5 * pq.Ks[types] * torch.sum(spos * spos, dim=-1),
                         0.0)
    echarge = torch.sum(torch.where(
        amask,
        units.CECHRGE * (ffd.chi[types] * q + 0.5 * ffd.eta[types] * q * q)
        + eshell, 0.0))
    return evdw, eclmb, echarge


# ----------------------------------------------------------------------------
# assembly
# ----------------------------------------------------------------------------

# the uncached terms' capacities: candidate bonds ("ks") and hydrogens
# ("kh") per center
DEFAULT_CAPS = {"ks": 12, "kh": 6}


def energy_components(pos, q, H, types, gid, img: ImageTable,
                      nbrs: Neighbors, ffd: FFDev, lists=None, amask=None,
                      caps=None, include_nonbond=True, pq=None,
                      spos=None, counts=None):
    """All potential-energy components as a (14,) vector in the
    reference's PE slot convention (ref: module.F90:143-146):
      0=total 1=Ebond 2=Elp 3=Eover 4=Eunder 5=Eval 6=Epen 7=Ecoa
      8=Etors 9=Econj 10=Ehb 11=Evdw 12=Eclmb 13=Echarge
    over the cached (angle, torsion, hbond) `lists`, or over per-call
    enumeration where `lists` is None (`caps` "ks", "kh"; the hydrogen
    bonds in one pass over the donors' rows, `e_hbond_rows`):
    exact lists, raising at once on an overflow of ks or kh; or, with
    `counts` (a dict), lists of the fixed capacities caps "ang", "tor"
    and "tor_row", as rxmd_tpu builds them, and every count and candidate
    maximum left in `counts` as a device tensor (no host read; the caller
    holds them against `caps`).
    Slots 11-13 hold the table nonbond `e_nonbond` (under PQEq, `pq` the
    parameters and `spos` the shells: `e_nonbond_pqeq`) with
    `include_nonbond`, else zero (the caller splices its own in)."""
    caps = {**DEFAULT_CAPS, **(caps or {})}
    if amask is None:
        amask = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    al, tl, hl = lists if lists is not None else (None, None, None)
    # a device mark at each term's ends (utils/timers.py): the forward's
    # time by term
    with trace.phase("E:bond order"):
        bo = bond_order(pos, H, types, img, nbrs, ffd)
        lp = lone_pair(types, bo.delta, ffd)
    with trace.phase("E:bond"):
        ebond = e_bond(types, img, nbrs, bo, gid, amask, ffd)
    with trace.phase("E:lone pair, over/under"):
        elp, eover, eunder = e_lnpr(types, img, nbrs, bo, lp, amask, ffd)
    capped = counts is not None
    with trace.phase("E:3-body"):
        eval_, epen, ecoa = e_3body(pos, H, types, img, nbrs, bo, lp, amask,
                                    ffd, al, ks=caps["ks"],
                                    cap=caps["ang"] if capped else None,
                                    counts=counts)
    with trace.phase("E:4-body"):
        etors, econj = e_4body(pos, H, types, img, nbrs, bo, amask, gid, ffd,
                               tl, ks=caps["ks"],
                               cap=caps["tor"] if capped else None,
                               rowcap=caps["tor_row"] if capped else 0,
                               counts=counts)
    with trace.phase("E:hbond"):
        if hl is not None:
            ehb = e_hbond_list(pos, H, types, img, nbrs, bo, hl, ffd)
        else:
            ehb = e_hbond_rows(pos, H, types, img, nbrs, bo, amask, ffd,
                               kh=caps["kh"], counts=counts)
    z = torch.zeros_like(ebond)
    evdw = eclmb = echarge = z
    with trace.phase("E:nonbond"):
        if include_nonbond and pq is not None:
            evdw, eclmb, echarge = e_nonbond_pqeq(pos, spos, q, H, types,
                                                  img, nbrs, gid, amask, ffd,
                                                  pq)
        elif include_nonbond:
            evdw, eclmb, echarge = e_nonbond(pos, q, H, types, img, nbrs,
                                             gid, amask, ffd)
    comps = torch.stack([z, ebond, elp, eover, eunder, eval_, epen, ecoa,
                         etors, econj, ehb, evdw, eclmb, echarge])
    return torch.cat([comps[1:].sum()[None], comps[1:]])


def energy_and_forces(pos, q, H, types, gid, img, nbrs, ffd, lists=None,
                      amask=None, with_virial=False, external_nonbond=None,
                      caps=None, fast_nonbond=True, closed_form=None,
                      pq=None, spos=None, counts=None):
    """(PE components, forces[, virial]).

    Bonded forces are -dE/dpos by autograd; the ghost-force reduction
    happens in the backward pass of the owner-row gathers.  With
    `with_virial` the (3, 3) potential virial W_ab = -dE/deps_ab comes from
    the strain gradient in the same backward pass (ref: the per-step
    Σ pos·f stress accumulation, pot.F90:65-72).

    The nonbond term: `external_nonbond` = (evdw, eclmb, echarge, f_nb,
    w_nb), computed by the caller (the pair sweep, the dense form or the
    pair context), is spliced in; else, with `fast_nonbond`, the closed-form
    (`closed_form`) or table kernels run over a pair context built here
    with the analytic derivative columns and row-local forces (ref:
    pot.F90:736-761); else the table energy `e_nonbond` joins the autograd
    pass, as the PQEq energy `e_nonbond_pqeq` always does (`pq`, `spos`;
    ref: rxmd_tpu takes no row-local nonbond under PQEq).  `closed_form`
    None means the tables, as in rxmd_tpu.  `counts`: see
    energy_components.
    """
    use_fast = fast_nonbond and external_nonbond is None and pq is None
    if amask is None:
        amask = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    if use_fast:
        ctx = nb_ctx(pos, q, H, types, img, nbrs, gid, amask, ffd)
    kw = dict(lists=lists, amask=amask, caps=caps, pq=pq,
              spos=spos, counts=counts,
              include_nonbond=not use_fast and external_nonbond is None)
    p = pos.detach().requires_grad_(True)
    # device marks around the forward and the backward (utils/timers.py)
    with torch.enable_grad():
        if with_virial:
            with trace.phase("forward"):
                eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                                  requires_grad=True)
                strain = torch.eye(3, dtype=pos.dtype,
                                   device=pos.device) + eps
                comps = energy_components(p @ strain.T, q, strain @ H, types,
                                          gid, img, nbrs, ffd, **kw)
            with trace.phase("backward"):
                gp, ge = torch.autograd.grad(comps[0], (p, eps))
            w = -ge
        else:
            with trace.phase("forward"):
                comps = energy_components(p, q, H, types, gid, img, nbrs,
                                          ffd, **kw)
            with trace.phase("backward"):
                (gp,) = torch.autograd.grad(comps[0], (p,))
    comps = comps.detach()
    f = -gp
    if use_fast:
        external_nonbond = nonbond_ctx_energy_forces(
            ctx, q, types, amask, ffd, closed_form, with_virial=with_virial,
            img=img)
    if external_nonbond is not None:
        evdw, eclmb, echarge, f_nb = external_nonbond[:4]
        w_nb = external_nonbond[4] if len(external_nonbond) > 4 else None
        comps = torch.cat([comps[:11], torch.stack([
            torch.as_tensor(x, dtype=comps.dtype, device=comps.device)
            for x in (evdw, eclmb, echarge)])])
        comps = torch.cat([comps[1:].sum()[None], comps[1:]])
        f = f + f_nb
        if with_virial and w_nb is not None:
            w = w + w_nb
    if with_virial:
        return comps, f, w
    return comps, f


def term_counts(pos, H, types, gid, img, nbrs, ffd, amask=None,
                slack: float = 1.0, margin: float = 0.0):
    """Host-side probe of the per-atom interaction-list occupancies that
    size the angle/torsion/hbond caps (ref: maxas stats, main.F90:128-146).
    `slack`/`margin` must match the engine's list-caching gates."""
    n = pos.shape[0]
    if amask is None:
        amask = torch.ones(n, dtype=torch.bool, device=pos.device)
    bo = bond_order(pos, H, types, img, nbrs, ffd)
    kb = bo.mask.shape[1]
    bo0 = bo.bo[..., 0]
    _, _, cand_cnt, _, _, _ = _term_candidates(types, img, nbrs, bo, ffd,
                                               kb, slack, margin)
    degmax = int(cand_cnt.max())
    ksp = min(degmax + 2, kb)
    pm, _, _ = _angle_mask(types, img, nbrs, bo, amask, ffd, ksp, slack,
                           margin)
    ang = int(pm.sum())
    ang_row = int(pm.sum(dim=(1, 2)).max())
    mask4, _, _ = _torsion_mask(types, gid, img, nbrs, bo, amask, ffd,
                                ks=ksp, slack=slack, margin=margin)
    tor = int(mask4.sum())
    tor_row = int(mask4.sum(dim=(1, 2, 3)).max())
    idx = torch.where(bo.mask, nbrs.idxb, 0)
    is_h = ((types[img.owner_of(idx)] == ffd.h_type) & bo.mask
            & (bo0 > units.MINBO0 * slack))
    h_slots = int(is_h.sum(dim=1).max())
    hb = hbf = 0
    if ffd.hbprm.shape[0] > 0 and h_slots > 0:
        kh = min(h_slots, kb)
        m, _, _ = _hbond_mask(pos, H, types, img, nbrs, bo, amask, ffd,
                              kh, slack, margin)
        hb = int(m.sum(dim=(1, 2)).max())
        hbf = int(m.sum())
    return {"ang": ang, "tor": tor, "hb": hb, "hbf": hbf, "degmax": degmax,
            "h_slots": h_slots, "ang_row": ang_row, "tor_row": tor_row}
