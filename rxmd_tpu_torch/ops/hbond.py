"""The hydrogen-bond term of ReaxFF (ref: pot.F90:587-665) as one CUDA
kernel (csrc/hbond.cu) beside its plain PyTorch version, and the autograd
Function that carries either into the bonded terms' backward pass.

Donor i (a row of the nonbonded list), hydrogen j in one of i's bonded
slots that `HBondTables.hmask` marks, acceptor k from i's nonbonded list
with inxn3hb[ti, tj, tk] >= 0, k != j (ext indices) and |r_i - r_k|^2 <
RCHB2 (summed as (x*x + y*y) + z*z with every step rounded, as the kernel
sums it).  Ghost positions are pos[e % nown] + shift[e] @ H^T, as
`neighbors.ext_positions` forms them.

`hbond` gives the energy and its gradients with respect to the positions
(N, 3), to BO0 of each donor's bonded slots (n, kb) and, with `want_dh`,
to the box H (3, 3): the kernel for CUDA tensors (or raises), `hbond_plain`
for CPU tensors.  The kernel takes every marked hydrogen; the plain version
takes the first `kh` of each donor (the caller raises, or counts, where a
donor has more).  `HBondEnergy` is the autograd Function over `hbond`: its
forward saves the three gradients, its backward scales them by the
energy's gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from .. import native, units

# launches of the kernel, counted by its wrapper where it launches it
launches = {"hbond": 0}

_SRC = native.source("hbond.cu")


class HBondTables(NamedTuple):
    """The inputs of the term that carry no gradient."""
    shift: torch.Tensor     # (M, 3) lattice shift of each ext entry
    types: torch.Tensor     # (N,) int64
    idxb: torch.Tensor      # (n, kb) int64 bonded ext indices
    hmask: torch.Tensor     # (n, kb) bool: the donor's hydrogen slots
    idxnb: torch.Tensor     # (n, knb) int64 nonbonded ext indices, -1 pad
    inxn3hb: torch.Tensor   # (nso, nso, nso) int64 hbond type, -1 for none
    hbprm: torch.Tensor     # (nhbty, 4): r0, phb1, phb2, phb3
    h_type: int             # the type of hydrogen
    nown: int               # the owner row of ext entry e is e % nown
    kh: int                 # hydrogens a donor holds (the plain version)
    cos_bound: float        # the angle's clamp (reax._cos_bound)


@functools.cache
def _library():
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    return native.load(_SRC, "rxmd_hbond_error_string", rxmd_hbond=(
        [ci] + [vp] * 10 + [ci] * 5 + [ctypes.c_longlong, cd, cd]
        + [vp] * 5))


def hbond(pos, H, bo0, tab: HBondTables, want_dh: bool = False):
    """(energy, dE/dpos (N, 3), dE/dBO0 (n, kb), dE/dH (3, 3) or None):
    the CUDA kernel for a CUDA tensor (or raises), `hbond_plain` for a CPU
    tensor."""
    if native.device_kind(pos, "hbond") == "cpu":
        return hbond_plain(pos, H, bo0, tab, want_dh)
    dev, dt = pos.device, pos.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"hbond: takes float32 or float64, got {dt}")
    N = pos.shape[0]
    n, kb = tab.hmask.shape
    knb = tab.idxnb.shape[1]
    nso = tab.inxn3hb.shape[0]
    for what, t, dtype, shape in (
            ("pos", pos, dt, (N, 3)), ("H", H, dt, (3, 3)),
            ("bo0", bo0, dt, (n, kb)),
            ("shift", tab.shift, dt, (tab.shift.shape[0], 3)),
            ("types", tab.types, torch.int64, (N,)),
            ("idxb", tab.idxb, torch.int64, (n, kb)),
            ("hmask", tab.hmask, torch.bool, (n, kb)),
            ("idxnb", tab.idxnb, torch.int64, (n, knb)),
            ("inxn3hb", tab.inxn3hb, torch.int64, (nso, nso, nso)),
            ("hbprm", tab.hbprm, dt, (tab.hbprm.shape[0], 4))):
        native.check(what, t, dtype, shape, dev)
    # every output in one zeroed buffer: energy by donor, dE/dpos,
    # dE/dBO0, dE/dH
    buf = torch.zeros(n + 3 * N + n * kb + 9, dtype=dt, device=dev)
    e_part = buf[:n]
    gpos = buf[n:n + 3 * N].view(N, 3)
    gbo = buf[n + 3 * N:n + 3 * N + n * kb].view(n, kb)
    gH = buf[n + 3 * N + n * kb:].view(3, 3)
    _library().rxmd_hbond(
        int(dt == torch.float64), pos.data_ptr(), H.data_ptr(),
        tab.shift.data_ptr(), tab.types.data_ptr(), tab.idxb.data_ptr(),
        tab.hmask.data_ptr(), bo0.data_ptr(), tab.idxnb.data_ptr(),
        tab.inxn3hb.data_ptr(), tab.hbprm.data_ptr(), n, kb, knb, nso,
        tab.h_type, tab.nown, units.RCHB2, tab.cos_bound, e_part.data_ptr(),
        gpos.data_ptr(), gbo.data_ptr(), gH.data_ptr() if want_dh else None,
        native.stream(dev))
    launches["hbond"] += 1
    return e_part.sum(), gpos, gbo, gH if want_dh else None


def hbond_plain(pos, H, bo0, tab: HBondTables, want_dh: bool = False):
    """`hbond` in PyTorch, the kernel's arithmetic over (donor, hydrogen,
    acceptor slot) lanes: each donor's first `tab.kh` hydrogen slots
    (lowest slot first), one (n, knb) pass per hydrogen, the analytic
    derivatives written out."""
    n, kb = tab.hmask.shape
    kh = min(tab.kh, kb)
    N = pos.shape[0]
    rows = torch.arange(n, device=pos.device)
    hslot = torch.argsort(tab.hmask.to(torch.int8), dim=1, descending=True,
                          stable=True)[:, :kh]
    hvalid = torch.gather(tab.hmask, 1, hslot)
    shift = tab.shift

    def ghost(e):
        return pos[e % tab.nown] + shift[e] @ H.T

    pi = pos[:n]
    kk = tab.idxnb.clamp(min=0)
    ko = kk % tab.nown
    pk = ghost(kk)                                        # (n, knb, 3)
    d = pi[:, None, :] - pk
    rik2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2])
    hbt = tab.inxn3hb[tab.types[:n, None], tab.h_type, tab.types[ko]]
    live = (tab.idxnb >= 0) & (hbt >= 0) & (rik2 < units.RCHB2)
    prm = tab.hbprm[hbt.clamp(min=0)]                     # (n, knb, 4)
    r0 = torch.where(live & (prm[..., 0] > 0.0), prm[..., 0], 1.0)
    p1, p2, p3 = prm[..., 1], prm[..., 2], prm[..., 3]
    b = tab.cos_bound
    e = pos.new_zeros(())
    gi = pos.new_zeros((n, 3))
    gk = pos.new_zeros(pk.shape)
    gpos = pos.new_zeros((N, 3))
    gbo = pos.new_zeros((n, kb))
    gH = pos.new_zeros((3, 3))
    for h in range(kh):
        s = hslot[:, h]
        j = torch.where(hvalid[:, h], tab.idxb[rows, s], 0)
        ok = live & hvalid[:, h, None] & (tab.idxnb != j[:, None])
        pj = ghost(j)
        rij = (pi - pj)[:, None, :]                       # (n, 1, 3)
        rjk = pj[:, None, :] - pk
        nij = torch.sqrt(torch.where(hvalid[:, h], (rij * rij).sum(-1)[:, 0],
                                     1.0))[:, None]
        njk2 = torch.where(ok, (rjk * rjk).sum(-1), 1.0)
        njk = torch.sqrt(njk2)
        cs = -(rij * rjk).sum(-1) / (nij * njk)
        half = (1.0 - cs.clamp(-b, b)) * 0.5              # sin^2(theta/2)
        s4 = half * half
        e2 = torch.exp(-p2 * bo0[rows, s][:, None])
        e3 = torch.exp(-p3 * (r0 / njk + njk / r0 - 2.0))
        amp = p1 * (1.0 - e2) * e3
        eh = torch.where(ok, amp * s4, 0.0)
        e = e + eh.sum()
        gbo[rows, s] += torch.where(ok, p1 * p2 * e2 * e3 * s4, 0.0).sum(1)
        # dE/dcos (0 where the clamp holds cos) and dE/d|r_jk| / |r_jk|
        dc = torch.where(ok & (cs >= -b) & (cs <= b), -amp * half, 0.0)
        dn = eh * -p3 * (1.0 / r0 - r0 / njk2) / njk
        inv = (1.0 / (nij * njk))[..., None]
        du = dc[..., None] * (-rjk * inv - (cs / (nij * nij))[..., None] * rij)
        dv = (dc[..., None] * (-rij * inv - (cs / njk2)[..., None] * rjk)
              + dn[..., None] * rjk)
        gi += du.sum(1)
        gj = (dv - du).sum(1)
        gk -= dv
        gpos.index_add_(0, j % tab.nown, gj)
        if want_dh:
            gH += gj.T @ shift[j]
    gpos[:n] += gi
    gpos.index_add_(0, ko.reshape(-1), gk.reshape(-1, 3))
    if want_dh:
        gH += gk.reshape(-1, 3).T @ shift[kk].reshape(-1, 3)
    return e, gpos, gbo, gH if want_dh else None


class HBondEnergy(torch.autograd.Function):
    """E_hb(pos, H, BO0) through `hbond`: the forward keeps the gradients
    it returns (dE/dH only where H needs one), the backward scales them by
    the energy's gradient.  `tab` carries no gradient."""

    @staticmethod
    def forward(ctx, pos, H, bo0, tab: HBondTables):
        e, gpos, gbo, gH = hbond(pos, H, bo0, tab,
                                 want_dh=ctx.needs_input_grad[1])
        ctx.save_for_backward(gpos, gbo, gH)
        return e

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gpos, gbo, gH = ctx.saved_tensors
        return g * gpos, None if gH is None else g * gH, g * gbo, None
