"""The torsion and 4-body conjugation terms of ReaxFF (ref:
pot.F90:1012-1219) as one CUDA kernel (csrc/torsion.cu) beside its plain
PyTorch version, and the autograd Function that carries either into the
bonded terms' backward pass.

The torsions (reax.build_torsion_list's enumeration, every one of them):
center j (a row below `nbrs.center_rows` with amask[j]), central bond
j -> k in a candidate slot c of j (BO0 > CUTOF2_ESUB on a live slot) with
gid(j) < gid(owner(k)), leg j -> i in another candidate slot a of j, leg
k -> l in a candidate slot e of owner(k), l's image translated by k's
shift, with ext key(i) != key(l) and key(j) != key(l) (owner * 729 + the
shift's code, `reax._ext_key`), BO0 products above CUTOF2_ESUB (a-c, c-l)
and above MINBO0 (a * c^2 * l, both in the list build's and the
evaluation's order of products), and a torsion type inxn4[ti, tj, tk, tl]
>= 0.  The arithmetic is `reax.torsion_energy`'s.

`torsion` gives (E_tors, E_conj), the gradients of each with respect to
BO0 (N, kb), the pi bond order (N, kb), the bond vectors drb (N, kb, 3)
and delta (N,), one row of a (2, 5 N kb + N) tensor each (`split` views
one row as the four), and the torsions' count as the list build reports
it (its total, or reax.ROW_OVERFLOW where a center holds more than
`rowcap`): the kernel for CUDA tensors (or raises), `torsion_plain` for
CPU tensors.  The kernel takes every torsion; the plain version builds
reax.build_torsion_list's list of capacity `cap` (exact where None) over
`ks` candidate bonds a center (the caller raises, or counts, where a
center has more).  `TorsionEnergy` is the autograd Function over
`torsion`: its forward saves both rows of gradients, its backward sums
them, each scaled by its energy's gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from .. import native, units
from ..neighbors import ImageTable, Neighbors

# launches of the kernel, counted by its wrapper where it launches it
launches = {"torsion": 0}

_SRC = native.source("torsion.cu")


class TorsionTables(NamedTuple):
    """The inputs of the term that carry no gradient."""
    types: torch.Tensor     # (N,) int64
    gid: torch.Tensor       # (N,) int64 global atom ids
    amask: torch.Tensor     # (N,) bool: the live centers
    maskb: torch.Tensor     # (N, kb) bool: live bonded slots (BondOrder.mask)
    img: ImageTable         # owner and lattice shift of each ext entry
    nbrs: Neighbors         # idxb (N, kb) bonded ext indices; center_rows
    ffd: object             # reax.FFDev: Val, Valangle, inxn4, torprm, t4ok
    ks: int                 # candidate bonds a center (the plain version)
    cap: Optional[int]      # the plain version's list capacity, None: exact
    rowcap: int             # torsions a center before the count reports
                            # reax.ROW_OVERFLOW (with `cap`)


@functools.cache
def _library():
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    return native.load(_SRC, "rxmd_torsion_error_string", rxmd_torsion=(
        [ci] + [vp] * 14 + [ci] * 4 + [ctypes.c_longlong] + [cd] * 5
        + [vp] * 4))


def split(g, N: int, kb: int):
    """One row of `torsion`'s gradients as (dE/dBO0 (N, kb), dE/dpi (N,
    kb), dE/ddrb (N, kb, 3), dE/ddelta (N,)), views of it."""
    nk = N * kb
    return (g[:nk].view(N, kb), g[nk:2 * nk].view(N, kb),
            g[2 * nk:5 * nk].view(N, kb, 3), g[5 * nk:])


def torsion(bo0, bopi, drb, delta, tab: TorsionTables):
    """(E_tors, E_conj, their gradients (2, 5 N kb + N), count): the CUDA
    kernel for a CUDA tensor (or raises), `torsion_plain` for a CPU
    tensor.  The count is a device tensor."""
    if native.device_kind(bo0, "torsion") == "cpu":
        return torsion_plain(bo0, bopi, drb, delta, tab)
    from .. import reax                       # reax imports this module
    dev, dt = bo0.device, bo0.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"torsion: takes float32 or float64, got {dt}")
    N, kb = tab.maskb.shape
    n = tab.nbrs.center_rows
    M = tab.img.shift.shape[0]
    ffd = tab.ffd
    nso = ffd.inxn4.shape[0]
    for what, t, dtype, shape in (
            ("bo0", bo0, dt, (N, kb)), ("bopi", bopi, dt, (N, kb)),
            ("drb", drb, dt, (N, kb, 3)), ("delta", delta, dt, (N,)),
            ("types", tab.types, torch.int64, (N,)),
            ("gid", tab.gid, torch.int64, (N,)),
            ("amask", tab.amask, torch.bool, (N,)),
            ("maskb", tab.maskb, torch.bool, (N, kb)),
            ("idxb", tab.nbrs.idxb, torch.int64, (N, kb)),
            ("shift", tab.img.shift, dt, (M, 3)),
            ("Val", ffd.Val, dt, (nso,)),
            ("Valangle", ffd.Valangle, dt, (nso,)),
            ("inxn4", ffd.inxn4, torch.int64, (nso,) * 4),
            ("torprm", ffd.torprm, dt, (ffd.torprm.shape[0], 9))):
        native.check(what, t, dtype, shape, dev)
    if n > N:
        raise ValueError(f"torsion: {n} center rows > {N} rows")
    # every output in one zeroed buffer: each energy's part by center, then
    # each energy's gradients; and the torsions of each center
    buf = torch.zeros(2 * (n + 5 * N * kb + N), dtype=dt, device=dev)
    e_part, grad = buf[:2 * n].view(2, n), buf[2 * n:].view(2, -1)
    rows = torch.zeros(n, dtype=torch.int32, device=dev)
    _library().rxmd_torsion(
        int(dt == torch.float64), bo0.data_ptr(), bopi.data_ptr(),
        drb.data_ptr(), delta.data_ptr(), tab.types.data_ptr(),
        tab.gid.data_ptr(), tab.amask.data_ptr(), tab.maskb.data_ptr(),
        tab.nbrs.idxb.data_ptr(), tab.img.shift.data_ptr(),
        ffd.Val.data_ptr(), ffd.Valangle.data_ptr(), ffd.inxn4.data_ptr(),
        ffd.torprm.data_ptr(), n, N, kb, nso, tab.img.n_own,
        units.CUTOF2_ESUB, units.MINBO0, reax._cos_bound(dt), units.NSMALL,
        reax._cross_floor(dt), e_part.data_ptr(), grad.data_ptr(),
        rows.data_ptr(), native.stream(dev))
    launches["torsion"] += 1
    e = e_part.sum(dim=1)
    cnt = rows.sum()
    if tab.cap is not None and n:
        cnt = torch.where(rows.max() > tab.rowcap, reax.ROW_OVERFLOW, cnt)
    return e[0], e[1], grad, cnt


def torsion_plain(bo0, bopi, drb, delta, tab: TorsionTables):
    """`torsion` in PyTorch: reax.build_torsion_list's list (capacity
    `tab.cap`, exact where None) and `reax.torsion_energy` over it, each
    energy's gradients by torch.autograd.grad."""
    from .. import reax                       # reax imports this module
    x = tuple(t.detach().requires_grad_(True)
              for t in (bo0, bopi, drb, delta))
    # the list build reads BO0 (channel 0 of BondOrder.bo) and the mask
    bo = reax.BondOrder(bo=x[0][..., None], delta=x[3], deltap1=x[3],
                        mask=tab.maskb, drb=x[2])
    with torch.enable_grad():
        tl = reax.build_torsion_list(tab.types, tab.gid, tab.img, tab.nbrs,
                                     bo, tab.amask, tab.ffd, cap=tab.cap,
                                     ks=tab.ks, rowcap=tab.rowcap)
        et, ec = reax.torsion_energy(tl, *x, tab.types, tab.ffd)
        gt = torch.autograd.grad(et, x, retain_graph=True,
                                 allow_unused=True)
        gc = torch.autograd.grad(ec, x, allow_unused=True)
    grad = torch.stack([torch.cat([
        (torch.zeros_like(t) if g is None else g).reshape(-1)
        for g, t in zip(gs, x)]) for gs in (gt, gc)])
    return et.detach(), ec.detach(), grad, tl.cnt


class TorsionEnergy(torch.autograd.Function):
    """(E_tors, E_conj, count)(bo0, bopi, drb, delta) through `torsion`:
    the forward keeps both energies' gradients, the backward scales each
    by its energy's gradient.  `tab` carries no gradient; the count
    (a device tensor) none either."""

    @staticmethod
    def forward(ctx, bo0, bopi, drb, delta, tab: TorsionTables):
        et, ec, grad, cnt = torsion(bo0, bopi, drb, delta, tab)
        ctx.save_for_backward(grad)
        ctx.shape = bo0.shape
        ctx.mark_non_differentiable(cnt)
        return et, ec, cnt

    @staticmethod
    @once_differentiable
    def backward(ctx, g_t, g_c, _):
        (grad,) = ctx.saved_tensors
        return (*split(g_t * grad[0] + g_c * grad[1], *ctx.shape), None)
