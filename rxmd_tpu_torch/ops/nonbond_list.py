"""The closed-form nonbond of ReaxFF over the pair list (vdW and shielded
Coulomb, ref: pot.F90:702-773) as one CUDA kernel (csrc/nonbond_list.cu)
beside its plain PyTorch version.

Center i (a row below `nbrs.center_rows`), neighbor e from i's nonbonded
list (ext index, -1 padded) with |r_i - r_e|^2 <= rctap^2, amask[i], e not
i itself (another owner where the image table holds several images, else
another global id) and a pair type (`cf_pair[ti, tj, 0] > 0.5`); ghost
positions are pos[e % nown] + shift[e] @ H^T, as `neighbors.ext_positions`
forms them.  The arithmetic is `reax.cf_nonbond`'s without the LG terms,
summed as `reax._nonbond_rows` sums it: each pair in both rows, so the
energies and the virial carry a factor 0.5 and a row's force is its own.

`nonbond_list` gives (evdw, eclmb, the row forces (n, 3), the virial W_ab
= -dE/deps_ab (3, 3) or None): the kernel for CUDA tensors (or raises),
`nonbond_list_plain` (reax.nb_ctx and reax.nonbond_cf_energy_forces) for
CPU tensors.  The charge self-energy stays with the caller.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import native, units
from ..neighbors import ImageTable, Neighbors

# launches of the kernel, counted by its wrapper where it launches it
launches = {"nonbond_list": 0}

_SRC = native.source("nonbond_list.cu")
# columns of cf_pair the closed form reads (csrc/nonbond_list.cu kPrm)
_PRM = 6


class NonbondInputs(NamedTuple):
    """What the term reads besides the charges (no gradient flows)."""
    pos: torch.Tensor       # (N, 3) owner rows
    H: torch.Tensor         # (3, 3) box
    types: torch.Tensor     # (N,) int64
    gid: torch.Tensor       # (N,) int64 global atom ids
    amask: torch.Tensor     # (N,) bool: the live centers
    img: ImageTable         # owner and lattice shift of each ext entry
    nbrs: Neighbors         # idxnb (n, knb) nonbonded ext indices; n rows
    ffd: object             # reax.FFDev: cf_pair, ctap, rctap2, pvdW1h,
                            # pvdW1inv, is_lg


@functools.cache
def _library():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return native.load(_SRC, "rxmd_nonbond_list_error_string",
                       rxmd_nonbond_list=(
                           [ci, ci] + [vp] * 14 + [ci] * 5
                           + [ctypes.c_longlong, ctypes.c_double]
                           + [vp] * 3))


def nonbond_list(inp: NonbondInputs, q, qj=None, with_virial=False):
    """(evdw, eclmb, f (n, 3), virial (3, 3) or None) at charges `q`: the
    centers' (n,) with `qj`, the slots' charges (n, knb), else the owner
    rows' (N,).  The CUDA kernel for a CUDA tensor (or raises), the plain
    version for a CPU tensor."""
    if inp.ffd.is_lg:
        raise ValueError("nonbond_list: takes no LG dispersion (the PyTorch "
                         "path reax.nonbond_cf_energy_forces does)")
    if native.device_kind(q, "nonbond_list") == "cpu":
        return nonbond_list_plain(inp, q, qj, with_virial)
    dev, dt = q.device, q.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"nonbond_list: takes float32 or float64, got {dt}")
    img, ffd = inp.img, inp.ffd
    n, knb = inp.nbrs.idxnb.shape
    M, N, nso = img.shift.shape[0], img.n_own, ffd.cf_pair.shape[0]
    ncol = ffd.cf_pair.shape[2]
    shift = img.shift.to(dt)
    checks = [
        ("pos", inp.pos, dt, (N, 3)), ("H", inp.H, dt, (3, 3)),
        ("shift", shift, dt, (M, 3)),
        ("types", inp.types, torch.int64, (N,)),
        ("gid", inp.gid, torch.int64, (N,)),
        ("amask", inp.amask, torch.bool, (N,)),
        ("idxnb", inp.nbrs.idxnb, torch.int64, (n, knb)),
        ("q", q, dt, (N,) if qj is None else (n,)),
        ("cf_pair", ffd.cf_pair, dt, (nso, nso, ncol)),
        ("ctap", ffd.ctap, dt, (8,)), ("rctap2", ffd.rctap2, dt, ()),
        ("pvdW1h", ffd.pvdW1h, dt, ()), ("pvdW1inv", ffd.pvdW1inv, dt, ())]
    if qj is not None:
        checks.append(("qj", qj, dt, (n, knb)))
    for what, t, dtype, shape in checks:
        native.check(what, t, dtype, shape, dev)
    if ncol < _PRM or n > N or M >= 2 ** 31:
        raise ValueError(f"nonbond_list: takes {_PRM} or more cf_pair "
                         f"columns (got {ncol}), at most {N} center rows (got "
                         f"{n}) and ext entries below 2^31 (got {M})")
    # each output written once by its row: forces, and energy [and virial]
    # parts summed below in a fixed order
    f = torch.empty((n, 3), dtype=dt, device=dev)
    part = torch.empty((n, 11 if with_virial else 2), dtype=dt, device=dev)
    _library().rxmd_nonbond_list(
        int(dt == torch.float64), int(with_virial), inp.pos.data_ptr(),
        inp.H.data_ptr(), shift.data_ptr(), inp.types.data_ptr(),
        inp.gid.data_ptr(), inp.amask.data_ptr(), inp.nbrs.idxnb.data_ptr(),
        q.data_ptr(), None if qj is None else qj.data_ptr(),
        ffd.cf_pair.data_ptr(), ffd.ctap.data_ptr(), ffd.rctap2.data_ptr(),
        ffd.pvdW1h.data_ptr(), ffd.pvdW1inv.data_ptr(), n, knb, nso, ncol,
        img.n_images, N, units.CCLMB0, f.data_ptr(), part.data_ptr(),
        native.stream(dev))
    launches["nonbond_list"] += 1
    s = part.sum(dim=0)
    w = -0.5 * s[2:].view(3, 3) if with_virial else None
    return 0.5 * s[0], 0.5 * s[1], f, w


def nonbond_list_plain(inp: NonbondInputs, q, qj=None, with_virial=False):
    """`nonbond_list` in PyTorch: the pair context over the (n, knb) slots
    (reax.nb_ctx) and the closed form over it
    (reax.nonbond_cf_energy_forces)."""
    from .. import reax                       # reax imports this module
    n = inp.nbrs.center_rows
    ctx = reax.nb_ctx(inp.pos, None, inp.H, inp.types, inp.img, inp.nbrs,
                      inp.gid, inp.amask, inp.ffd)
    ctx = ctx._replace(qj=reax.ctx_qj(ctx, q, inp.img) if qj is None
                       else qj)
    out = reax.nonbond_cf_energy_forces(
        ctx, q[:n], inp.types[:n], inp.amask[:n], inp.ffd,
        with_virial=with_virial, img=inp.img)
    return out[0], out[1], out[3], out[4] if with_virial else None
