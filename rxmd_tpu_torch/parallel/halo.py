"""Halo exchange over the 3-D domain mesh, COPYATOMS(MODE_COPY) as point-
to-point messages (counterpart of rxmd_tpu.parallel.halo).

The reference exchanges ghost atoms in six sequential face phases
(+x,-x,+y,-y,+z,-z) (ref: comm.F90:2-597); corner and edge ghosts arrive
transitively because later phases forward atoms received earlier
(comm.F90:282-287).  Each phase here is one `Comm.shift` along one mesh
axis with a packed buffer of fixed capacity `bcap`, as rxmd_tpu's
`ppermute` (rxmd_tpu/parallel/halo.py:32-149).

The exchange is a *plan* (which rows go where: integer selections built
at each rebuild) and its *application* (push any per-atom tensor through
the plan).  `apply_plan` is a torch.autograd.Function: its backward runs
the phases in reverse order and sends each ghost block's gradient back to
the rank it came from, which adds it into the rows it sent (the reference's
ghost-force copy-back MODE_CPBK, comm.F90:74-78; rxmd_tpu gets it as the
transpose of ppermute).  Reversing the phases carries the gradients of
the transitively forwarded corner and edge ghosts home.

All coordinates are global fractional; the wrap shifts at the periodic
boundary mirror comm.F90:531-548 (xshift).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..neighbors import _select_k
from ..utils import timers as trace

# phase table: (axis index, direction)
PHASES = ((0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1))


class HaloSpec(NamedTuple):
    mesh_shape: tuple    # (nx, ny, nz)
    skin_frac: tuple     # skin width per axis in global fractional units
    ncap: int            # resident capacity per domain
    bcap: int            # per-phase ghost buffer capacity


class HaloPlan(NamedTuple):
    sel: torch.Tensor       # (6, bcap) int64 rows of the growing ext array
    shift: torch.Tensor     # (6, bcap) fractional shift on the phase axis
    cnt_send: torch.Tensor  # (6,) int64
    cnt_recv: torch.Tensor  # (6,) int64: valid entries of each ghost block


def build_plan(frac, valid, spec: HaloSpec, comm):
    """The exchange plan and the ghosts' fractional coordinates.

    frac: (ncap, 3) global fractional coordinates of the residents.
    Returns (plan, frac_ext (ncap + 6*bcap, 3), valid_ext).  Rows are
    chosen lowest index first, as jax.lax.top_k orders them, so the plan
    equals rxmd_tpu's entry for entry."""
    ncap, bcap = spec.ncap, spec.bcap
    dtype, dev = frac.dtype, frac.device
    mext = ncap + 6 * bcap
    frac_ext = torch.zeros((mext, 3), dtype=dtype, device=dev)
    frac_ext[:ncap] = frac
    valid_ext = torch.zeros((mext,), dtype=torch.bool, device=dev)
    valid_ext[:ncap] = valid
    slot = torch.arange(bcap, device=dev)

    sels, shifts, cs, cr = [], [], [], []
    for p, (ax, d) in enumerate(PHASES):
        n = spec.mesh_shape[ax]
        my = comm.coords[ax]
        lo = my / n
        hi = (my + 1.0) / n
        known = ncap + p * bcap
        x = frac_ext[:known, ax]
        kvalid = valid_ext[:known]
        # ghosts keep two-sided bounds so copies received earlier (outside
        # [lo, hi) on this axis) are not sent again (ref: inBuffer
        # comm.F90:551-576); residents take the one-sided bound, so atoms
        # that drifted past the domain face since the last migration
        # (between rebuilds and in optimizer probes, bounded by the Verlet
        # skin) are still sent
        res_row = torch.arange(known, device=dev) < ncap
        if d > 0:
            near = kvalid & (x >= hi - spec.skin_frac[ax])
            mask = near & (res_row | (x < hi))
            shift_val = -1.0 if my == n - 1 else 0.0
        else:
            near = kvalid & (x < lo + spec.skin_frac[ax])
            mask = near & (res_row | (x >= lo))
            shift_val = 1.0 if my == 0 else 0.0
        sel = _select_k(mask[None], bcap)[0]
        good = sel >= 0
        sel = torch.where(good, sel, 0)
        cnt = mask.sum().reshape(1)
        shift = torch.where(good, shift_val, 0.0).to(dtype)

        payload = frac_ext[sel]
        payload[:, ax] += shift
        payload = torch.where(good[:, None], payload, 0.0)
        recv = comm.shift(payload, ax, d)
        cnt_recv = comm.shift(cnt, ax, d)[0]

        blk = ncap + p * bcap
        frac_ext[blk:blk + bcap] = recv
        valid_ext[blk:blk + bcap] = slot < cnt_recv
        sels.append(sel)
        shifts.append(shift)
        cs.append(cnt[0])
        cr.append(cnt_recv)

    plan = HaloPlan(sel=torch.stack(sels), shift=torch.stack(shifts),
                    cnt_send=torch.stack(cs), cnt_recv=torch.stack(cr))
    return plan, frac_ext, valid_ext


def _forward(x, plan: HaloPlan, spec: HaloSpec, comm, is_frac):
    ncap, bcap = spec.ncap, spec.bcap
    ext = x.new_zeros((ncap + 6 * bcap,) + tuple(x.shape[1:]))
    ext[:ncap] = x
    slot = torch.arange(bcap, device=x.device)
    for p, (ax, d) in enumerate(PHASES):
        good = slot < plan.cnt_send[p]
        payload = ext[plan.sel[p]]
        if is_frac:
            payload[:, ax] += plan.shift[p].to(x.dtype)
        payload = torch.where(
            good.reshape((bcap,) + (1,) * (x.ndim - 1)), payload,
            torch.zeros((), dtype=x.dtype, device=x.device))
        blk = ncap + p * bcap
        ext[blk:blk + bcap] = comm.shift(payload, ax, d)
    return ext


def _backward(g_ext, plan: HaloPlan, spec: HaloSpec, comm):
    """MODE_CPBK: the phases in reverse; each ghost block's gradient goes
    back to the rank that sent the rows and is added into them."""
    ncap, bcap = spec.ncap, spec.bcap
    g = g_ext.clone()
    slot = torch.arange(bcap, device=g.device)
    for p in reversed(range(len(PHASES))):
        ax, d = PHASES[p]
        blk = ncap + p * bcap
        back = comm.shift(g[blk:blk + bcap].contiguous(), ax, -d)
        good = slot < plan.cnt_send[p]
        back = torch.where(good.reshape((bcap,) + (1,) * (g.ndim - 1)),
                           back, 0.0)
        g.index_add_(0, plan.sel[p], back)
    return g[:ncap]


class _ApplyPlan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, spec, comm, is_frac):
        ctx.plan, ctx.spec, ctx.comm = plan, spec, comm
        return _forward(x, plan, spec, comm, is_frac)

    @staticmethod
    def backward(ctx, g_ext):
        with trace.phase("halo"):
            g = _backward(g_ext, ctx.plan, ctx.spec, ctx.comm)
        return g, None, None, None, None


def apply_plan(plan: HaloPlan, x, spec: HaloSpec, comm, is_frac=False):
    """Push per-atom data (ncap, ...) through the saved plan, returning the
    extended tensor (ncap + 6*bcap, ...).  Differentiable in x: the
    backward is the reverse exchange and scatter-add (MODE_CPBK)."""
    with trace.phase("halo"):
        if x.requires_grad:
            return _ApplyPlan.apply(x, plan, spec, comm, is_frac)
        return _forward(x, plan, spec, comm, is_frac)
