"""Cell-column nonbonded pair sweeps (counterpart of rxmd_tpu.ops.pairsweep).

Atoms (owned + periodic images) are binned into a cell grid and packed
into a fixed-capacity SLOT layout, z-fastest, so one (cx, cy) column of
cells is contiguous; a cell's atoms fill its first slots.  Padded slots
carry FAR coordinates.  Pair outputs accumulate on the target row only (no
scatter, no atomics).

Two pair bodies ride the sweep: the closed-form vdW + Coulomb
energy/force/virial rows (once per MD step) and the QEq hessian applied to
hs and ht with the Est pair sum (once per CG iteration).

The cell walk.  A target is one filled slot; the engine's targets are the
primary atoms in slot order (`atom_walk`).  For each column of the pruned
2-D stencil a target visits the cells of its own z-cell +- that column's
reach (`_reach_table`), clamped into the column, and in each cell only its
filled slots (`SlotMap.cell_count`): over the filled slots in slot order,
a column's cells are one contiguous run (`Walk.cell_start`, `Walk.slots`).
The reach is counted with the
grid's rc = rctap + skin: positions have drifted by under skin/2 each
since they were binned, so every pair within rctap is visited.

The kernels of csrc/pairsweep.cu run over the walk, each beside its plain
PyTorch version here:

  nonbond    the 11 nonbond rows of each target          nonbond_plain
  qeq_build  the QEq hessian of one solve as a CSR list  qeq_build_plain
             (of a fixed capacity, with an overflow count)
  qeq_apply  that list applied to hs, ht and q           qeq_apply_plain

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain version for a CPU tensor.  `sweep` keeps the TPU kernel's
contract, (out_k, n_targets) rows over its target layout, on top of them;
`sweep_plain` computes that independently of the walk, over each target's
own z-cell +- zreach cells shifted to stay inside the column (`_pair_list`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import units


FAR = 1.0e4          # padded-slot coordinate sentinel: dr2 ~ 1e8 fails every
                     # cutoff and stays finite through every kernel

# launches of each CUDA kernel, counted by its wrapper where it launches it
launches = {"nonbond": 0, "qeq_build": 0, "qeq_apply": 0}


class PairGrid(NamedTuple):
    """Static geometry of the sweep (hashable; host-side setup).  Column
    slot counts nzc = nc[2]*ccap and target offsets zb_lo*ccap are
    multiples of 128 (the TPU kernel's alignment contract, kept so the
    slot layout is the same in both packages)."""
    lo: tuple            # region lower corner (3,)
    cellsize: tuple      # (3,)
    nc: tuple            # (nx, ny, nz) cells
    ccap: int            # slots per cell
    block_zc: int        # z-cells per target block (C = block_zc*ccap)
    wslots: int          # TPU window size in slots (128-multiple)
    zreach: int          # z-cells of cutoff reach (window margin)
    cols: tuple          # pruned 2-D stencil (dx, dy) offsets
    tc_lo: tuple         # (cx, cy) of first target column
    tc_n: tuple          # number of target columns per axis
    zb_lo: int           # first target z-cell (multiple of block_zc)
    n_zb: int            # z-blocks per target column
    rc2: float           # (rctap + skin)^2 candidate cutoff

    @property
    def nslots(self) -> int:
        return self.nc[0] * self.nc[1] * self.nc[2] * self.ccap

    @property
    def C(self) -> int:
        return self.block_zc * self.ccap

    @property
    def n_targets(self) -> int:
        return self.tc_n[0] * self.tc_n[1] * self.n_zb * self.C


def make_pair_grid(H, rctap: float, skin: float, ccap: int = 8,
                   cell_target: float = 3.0) -> PairGrid:
    """Build the sweep geometry for an orthogonal box H (diagonal).

    The region covers the primary box plus a margin of rctap+skin on every
    side (periodic images beyond it cannot interact with primary atoms).
    """
    H = np.asarray(H)
    L = np.diag(H).astype(float)
    if not np.allclose(H, np.diag(np.diag(H))):
        raise NotImplementedError("pair sweep requires an orthogonal box")
    rc = float(rctap) + float(skin)
    margin = rc + 2.0 * cell_target + 1e-6
    lo = -margin * np.ones(3)
    ext = L + 2 * margin
    nc = np.maximum(np.round(ext / cell_target).astype(int), 3)
    cs = ext / nc
    assert 128 % ccap == 0, ccap
    block_zc = 128 // ccap
    cs[2] = ext[2] / max(int(np.round(ext[2] / cell_target)), 1)
    zreach = int(np.ceil(rc / cs[2])) + 1
    wslots = (-(-(block_zc + 2 * zreach) * ccap // 128)) * 128 + 128
    nz = int(np.ceil(ext[2] / cs[2]))
    nzc = max(-(-nz * ccap // 128) * 128, wslots)
    nc[2] = nzc // ccap
    zb_lo = int(np.floor((0 - lo[2]) / cs[2])) - 1
    zb_lo = (zb_lo // block_zc) * block_zc
    zb_hi = int(np.floor((L[2] - 1e-9 - lo[2]) / cs[2])) + 1
    n_zb = -(-(zb_hi - zb_lo + 1) // block_zc)

    reach_x = int(np.ceil(rc / cs[0]))
    reach_y = int(np.ceil(rc / cs[1]))
    cols = []
    for dx in range(-reach_x, reach_x + 1):
        for dy in range(-reach_y, reach_y + 1):
            ex = max(abs(dx) - 1, 0) * cs[0]
            ey = max(abs(dy) - 1, 0) * cs[1]
            if ex * ex + ey * ey <= rc * rc:
                cols.append((dx, dy))

    tcx_lo = int(np.floor((0 - lo[0]) / cs[0])) - 1
    tcx_hi = int(np.floor((L[0] - 1e-9 - lo[0]) / cs[0])) + 1
    tcy_lo = int(np.floor((0 - lo[1]) / cs[1])) - 1
    tcy_hi = int(np.floor((L[1] - 1e-9 - lo[1]) / cs[1])) + 1
    if not (tcx_lo - reach_x >= 0 and tcx_hi + reach_x < nc[0]
            and tcy_lo - reach_y >= 0 and tcy_hi + reach_y < nc[1]
            and zb_lo >= 0):
        raise RuntimeError("pair-sweep stencil leaves the grid")

    return PairGrid(
        lo=tuple(lo), cellsize=tuple(cs), nc=tuple(int(x) for x in nc),
        ccap=int(ccap), block_zc=int(block_zc), wslots=int(wslots),
        zreach=int(zreach), cols=tuple(cols),
        tc_lo=(tcx_lo, tcy_lo),
        tc_n=(tcx_hi - tcx_lo + 1, tcy_hi - tcy_lo + 1),
        zb_lo=int(zb_lo), n_zb=int(n_zb), rc2=float(rc * rc))


class SlotMap(NamedTuple):
    """Per-rebuild product: where each extended atom lives in slot space."""
    slot_src: torch.Tensor      # (nslots,) ext row filling the slot, -1 pad
    slot_of_atom: torch.Tensor  # (n,) slot of each primary atom
    overflow: torch.Tensor      # () max per-cell occupancy (host-checked)
    cell_count: torch.Tensor    # (ncells,) int32 filled slots per cell
    order: torch.Tensor         # (n,) primary atoms in slot order
    filled: torch.Tensor        # (m,) int32 the filled slots, ascending,
                                # then 0 to the m extended atoms


_bin_consts = {}


def _bin_tables(grid: PairGrid, dtype, device):
    """lo, cellsize (`dtype`) and the cell counts (int64) on `device`,
    made once per (grid, dtype, device): a CUDA graph's capture, which
    follows its eager first use, then copies nothing from the host."""
    key = (grid, dtype, torch.device(device))
    if key not in _bin_consts:
        _bin_consts[key] = (
            torch.as_tensor(grid.lo, dtype=dtype, device=device),
            torch.as_tensor(grid.cellsize, dtype=dtype, device=device),
            torch.as_tensor(grid.nc, dtype=torch.int64, device=device))
    return _bin_consts[key]


def bin_slots(pose, valid, grid: PairGrid, n: int) -> SlotMap:
    """Assign extended atoms to slots (stable sort by cell id, fixed
    capacity) — the cell-binning analog of LINKEDLIST (ref:
    main.F90:277-318), built on the rebuild cadence and in each
    optimizer probe.  Nothing reads the host: `filled` holds the filled
    slots padded with 0 to the m extended atoms (at most m slots fill),
    a length that depends on no value (the walk reads only the cells'
    ranges, so the padding is never read)."""
    m = pose.shape[0]
    dev = pose.device
    nc = np.array(grid.nc)
    ctot = int(np.prod(nc))
    ccap = grid.ccap
    lo, cs, nc_t = _bin_tables(grid, pose.dtype, dev)
    rel = (pose - lo) / cs
    inside = valid & ((rel >= 0) & (rel < nc_t)).all(dim=1)
    cid3 = torch.minimum(rel.to(torch.int64).clamp(min=0), nc_t - 1)
    cid = (cid3[:, 0] * nc[1] + cid3[:, 1]) * nc[2] + cid3[:, 2]
    cid = torch.where(inside, cid, ctot)
    order = torch.argsort(cid, stable=True)
    scid = cid[order]
    start = torch.searchsorted(scid, torch.arange(ctot + 1, device=dev))
    rank = torch.arange(m, device=dev) - start[scid]
    inb = (rank < ccap) & (scid < ctot)
    dst = torch.where(inb, scid * ccap + rank, ctot * ccap)    # dump slot
    slot_src = torch.full((ctot * ccap + 1,), -1, dtype=torch.int64,
                          device=dev)
    slot_src.index_copy_(0, dst, torch.where(inb, order, -1))
    overflow = torch.max(torch.where(scid < ctot, rank + 1, 0))
    # primary atoms are ext rows < n and always inside the region
    src = torch.where(inb, order, m)
    take = inb & (src < n)
    slot_of_atom = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    slot_of_atom.index_copy_(0, torch.where(take, src, n),
                             torch.where(take, dst, -1))
    slot_of_atom = slot_of_atom[:-1]
    slot_src = slot_src[:-1]
    cell_count = torch.clamp(start[1:] - start[:-1], max=ccap)
    # the slots in sorted order ascend, so compacting them in that order
    # keeps them ascending
    at = torch.where(inb, torch.cumsum(inb, 0) - 1, m)
    filled = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    filled = filled.index_copy_(0, at, dst.to(torch.int32))[:-1]
    return SlotMap(slot_src=slot_src, slot_of_atom=slot_of_atom,
                   overflow=overflow, cell_count=cell_count.to(torch.int32),
                   order=torch.argsort(slot_of_atom), filled=filled)


def pack_slots(slot_src, cols, far_cols: int = 3):
    """Pack per-ext-atom columns into the (K, nslots) slot layout.  The
    first `far_cols` (positions) get the FAR sentinel in padded slots; the
    rest get 0."""
    ok = slot_src >= 0
    src = torch.where(ok, slot_src, 0)
    packed = torch.stack([c[src] for c in cols], dim=0)
    fills = torch.tensor([FAR] * far_cols + [0.0] * (len(cols) - far_cols),
                         dtype=packed.dtype, device=packed.device)
    return torch.where(ok[None, :], packed, fills[:, None])


def _target_tables(grid: PairGrid):
    """Per target column its slot base, and the per-stencil-column slot
    offsets (numpy int32)."""
    nx, ny, nz = grid.nc
    ccap = grid.ccap
    cxs = np.arange(grid.tc_lo[0], grid.tc_lo[0] + grid.tc_n[0])
    cys = np.arange(grid.tc_lo[1], grid.tc_lo[1] + grid.tc_n[1])
    cx, cy = np.meshgrid(cxs, cys, indexing="ij")
    col_base = ((cx * ny + cy) * nz * ccap).reshape(-1).astype(np.int32)
    coloffs = np.asarray([(dx * ny + dy) * nz * ccap
                          for dx, dy in grid.cols], np.int32)
    return col_base, coloffs


def _reach_table(grid: PairGrid):
    """Per stencil column (dx, dy), the z-cells of a target's walk on each
    side of its own z-cell: the z-extent of the rc sphere beyond the
    column's nearest x-y distance (ex, ey as in make_pair_grid), in cells,
    plus one for the target's place inside its cell (numpy int32, at most
    zreach)."""
    cs = grid.cellsize
    reach = []
    for dx, dy in grid.cols:
        ex = max(abs(dx) - 1, 0) * cs[0]
        ey = max(abs(dy) - 1, 0) * cs[1]
        h = np.sqrt(max(grid.rc2 - ex * ex - ey * ey, 0.0))
        reach.append(min(int(np.ceil(h / cs[2])) + 1, grid.zreach))
    return np.asarray(reach, np.int32)


def _target_slots(grid: PairGrid):
    """Slot of each target index t = (column p, z-block zb, slot c)
    (numpy int64, (n_targets,))."""
    col_base, _ = _target_tables(grid)
    per = grid.n_zb * grid.C
    return (col_base.astype(np.int64)[:, None] + grid.zb_lo * grid.ccap
            + np.arange(per)[None, :]).reshape(-1)


def target_index(grid: PairGrid, slot_of_atom):
    """Target index of each primary atom's slot."""
    ccap = grid.ccap
    nz = grid.nc[2]
    ny = grid.nc[1]
    colslot = slot_of_atom // (nz * ccap)
    cx = colslot // ny - grid.tc_lo[0]
    cy = colslot % ny - grid.tc_lo[1]
    z = slot_of_atom % (nz * ccap) - grid.zb_lo * ccap
    p = cx * grid.tc_n[1] + cy
    return p * (grid.n_zb * grid.C) + z


def gather_rows(grid: PairGrid, out, slot_of_atom):
    """Per-primary-atom rows of a sweep output: map atom -> target index."""
    return out[:, target_index(grid, slot_of_atom)]


class Walk(NamedTuple):
    """The targets of a sweep and the filled slots their walk reads: cell c
    holds slots[cell_start[c]:cell_start[c + 1]]."""
    tslot: torch.Tensor       # (T,) int32 target slots, ascending
    trow: torch.Tensor        # (T,) int32 output row of each target
    nrows: int                # rows of the output
    cell_start: torch.Tensor  # (ncells + 1,) int32 prefix sums of counts
    slots: torch.Tensor       # int32 the filled slots, ascending (any
                              # padding after them is never read)


def _cell_start(cell_count):
    start = torch.zeros(cell_count.shape[0] + 1, dtype=torch.int32,
                        device=cell_count.device)
    start[1:] = torch.cumsum(cell_count, 0, dtype=torch.int32)
    return start


def atom_walk(sm: SlotMap) -> Walk:
    """The engine's walk: the primary atoms in slot order, each writing
    its own row of an (out_k, n) output."""
    return Walk(tslot=sm.slot_of_atom[sm.order].to(torch.int32),
                trow=sm.order.to(torch.int32), nrows=sm.order.shape[0],
                cell_start=_cell_start(sm.cell_count), slots=sm.filled)


def slot_walk(grid: PairGrid, packed, rows=None) -> Walk:
    """The walk of the sweep's target layout: the filled targets among
    `rows` (target indices; every target if None), each writing its row of
    an (out_k, n_targets) output.  Cell counts come from the position
    plane: a cell's atoms fill its first slots."""
    dev = packed.device
    filled = packed[0] != FAR
    tslot = torch.as_tensor(_target_slots(grid), device=dev)
    if rows is None:
        rows = torch.arange(grid.n_targets, device=dev)
    rows = rows[filled[tslot[rows]]]
    return Walk(tslot=tslot[rows].to(torch.int32),
                trow=rows.to(torch.int32), nrows=grid.n_targets,
                cell_start=_cell_start(filled.view(-1, grid.ccap).sum(
                    dim=1, dtype=torch.int32)),
                slots=torch.nonzero(filled).squeeze(1).to(torch.int32))


# ---------------------------------------------------------------------------
# pair functions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PairFn:
    """One pair body of the sweep: its name, the packed planes K it reads,
    its output rows, its type-pair table (nso, nso, P) and taper
    coefficients, and its scalar constants."""
    name: str
    K: int
    out_k: int
    table: torch.Tensor
    ctap: torch.Tensor
    rc2: float
    pvdW1h: float = 0.0
    pvdW1inv: float = 0.0


def make_nonbond_pair_fn(ffd, nso: int, rc2_true: float) -> PairFn:
    """Closed-form vdW + Coulomb row sweep (the kernel analog of
    cf_nonbond + nonbond_cf_energy_forces; ref hot loop pot.F90:702-773).

    packed planes: 0:x 1:y 2:z 3:type 4:gid 5:q
    outputs (11,): evdw, eclmb, fx, fy, fz, w_xx, w_yy, w_zz, w_yz, w_zx,
    w_xy   (energies and virial carry the directed-pair 0.5)
    """
    cf = ffd.cf_pair
    assert cf.shape[0] == nso
    return PairFn(name="nonbond", K=6, out_k=11,
                  table=cf[..., :6].contiguous(), ctap=ffd.ctap.clone(),
                  rc2=float(rc2_true), pvdW1h=float(ffd.pvdW1h),
                  pvdW1inv=float(ffd.pvdW1inv))


def make_qeq_pair_fn(ffd, nso: int, rc2_true: float) -> PairFn:
    """QEq hessian sweep: H·hs, H·ht and the Est pair sum in one pass (the
    kernel analog of get_hsh, ref: qeq.F90:271-318, with the closed-form
    shielded-Coulomb kernel of init.F90:487-489).

    packed planes: 0:x 1:y 2:z 3:type 4:is_primary 5:hs 6:ht 7:q
    outputs (3,): hshs, hsht, est_pair (Est weight 1.0 for a primary
    neighbor, 0.5 for an image — ref: qeq.F90:304-306 semantics)
    """
    cf = ffd.cf_pair
    assert cf.shape[0] == nso
    return PairFn(name="qeq", K=8, out_k=3,
                  table=torch.stack([cf[..., 0], cf[..., 5]], -1).contiguous(),
                  ctap=ffd.ctap.clone(), rc2=float(rc2_true))


def _dist2(d):
    """Squared length of displacement planes d (3, ...), summed as the
    kernels sum it, (dx*dx + dy*dy) + dz*dz with every step rounded, so
    that both apply each cutoff to the same pairs."""
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def _taper(dr2, dr1, ctap):
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


def _pair_geometry(fn: PairFn, r, s):
    """Displacement, gate, distance, taper and type parameters of the
    pairs of target planes r (K, P) and source planes s (K, P)."""
    d = r[:3] - s[:3]
    dr2 = _dist2(d)
    nso = fn.table.shape[0]
    ti = r[3].to(torch.int64).clamp(0, nso - 1)
    tj = s[3].to(torch.int64).clamp(0, nso - 1)
    prm = fn.table[ti, tj]                                   # (P, npar)
    ok = (dr2 <= fn.rc2) & (dr2 > 1e-6) & (prm[:, 0] > 0.5)
    dr2s = torch.where(ok, dr2, 1.0)
    dr1 = torch.sqrt(dr2s)
    tap, dtap = _taper(dr2s, dr1, fn.ctap)
    return d, ok, dr2s, dr1, tap, dtap, prm


def _qeq_hessian(fn: PairFn, r, s):
    """The QEq body's gate and hessian element of each pair (0 where the
    gate fails)."""
    _, ok, dr2s, dr1, tap, _, prm = _pair_geometry(fn, r, s)
    gamij = torch.where(ok, prm[:, 1], 1.0)
    hess = units.CCLMB0_QEQ * tap * (dr1 * dr2s + gamij) ** (-1.0 / 3.0)
    return ok, torch.where(ok, hess, 0.0)


def _pair_terms(fn: PairFn, r, s):
    """Per-pair output rows (out_k, P) of `fn` for target planes r (K, P)
    and source planes s (K, P); pairs that fail a gate contribute 0."""
    if fn.name == "qeq":
        _, hess = _qeq_hessian(fn, r, s)
        return hess * torch.stack(
            [s[5], s[6], torch.where(s[4] > 0.5, s[7], 0.5 * s[7])])
    d, ok, dr2s, dr1, tap, dtap, prm = _pair_geometry(fn, r, s)
    ok = ok & (r[4] != s[4])                      # ref: pot.F90:715
    gamw = torch.where(ok, prm[:, 1], 1.0)
    alpha, rvdwi, dij = prm[:, 2], prm[:, 3], prm[:, 4]
    gamij = torch.where(ok, prm[:, 5], 1.0)
    rij_vd1 = dr2s ** fn.pvdW1h
    fn13 = (rij_vd1 + gamw) ** fn.pvdW1inv
    exp1 = torch.exp(alpha * (1.0 - fn13 * rvdwi))
    exp2 = torch.sqrt(exp1)
    dr3gam = (dr1 * dr2s + gamij) ** (-1.0 / 3.0)
    qq = r[5] * s[5]
    evdw = tap * dij * (exp1 - 2.0 * exp2)
    eclmb = tap * units.CCLMB0 * dr3gam * qq
    # (dE/dr)/r, ref: pot.F90:736-761
    dfn13 = fn13 / (rij_vd1 + gamw) * (rij_vd1 / dr2s)
    devdw = dij * (dtap * (exp1 - 2.0 * exp2)
                   - tap * (alpha * rvdwi) * (exp1 - exp2) * dfn13)
    declmb = units.CCLMB0 * dr3gam * (dtap - dr3gam ** 3 * tap * dr1) * qq
    ffac = torch.where(ok, devdw + declmb, 0.0)
    evdw = torch.where(ok, evdw, 0.0)
    eclmb = torch.where(ok, eclmb, 0.0)
    dx, dy, dz = d[0], d[1], d[2]
    return torch.stack([
        0.5 * evdw, 0.5 * eclmb, -ffac * dx, -ffac * dy, -ffac * dz,
        -0.5 * ffac * dx * dx, -0.5 * ffac * dy * dy, -0.5 * ffac * dz * dz,
        -0.5 * ffac * dy * dz, -0.5 * ffac * dz * dx, -0.5 * ffac * dx * dy])


def _chunk(dev):
    """Candidates per chunk of the plain versions' pair searches."""
    return 1 << (25 if dev.type == "cuda" else 22)


def _rows_of(fn: PairFn, planes, tgt, tsl, src, nrows, chunk):
    """(out_k, nrows): the pair terms of (target slot tsl, source slot src)
    summed into output row tgt, in chunks."""
    out = torch.zeros((fn.out_k, nrows), dtype=planes.dtype,
                      device=planes.device)
    per = max(1, chunk // 16)
    for p0 in range(0, tgt.shape[0], per):
        sl = slice(p0, p0 + per)
        out.index_add_(1, tgt[sl], _pair_terms(fn, planes[:, tsl[sl]],
                                               planes[:, src[sl]]))
    return out


def _pair_list(grid: PairGrid, packed, rc2: float, chunk: int, rows=None):
    """(target index, target slot, source slot) of every pair of filled
    slots within rc2, for the filled targets among `rows` (all targets if
    None).  Each filled target slot takes, per stencil column, the filled
    slots of its own z-cell +- zreach cells (shifted to stay inside the
    column), where every partner within the cutoff lies."""
    dev = packed.device
    ccap, nzc = grid.ccap, grid.nc[2] * grid.ccap
    w = (2 * grid.zreach + 1) * ccap
    tslot = torch.as_tensor(_target_slots(grid), device=dev)
    coloffs = torch.as_tensor(_target_tables(grid)[1], dtype=torch.int64,
                              device=dev)
    filled = torch.nonzero(packed[0] != FAR).squeeze(1)       # sorted slots
    if rows is None:
        real = torch.nonzero(packed[0, tslot] != FAR).squeeze(1)
    else:
        real = rows[packed[0, tslot[rows]] != FAR]            # target index
    ts = tslot[real]
    nb = (ts - ts % nzc)[:, None] + coloffs[None, :]          # (T, cols)
    ws = nb + ((ts % nzc) // ccap - grid.zreach)[:, None] * ccap
    ws = torch.minimum(torch.maximum(ws, nb), nb + nzc - w)
    lo = torch.searchsorted(filled, ws)
    cnt = torch.searchsorted(filled, ws + w) - lo
    width = max(int(cnt.max()), 1) if cnt.numel() else 1
    k = torch.arange(width, device=dev)
    per = max(1, chunk // (coloffs.shape[0] * width))
    parts = []
    for t0 in range(0, real.shape[0], per):
        sl = slice(t0, t0 + per)
        cand = filled[torch.clamp(lo[sl, :, None] + k,
                                  max=filled.shape[0] - 1)]
        cand = torch.where(k < cnt[sl, :, None], cand, -1)
        cand = cand.reshape(cand.shape[0], -1)                # (B, cols*w)
        dr2 = _dist2(packed[:3, ts[sl], None]
                     - packed[:3][:, cand.clamp(min=0)])
        bi, ci = torch.nonzero((cand >= 0) & (dr2 <= rc2) & (dr2 > 1e-6),
                               as_tuple=True)
        parts.append((real[sl][bi], ts[sl][bi], cand[bi, ci]))
    if not parts:
        return (torch.zeros(0, dtype=torch.int64, device=dev),) * 3
    return tuple(torch.cat(x) for x in zip(*parts))


def sweep_plain(grid: PairGrid, packed, fn: PairFn, rows=None,
                chunk: int = None):
    """The sweep in plain PyTorch, independent of the cell walk: output
    (out_k, n_targets), any float dtype.  With `rows` (a tensor of target
    indices) only those targets' rows are computed, each exactly as
    without it, and the other rows are 0.  Only the pairs of filled slots
    within the cutoff (`_pair_list`) reach the pair function."""
    chunk = chunk or _chunk(packed.device)
    tgt, tsl, src = _pair_list(grid, packed, fn.rc2, chunk, rows)
    return _rows_of(fn, packed, tgt, tsl, src, grid.n_targets, chunk)


def walk_pairs_plain(grid: PairGrid, walk: Walk, pos3, rc2: float,
                     chunk: int = None):
    """(walk index, target slot, source slot) of every pair that the
    kernels' cell walk finds, in the kernels' order (per target, stencil
    column by column, slots ascending): the filled slots of each column's
    reach (`_reach_table`) around the target's z-cell, clamped into the
    column, whose squared distance lies in (1e-6, rc2].  pos3: (3, nslots)
    positions."""
    dev = pos3.device
    chunk = chunk or _chunk(dev)
    ccap, nz = grid.ccap, grid.nc[2]
    nzc = nz * ccap
    coloffs = torch.as_tensor(_target_tables(grid)[1], dtype=torch.int64,
                              device=dev)
    zr = torch.as_tensor(_reach_table(grid), dtype=torch.int64, device=dev)
    ts = walk.tslot.to(torch.int64)
    tz = (ts % nzc) // ccap
    cb = ((ts - ts % nzc)[:, None] + coloffs) // ccap        # (T, cols)
    start = walk.cell_start.to(torch.int64)
    lo = start[cb + torch.clamp(tz[:, None] - zr, min=0)]
    span = start[cb + torch.clamp(tz[:, None] + zr, max=nz - 1) + 1] - lo
    width = max(int(span.max()), 1) if span.numel() else 1
    k = torch.arange(width, device=dev)
    per = max(1, chunk // (coloffs.shape[0] * width))
    parts = []
    for t0 in range(0, ts.shape[0], per):
        sl = slice(t0, t0 + per)
        ok = k < span[sl, :, None]                            # (B, cols, w)
        slot = walk.slots[torch.where(ok, lo[sl, :, None] + k, 0)].to(
            torch.int64)
        slot, ok = slot.flatten(1), ok.flatten(1)
        dr2 = _dist2(pos3[:, ts[sl], None] - pos3[:, slot])
        bi, ci = torch.nonzero(ok & (dr2 <= rc2) & (dr2 > 1e-6),
                               as_tuple=True)
        parts.append((bi + t0, ts[sl][bi], slot[bi, ci]))
    if not parts:
        return (torch.zeros(0, dtype=torch.int64, device=dev),) * 3
    return tuple(torch.cat(x) for x in zip(*parts))


def nonbond_plain(grid: PairGrid, walk: Walk, planes, fn: PairFn,
                  chunk: int = None):
    """The nonbond kernel's function in plain PyTorch: (11, walk.nrows)
    rows of the walk's targets over the walk's pairs, any float dtype;
    rows no target writes are 0.  planes: (6, nslots) x, y, z, type, gid,
    q."""
    chunk = chunk or _chunk(planes.device)
    i, tsl, src = walk_pairs_plain(grid, walk, planes[:3], fn.rc2, chunk)
    return _rows_of(fn, planes, walk.trow[i], tsl, src, walk.nrows, chunk)


class QeqList(NamedTuple):
    """The QEq hessian of one solve: a CSR list over a walk's targets.
    With a fixed capacity (`cap` of the build functions) src and h hold `cap`
    entries, the rows' entries rowptr[i]:rowptr[i+1] cut at `cap`, and
    `need` > `cap` flags an overflow, for the host to read and raise on."""
    rowptr: torch.Tensor   # (T+1,) int32: entries rowptr[i]:rowptr[i+1]
    src: torch.Tensor      # (E,) int32 source's owner; ~owner for an image
    h: torch.Tensor        # (E,) hessian element
    nown: int              # length of the vectors the list is applied to
    need: torch.Tensor     # () int32 the walk's entries, rowptr[-1]


def walk_candidates(grid: PairGrid, walk: Walk):
    """Filled slots the walk tests, a () int64 tensor on the walk's device:
    per target and stencil column, the filled slots of the column's reach
    around the target's z-cell.  Every QEq list entry is one of them, and
    they depend on the slot map alone, so their count bounds the list of
    every solve over that map.  No host read: the stencil's tables are
    made on the device once per grid (`_device_tables`)."""
    ccap, nz = grid.ccap, grid.nc[2]
    coloffs, zr = (t.long() for t in _device_tables(grid,
                                                     walk.tslot.device))
    start = walk.cell_start.long()
    ts = walk.tslot.long()
    tz = (ts % (nz * ccap)) // ccap
    cb = ((ts - ts % (nz * ccap))[:, None] + coloffs) // ccap
    z0 = torch.clamp(tz[:, None] - zr, min=0)
    z1 = torch.clamp(tz[:, None] + zr, max=nz - 1)
    return (start[cb + z1 + 1] - start[cb + z0]).sum()


def qeq_build_plain(grid: PairGrid, walk: Walk, planes, fn: PairFn, own,
                    nown: int, cap: int = None, chunk: int = None) -> QeqList:
    """The QEq build kernel's function in plain PyTorch: per target, the
    walk's pairs that pass every gate, in the walk's order, each with its
    hessian element cclmb_qeq * tap(r) * (r^3 + gamma^-3)^(-1/3) and its
    source's owner, flagged (~owner) when the source is an image.
    planes: (5, nslots) x, y, z, type, is_primary; own: (nslots,) integer
    owner of each slot, the index into the (nown,) vectors the list is
    applied to.  With `cap` the list has that fixed capacity (QeqList);
    without, exactly its entries."""
    chunk = chunk or _chunk(planes.device)
    i, tsl, src = walk_pairs_plain(grid, walk, planes[:3], fn.rc2, chunk)
    per = max(1, chunk // 16)
    ok, h = (torch.cat(x) for x in zip(*[
        _qeq_hessian(fn, planes[:, tsl[p0:p0 + per]],
                     planes[:, src[p0:p0 + per]])
        for p0 in range(0, src.shape[0], per)] or [
        (torch.zeros(0, dtype=torch.bool, device=planes.device),
         planes.new_zeros(0))]))
    o = own[src].to(torch.int32)
    code = torch.where(planes[4, src] > 0.5, o, ~o)
    rowptr = torch.zeros(walk.tslot.shape[0] + 1, dtype=torch.int32,
                         device=planes.device)
    rowptr[1:] = torch.cumsum(torch.bincount(
        i[ok], minlength=walk.tslot.shape[0]), 0)
    code, h = code[ok], h[ok]
    if cap is not None:
        code = torch.cat([code, code.new_zeros(cap)])[:cap]
        h = torch.cat([h, h.new_zeros(cap)])[:cap]
    return QeqList(rowptr=rowptr, src=code, h=h, nown=nown,
                   need=rowptr[-1].clone())


def qeq_apply_plain(lst: QeqList, walk: Walk, hs, ht, q):
    """The QEq apply kernel's function in plain PyTorch: (3, walk.nrows)
    rows sum h*hs[o], sum h*ht[o] and sum h*w*q[o] over each target's
    entries (o the source's owner, w 1 for a primary source and 0.5 for an
    image), entries past the list's capacity left out; rows no target
    writes are 0."""
    # each entry's row: the rows' entries end at rowptr[1:]; entries past
    # the last row's end are the capacity's padding, which may hold
    # anything
    T = walk.tslot.shape[0]
    e = torch.arange(lst.src.shape[0], device=lst.src.device,
                     dtype=torch.int32)
    row = torch.searchsorted(lst.rowptr[1:], e, right=True)
    live = row < T
    code = torch.where(live, lst.src, 0).to(torch.int64)
    prim = code >= 0
    o = torch.where(prim, code, ~code)
    qo = q[o]
    vals = torch.where(live, lst.h, 0.0) * torch.stack(
        [hs[o], ht[o], torch.where(prim, qo, 0.5 * qo)])
    tgt = walk.trow.to(torch.int64)[torch.clamp(row, max=max(T - 1, 0))]
    out = torch.zeros((3, walk.nrows), dtype=vals.dtype, device=vals.device)
    return out.index_add_(1, tgt, vals)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/pairsweep.cu), built with nvcc at first use
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "pairsweep.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rxmd_tpu_torch")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_lib = None


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found: the pair-sweep kernels are "
                           "built from csrc/pairsweep.cu at first use")
    return path


def build(force: bool = False, verbose: bool = False):
    """Compile csrc/pairsweep.cu into build/rxmd_tpu_torch (keyed by a hash
    of the source and flags) unless that library exists or `force`; returns
    its path, the seconds spent compiling (0.0 when it was already built)
    and nvcc's messages (with `verbose`, ptxas's registers, shared memory
    and spills of each kernel: -Xptxas -v, which leaves the binary as it
    is)."""
    with open(_SRC, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join(_NVCC_FLAGS).encode())
    so = os.path.join(_BUILD_DIR, f"libpairsweep_{key.hexdigest()[:16]}.so")
    if os.path.exists(so) and not force:
        return so, 0.0, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    flags = _NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *flags, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, res.stderr


def _library():
    global _lib
    if _lib is None:
        so = build()[0]
        lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        walk = [vp] * 8 + [ci] * 6 + [cf]
        lib.pairsweep_nonbond.argtypes = walk + [vp, vp, ci] + [cf] * 3 + [vp]
        lib.pairsweep_qeq_count.argtypes = walk + [vp, vp]
        lib.pairsweep_qeq_fill.argtypes = walk + [vp] * 4 + [ci, vp, cf, vp]
        lib.pairsweep_qeq_apply.argtypes = (
            [vp] * 7 + [ctypes.c_longlong] * 3 + [vp, ci, ci, ci, vp])
        for f in ("nonbond", "qeq_count", "qeq_fill", "qeq_apply"):
            getattr(lib, f"pairsweep_{f}").restype = ci
        lib.pairsweep_error_string.argtypes = [ci]
        lib.pairsweep_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_tables = {}


def _device_tables(grid: PairGrid, device):
    """Per stencil column its slot offset and z-reach (int32 on device)."""
    key = (grid, device)
    if key not in _tables:
        _tables[key] = (
            torch.as_tensor(_target_tables(grid)[1], device=device),
            torch.as_tensor(_reach_table(grid), device=device))
    return _tables[key]


def _check(what, t, dtype, shape, device, strided=False):
    """Raise unless t is a `dtype` tensor of `shape` on `device`, and
    contiguous unless `strided` (a vector read with its stride)."""
    if (t.device != device or t.dtype != dtype
            or not (strided or t.is_contiguous())
            or tuple(t.shape) != tuple(shape)):
        kind = "" if strided else "contiguous "
        got = "" if t.is_contiguous() else ", strided"
        raise ValueError(f"{what}: takes a {kind}{str(dtype)[6:]} "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{str(t.dtype)[6:]} {tuple(t.shape)} on {t.device}"
                         f"{got}")


def _walk_args(grid: PairGrid, walk: Walk, planes, fn: PairFn, K: int):
    """Check a walk kernel's inputs; its leading ctypes arguments."""
    dev = planes.device
    T = walk.tslot.shape[0]
    nso = fn.table.shape[0]
    _check(f"{fn.name} planes", planes, torch.float32, (K, grid.nslots), dev)
    for what, t, shape in (("walk.tslot", walk.tslot, (T,)),
                           ("walk.trow", walk.trow, (T,)),
                           ("walk.cell_start", walk.cell_start,
                            (grid.nslots // grid.ccap + 1,)),
                           ("walk.slots", walk.slots,
                            (walk.slots.shape[0],))):
        _check(what, t, torch.int32, shape, dev)
    _check(f"{fn.name} table", fn.table, torch.float32,
           (nso, nso, fn.table.shape[2]), dev)
    _check(f"{fn.name} ctap", fn.ctap, torch.float32, (8,), dev)
    coloffs, zr = _device_tables(grid, dev)
    return (planes.data_ptr(), walk.tslot.data_ptr(), coloffs.data_ptr(),
            zr.data_ptr(), walk.cell_start.data_ptr(), walk.slots.data_ptr(),
            fn.table.data_ptr(), fn.ctap.data_ptr(), T, len(grid.cols),
            grid.nc[2] * grid.ccap,
            grid.ccap.bit_length() - 1, nso, grid.nslots, fn.rc2)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().pairsweep_error_string(err).decode()}")


def _device_kind(t, what):
    """'cuda' or 'cpu' for the wrapper's branch; any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} kernel for device {t.device}")
    return t.device.type


def nonbond(grid: PairGrid, walk: Walk, planes, fn: PairFn):
    """(11, walk.nrows) nonbond rows of the walk's targets: the CUDA kernel
    for a CUDA tensor (or raises), `nonbond_plain` for a CPU tensor."""
    if _device_kind(planes, "nonbond") == "cpu":
        return nonbond_plain(grid, walk, planes, fn)
    args = _walk_args(grid, walk, planes, fn, 6)
    T = walk.tslot.shape[0]
    new = torch.zeros if T < walk.nrows else torch.empty
    out = new((11, walk.nrows), dtype=torch.float32, device=planes.device)
    if T:
        _raise_on(_library().pairsweep_nonbond(
            *args, walk.trow.data_ptr(), out.data_ptr(), walk.nrows,
            fn.pvdW1h, fn.pvdW1inv, units.CCLMB0,
            _stream(planes.device)), "nonbond")
        launches["nonbond"] += 1
    return out


def qeq_build(grid: PairGrid, walk: Walk, planes, fn: PairFn, own,
              nown: int, cap: int = None) -> QeqList:
    """The QEq hessian list of the walk (once per QEq solve): the CUDA
    kernel's two passes for a CUDA tensor (or raises), `qeq_build_plain`
    for a CPU tensor.  The first pass counts each target's entries, a
    device cumsum makes the row pointers, and the second writes the entries
    in place, up to `cap` of them, and sets `need` (QeqList): no host read.
    Without `cap` the host reads the total and the list holds exactly it."""
    if _device_kind(planes, "qeq_build") == "cpu":
        return qeq_build_plain(grid, walk, planes, fn, own, nown, cap)
    dev = planes.device
    args = _walk_args(grid, walk, planes, fn, 5)
    _check("own", own, torch.int32, (grid.nslots,), dev)
    T = walk.tslot.shape[0]
    lib, stream = _library(), _stream(dev)
    cnt = torch.zeros(T, dtype=torch.int32, device=dev)
    if T:
        _raise_on(lib.pairsweep_qeq_count(*args, cnt.data_ptr(), stream),
                  "qeq_build (count)")
    rowptr = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    rowptr[1:] = torch.cumsum(cnt, 0, dtype=torch.int32)
    if cap is None:
        cap = int(rowptr[-1])
    src = torch.empty(cap, dtype=torch.int32, device=dev)
    h = torch.empty(cap, dtype=torch.float32, device=dev)
    need = torch.zeros((), dtype=torch.int32, device=dev)
    if T:
        _raise_on(lib.pairsweep_qeq_fill(
            *args, own.data_ptr(), rowptr.data_ptr(), src.data_ptr(),
            h.data_ptr(), cap, need.data_ptr(), units.CCLMB0_QEQ, stream),
            "qeq_build (fill)")
        launches["qeq_build"] += 1
    return QeqList(rowptr=rowptr, src=src, h=h, nown=nown, need=need)


def qeq_apply(lst: QeqList, walk: Walk, hs, ht, q):
    """(3, walk.nrows) rows H·hs, H·ht and the Est pair sum from the list
    (once per CG iteration): the CUDA kernel for a CUDA tensor (or
    raises), `qeq_apply_plain` for a CPU tensor.  hs, ht and q may be
    strided views, such as the columns of the CG's (n, 2) state."""
    if _device_kind(hs, "qeq_apply") == "cpu":
        return qeq_apply_plain(lst, walk, hs, ht, q)
    dev = hs.device
    T = walk.tslot.shape[0]
    E = lst.h.shape[0]
    for what, t, dtype, shape, strided in (
            ("hs", hs, torch.float32, (lst.nown,), True),
            ("ht", ht, torch.float32, (lst.nown,), True),
            ("q", q, torch.float32, (lst.nown,), True),
            ("list rowptr", lst.rowptr, torch.int32, (T + 1,), False),
            ("list src", lst.src, torch.int32, (E,), False),
            ("list h", lst.h, torch.float32, (E,), False),
            ("walk.trow", walk.trow, torch.int32, (T,), False)):
        _check(what, t, dtype, shape, dev, strided)
    new = torch.zeros if T < walk.nrows else torch.empty
    out = new((3, walk.nrows), dtype=torch.float32, device=dev)
    if T:
        _raise_on(_library().pairsweep_qeq_apply(
            lst.rowptr.data_ptr(), lst.src.data_ptr(), lst.h.data_ptr(),
            walk.trow.data_ptr(), hs.data_ptr(), ht.data_ptr(), q.data_ptr(),
            hs.stride(0), ht.stride(0), q.stride(0), out.data_ptr(), T,
            walk.nrows, E, _stream(dev)), "qeq_apply")
        launches["qeq_apply"] += 1
    return out


def sweep(grid: PairGrid, packed, fn: PairFn, rows=None):
    """One sweep over the TPU kernel's target layout: (out_k, n_targets)
    where target t = (column p, z-block zb, slot c) maps to slot
    col_base[p] + (zb_lo + zb*block_zc)*ccap + c; with `rows` (target
    indices) only those rows are computed and the others are 0.  A CUDA
    tensor goes through the kernels over `slot_walk` (nonbond, or
    qeq_build then qeq_apply with each slot its own source index), or
    raises; a CPU tensor through `sweep_plain`."""
    dev = packed.device
    if _device_kind(packed, "pair sweep") == "cpu":
        return sweep_plain(grid, packed, fn, rows)
    _check(f"{fn.name} sweep", packed, torch.float32, (fn.K, grid.nslots),
           dev)
    walk = slot_walk(grid, packed, rows)
    if fn.name == "nonbond":
        return nonbond(grid, walk, packed, fn)
    own = torch.arange(grid.nslots, dtype=torch.int32, device=dev)
    lst = qeq_build(grid, walk, packed[:5], fn, own, grid.nslots)
    return qeq_apply(lst, walk, packed[5], packed[6], packed[7])
