"""Cell-column nonbonded pair sweeps (counterpart of rxmd_tpu.ops.pairsweep).

Atoms (owned + periodic images) are binned into a cell grid and packed
into a fixed-capacity SLOT layout, z-fastest, so one (cx, cy) column of
cells is contiguous; a cell's atoms fill its first slots.  Padded slots
carry FAR coordinates.  Pair outputs accumulate on the target row only (no
scatter, no atomics).

Two pair bodies ride the sweep: the closed-form vdW + Coulomb
energy/force/virial rows (once per MD step) and the QEq hessian applied to
the CG's (n, 2) state with the Est pair sum (once per CG matvec).

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
  qeq_build  the QEq hessian of one solve as a list of   qeq_build_plain
             8-byte records, each target's at its offset
             (`Walk.qstart`), of a fixed capacity
  qeq_apply  that list applied to the (n, 2) state and q qeq_apply_plain

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain version for a CPU tensor.  `sweep_plain` keeps the TPU kernel's
contract, (out_k, n_targets) rows over its target layout, independently
of the walk, over each target's own z-cell +- zreach cells shifted to
stay inside the column (`_pair_list`): the tests' reference for the walk.
The kernels build at first use (native.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import native, units


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
    qstart: torch.Tensor        # (n+1,) int32 the QEq list offsets of
                                # `atom_walk` (Walk.qstart)
    qblocks: torch.Tensor       # (B, 2) int32 the QEq build's blocks of
                                # `atom_walk` (Walk.qblocks)


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
    ranges, so the padding is never read).  `qstart` places the QEq list
    of every solve over this map (`qeq_starts`), `qblocks` splits its
    targets among the build's blocks (`qeq_blocks`)."""
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
    order = torch.argsort(slot_of_atom)
    cell_count = cell_count.to(torch.int32)
    tslot = slot_of_atom[order]
    return SlotMap(slot_src=slot_src, slot_of_atom=slot_of_atom,
                   overflow=overflow, cell_count=cell_count, order=order,
                   filled=filled,
                   qstart=qeq_starts(grid, tslot, _cell_start(cell_count)),
                   qblocks=qeq_blocks(grid, tslot))


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
    qstart: torch.Tensor      # (T+1,) int32 prefix sums of the targets'
                              # walk candidates: target i's QEq entries
                              # start at qstart[i] (`qeq_starts`)
    qblocks: torch.Tensor     # (B, 2) int32 block b of the QEq build
                              # takes targets qblocks[b, 0]:qblocks[b, 1]
                              # (`qeq_blocks`)


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
                cell_start=_cell_start(sm.cell_count), slots=sm.filled,
                qstart=sm.qstart, qblocks=sm.qblocks)


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
    cell_start = _cell_start(filled.view(-1, grid.ccap).sum(
        dim=1, dtype=torch.int32))
    return Walk(tslot=tslot[rows].to(torch.int32),
                trow=rows.to(torch.int32), nrows=grid.n_targets,
                cell_start=cell_start,
                slots=torch.nonzero(filled).squeeze(1).to(torch.int32),
                qstart=qeq_starts(grid, tslot[rows], cell_start),
                qblocks=qeq_blocks(grid, tslot[rows]))


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


_REC_INT = {torch.float32: torch.int32, torch.float64: torch.int64}


class QeqList(NamedTuple):
    """The QEq hessian of one solve over a walk's targets: target i's
    entries are the records rec[start[i] : start[i] + count[i]], in walk
    order, start the walk's `qstart` (so the rows leave gaps where their
    candidates failed the gates).  A record is (source code, the bits of
    h): an int32 pair for float32 (an int2 to the kernels), int64 for
    float64.  The list's capacity is cap = rec.shape[0]; entries at or
    past it are not written, and `need` > cap flags that, for the host to
    read and raise on."""
    start: torch.Tensor    # (T,) int32 first record of each target
    count: torch.Tensor    # (T,) int32 entries of each target
    rec: torch.Tensor      # (cap, 2) records (code, bits of h)
    nown: int              # rows of the state the list is applied to
    need: torch.Tensor     # () int32 the capacity the layout asks,
                           # qstart[T]: the walk's candidates

    @property
    def code(self):
        """(cap,) the source's owner; ~owner for an image."""
        return self.rec[:, 0]

    @property
    def h(self):
        """(cap,) the hessian elements (a view of the records)."""
        return self.rec[:, 1].view(_REC_FLOAT[self.rec.dtype])


_REC_FLOAT = {v: k for k, v in _REC_INT.items()}


def _target_candidates(grid: PairGrid, tslot, cell_start):
    """(T,) int64: per target, the filled slots its walk tests (per
    stencil column, the filled slots of the column's reach around the
    target's z-cell).  No host read: the stencil's tables are made on the
    device once per grid (`_device_tables`)."""
    ccap, nz = grid.ccap, grid.nc[2]
    coloffs, zr = (t.long() for t in _device_tables(grid, tslot.device))
    start = cell_start.long()
    ts = tslot.long()
    tz = (ts % (nz * ccap)) // ccap
    cb = ((ts - ts % (nz * ccap))[:, None] + coloffs) // ccap
    z0 = torch.clamp(tz[:, None] - zr, min=0)
    z1 = torch.clamp(tz[:, None] + zr, max=nz - 1)
    return (start[cb + z1 + 1] - start[cb + z0]).sum(dim=1)


def qeq_starts(grid: PairGrid, tslot, cell_start):
    """(T+1,) int32 offsets of the QEq list over the targets `tslot`:
    target i's entries start at the sum of the walk candidates of the
    targets before it, and the last offset, the candidates' total, is the
    capacity that layout asks.  They depend on the slot map alone, so the
    rebuild makes them once for every solve over that map."""
    out = torch.zeros(tslot.shape[0] + 1, dtype=torch.int32,
                      device=tslot.device)
    out[1:] = torch.cumsum(_target_candidates(grid, tslot, cell_start), 0)
    return out


# targets a block of the QEq build takes at most (one a lane of a warp;
# csrc/pairsweep.cu's kBuildTargets, which the build checks)
BUILD_TARGETS = 32


def qeq_blocks(grid: PairGrid, tslot):
    """(B, 2) int32 (first, end) targets of each block of the QEq build
    over the targets `tslot` (ascending): each column's targets in runs of
    BUILD_TARGETS, so a block's targets lie in one column; the largest
    blocks first (the card starts them first, and the small ones fill in
    behind), then empty blocks (T, T).  B = ceil(T / BUILD_TARGETS) plus
    one for each column the targets may lie in, a length no value decides
    (no host read)."""
    T = tslot.shape[0]
    dev = tslot.device
    nb = -(-T // BUILD_TARGETS) + min(T, grid.nc[0] * grid.nc[1])
    first = torch.full((nb + 2,), T, dtype=torch.int64, device=dev)
    if T:
        col = tslot.long() // (grid.nc[2] * grid.ccap)
        i = torch.arange(T, device=dev)
        new = torch.ones(T, dtype=torch.bool, device=dev)
        new[1:] = col[1:] != col[:-1]
        colstart = torch.cummax(torch.where(new, i, 0), 0).values
        opens = (i - colstart) % BUILD_TARGETS == 0
        b = torch.cumsum(opens, 0) - 1
        first.index_copy_(0, torch.where(opens, b, nb + 1), i)
    blocks = torch.stack([first[:nb], first[1:nb + 1]], dim=1)
    order = torch.argsort(blocks[:, 0] - blocks[:, 1], stable=True)
    return blocks[order].to(torch.int32)


def walk_candidates(grid: PairGrid, walk: Walk):
    """Filled slots the walk tests, a () int64 tensor on the walk's device.
    Every QEq list entry is one of them, and they depend on the slot map
    alone, so their count bounds the list of every solve over that map:
    it is the capacity the list's layout asks (walk.qstart[-1])."""
    return _target_candidates(grid, walk.tslot, walk.cell_start).sum()


def qeq_build_plain(grid: PairGrid, walk: Walk, planes, fn: PairFn, own,
                    nown: int, cap: int = None, chunk: int = None) -> QeqList:
    """The QEq build kernel's function in plain PyTorch: per target, the
    walk's pairs that pass every gate, in the walk's order, each with its
    hessian element cclmb_qeq * tap(r) * (r^3 + gamma^-3)^(-1/3) and its
    source's owner, flagged (~owner) when the source is an image, placed
    from the target's offset `walk.qstart[i]` on.  planes: (5, nslots) x,
    y, z, type, is_primary; own: (nslots,) integer owner of each slot, the
    row of the (nown, 2) state the list is applied to.  With `cap` the
    list has that fixed capacity (QeqList), records past the rows' entries
    0; without, the candidates' total (walk.qstart[-1], a host read)."""
    chunk = chunk or _chunk(planes.device)
    dev = planes.device
    idt = _REC_INT[planes.dtype]
    i, tsl, src = walk_pairs_plain(grid, walk, planes[:3], fn.rc2, chunk)
    per = max(1, chunk // 16)
    ok, h = (torch.cat(x) for x in zip(*[
        _qeq_hessian(fn, planes[:, tsl[p0:p0 + per]],
                     planes[:, src[p0:p0 + per]])
        for p0 in range(0, src.shape[0], per)] or [
        (torch.zeros(0, dtype=torch.bool, device=dev),
         planes.new_zeros(0))]))
    i, src, h = i[ok], src[ok], h[ok]
    o = own[src].to(idt)
    code = torch.where(planes[4, src] > 0.5, o, ~o)
    count = torch.bincount(i, minlength=walk.tslot.shape[0])
    # the k-th entry of target i (the pairs come in walk order) at
    # qstart[i] + k; those at or past the capacity to a dump record
    first = torch.cumsum(count, 0) - count
    dest = (walk.qstart[:-1].long()[i] - first[i]
            + torch.arange(i.shape[0], device=dev))
    cap = int(walk.qstart[-1]) if cap is None else cap
    rec = torch.zeros((cap + 1, 2), dtype=idt, device=dev)
    rec.index_copy_(0, torch.clamp(dest, max=cap),
                    torch.stack([code, h.view(idt)], dim=1))
    return QeqList(start=walk.qstart[:-1], count=count.to(torch.int32),
                   rec=rec[:cap], nown=nown, need=walk.qstart[-1])


def qeq_apply_plain(lst: QeqList, walk: Walk, X, q=None):
    """The QEq apply kernel's function in plain PyTorch: (3, walk.nrows)
    rows sum h*X[o, 0], sum h*X[o, 1] and sum h*w*q[o] over each target's
    entries (o the source's owner, w 1 for a primary source and 0.5 for an
    image; without q that row is 0), entries past the list's capacity left
    out; rows no target writes are 0.  X: (nown, 2), q: (nown,) or None.
    No host read."""
    out = torch.zeros((3, walk.nrows), dtype=X.dtype, device=X.device)
    if walk.tslot.shape[0] == 0:
        return out
    # each record's row: the last target starting at or before it; a
    # record is live if it lies within that target's entries (the gaps
    # between the rows and the capacity's padding may hold anything)
    e = torch.arange(lst.rec.shape[0], device=X.device, dtype=torch.int32)
    row = torch.searchsorted(lst.start, e, right=True) - 1
    rowc = row.clamp(min=0)
    live = (row >= 0) & (e < lst.start[rowc] + lst.count[rowc])
    code = torch.where(live, lst.code, 0).to(torch.int64)
    prim = code >= 0
    o = torch.where(prim, code, ~code)
    h = torch.where(live, lst.h, 0.0)
    est = (torch.zeros_like(h) if q is None
           else h * torch.where(prim, q[o], 0.5 * q[o]))
    vals = torch.stack([h * X[o, 0], h * X[o, 1], est])
    return out.index_add_(1, walk.trow.to(torch.int64)[rowc], vals)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/pairsweep.cu), built with nvcc at first use
# ---------------------------------------------------------------------------

_SRC = native.source("pairsweep.cu")


@functools.cache
def _library():
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    walk = [vp] * 8 + [ci] * 6 + [cf]
    return native.load(
        _SRC, "pairsweep_error_string",
        pairsweep_nonbond=walk + [vp, vp, ci] + [cf] * 3 + [vp],
        pairsweep_qeq_build=(walk + [ci] + [vp] * 3 + [ci, ci] + [vp] * 2
                             + [ci, cf, vp]),
        pairsweep_qeq_apply=[vp] * 7 + [ci] * 3 + [vp],
        pairsweep_qeq_build_occupancy=[ci] * 4 + [vp] * 3)


_tables = {}


def _device_tables(grid: PairGrid, device):
    """Per stencil column its slot offset and z-reach (int32 on device)."""
    key = (grid, device)
    if key not in _tables:
        _tables[key] = (
            torch.as_tensor(_target_tables(grid)[1], device=device),
            torch.as_tensor(_reach_table(grid), device=device))
    return _tables[key]


def _walk_args(grid: PairGrid, walk: Walk, planes, fn: PairFn, K: int):
    """Check a walk kernel's inputs; its leading ctypes arguments."""
    dev = planes.device
    T = walk.tslot.shape[0]
    nso = fn.table.shape[0]
    native.check(f"{fn.name} planes", planes, torch.float32,
                 (K, grid.nslots), dev)
    for what, t, shape in (("walk.tslot", walk.tslot, (T,)),
                           ("walk.trow", walk.trow, (T,)),
                           ("walk.cell_start", walk.cell_start,
                            (grid.nslots // grid.ccap + 1,)),
                           ("walk.slots", walk.slots,
                            (walk.slots.shape[0],))):
        native.check(what, t, torch.int32, shape, dev)
    native.check(f"{fn.name} table", fn.table, torch.float32,
                 (nso, nso, fn.table.shape[2]), dev)
    native.check(f"{fn.name} ctap", fn.ctap, torch.float32, (8,), dev)
    coloffs, zr = _device_tables(grid, dev)
    return (planes.data_ptr(), walk.tslot.data_ptr(), coloffs.data_ptr(),
            zr.data_ptr(), walk.cell_start.data_ptr(), walk.slots.data_ptr(),
            fn.table.data_ptr(), fn.ctap.data_ptr(), T, len(grid.cols),
            grid.nc[2] * grid.ccap,
            grid.ccap.bit_length() - 1, nso, grid.nslots, fn.rc2)


def nonbond(grid: PairGrid, walk: Walk, planes, fn: PairFn):
    """(11, walk.nrows) nonbond rows of the walk's targets: the CUDA kernel
    for a CUDA tensor (or raises), `nonbond_plain` for a CPU tensor."""
    if native.device_kind(planes, "nonbond") == "cpu":
        return nonbond_plain(grid, walk, planes, fn)
    args = _walk_args(grid, walk, planes, fn, 6)
    T = walk.tslot.shape[0]
    new = torch.zeros if T < walk.nrows else torch.empty
    out = new((11, walk.nrows), dtype=torch.float32, device=planes.device)
    if T:
        _library().pairsweep_nonbond(
            *args, walk.trow.data_ptr(), out.data_ptr(), walk.nrows,
            fn.pvdW1h, fn.pvdW1inv, units.CCLMB0,
            native.stream(planes.device))
        launches["nonbond"] += 1
    return out


def qeq_build(grid: PairGrid, walk: Walk, planes, fn: PairFn, own,
              nown: int, cap: int = None) -> QeqList:
    """The QEq hessian list of the walk (once per QEq solve): the CUDA
    kernel for a CUDA tensor (or raises), `qeq_build_plain` for a CPU
    tensor.  One launch walks each target's window once, writing its
    entries from its offset `walk.qstart[i]` on, up to `cap` records, and
    its count; `need` is walk.qstart[-1] (QeqList): no host read.  Without
    `cap` the host reads that total and the list holds exactly it."""
    if native.device_kind(planes, "qeq_build") == "cpu":
        return qeq_build_plain(grid, walk, planes, fn, own, nown, cap)
    dev = planes.device
    args = _walk_args(grid, walk, planes, fn, 5)
    native.check("own", own, torch.int32, (grid.nslots,), dev)
    T = walk.tslot.shape[0]
    native.check("walk.qstart", walk.qstart, torch.int32, (T + 1,), dev)
    native.check("walk.qblocks", walk.qblocks, torch.int32,
                 (walk.qblocks.shape[0], 2), dev)
    if cap is None:
        cap = int(walk.qstart[-1])
    rec = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    count = torch.zeros(T, dtype=torch.int32, device=dev)
    if T:
        _library().pairsweep_qeq_build(
            *args, grid.zreach, own.data_ptr(), walk.qstart.data_ptr(),
            walk.qblocks.data_ptr(), walk.qblocks.shape[0],
            BUILD_TARGETS, rec.data_ptr(), count.data_ptr(), cap,
            units.CCLMB0_QEQ, native.stream(dev))
        launches["qeq_build"] += 1
    return QeqList(start=walk.qstart[:-1], count=count, rec=rec, nown=nown,
                   need=walk.qstart[-1])


def qeq_build_occupancy(grid: PairGrid, fn: PairFn):
    """(blocks resident an SM, threads a block, shared memory bytes a
    block) of the QEq build kernel on the current card for this grid."""
    out = [ctypes.c_int() for _ in range(3)]
    _library().pairsweep_qeq_build_occupancy(
        fn.table.shape[0], len(grid.cols), grid.zreach,
        grid.ccap.bit_length() - 1, *(ctypes.byref(x) for x in out))
    return tuple(x.value for x in out)


def qeq_apply(lst: QeqList, walk: Walk, X, q=None):
    """(3, walk.nrows) rows H·X[:, 0], H·X[:, 1] and the Est pair sum from
    the list (once per CG matvec): the CUDA kernel for a CUDA tensor (or
    raises), `qeq_apply_plain` for a CPU tensor.  X is the CG's (nown, 2)
    state itself, contiguous (row stride 2, column stride 1), each source's
    pair read as one 8-byte gather; q an (nown,) vector, or None, which
    skips its gather and leaves the Est row 0 (the CG's gradient)."""
    if native.device_kind(X, "qeq_apply") == "cpu":
        return qeq_apply_plain(lst, walk, X, q)
    dev = X.device
    T = walk.tslot.shape[0]
    for what, t, dtype, shape in (
            ("X", X, torch.float32, (lst.nown, 2)),
            ("list start", lst.start, torch.int32, (T,)),
            ("list count", lst.count, torch.int32, (T,)),
            ("list rec", lst.rec, torch.int32, (lst.rec.shape[0], 2)),
            ("walk.trow", walk.trow, torch.int32, (T,)),
            *([] if q is None else [("q", q, torch.float32, (lst.nown,))])):
        native.check(what, t, dtype, shape, dev)
    if X.data_ptr() % 8:
        raise ValueError("X: takes an (n, 2) state aligned to 8 bytes")
    new = torch.zeros if T < walk.nrows else torch.empty
    out = new((3, walk.nrows), dtype=torch.float32, device=dev)
    if T:
        _library().pairsweep_qeq_apply(
            lst.start.data_ptr(), lst.count.data_ptr(), lst.rec.data_ptr(),
            walk.trow.data_ptr(), X.data_ptr(),
            None if q is None else q.data_ptr(), out.data_ptr(), T,
            walk.nrows, lst.rec.shape[0], native.stream(dev))
        launches["qeq_apply"] += 1
    return out
