"""Cell-column nonbonded pair sweeps (counterpart of rxmd_tpu.ops.pairsweep).

Atoms (owned + periodic images) are binned into a cell grid and packed
into a fixed-capacity SLOT layout, z-fastest, so one (cx, cy) column of
cells is contiguous.  For each block of C target slots a sweep walks the
pruned 2-D column stencil; each column's candidates are one contiguous
z-window of slots.  Pair outputs accumulate on the target row only (no
scatter, no atomics).  Padded slots carry FAR coordinates and fail every
cutoff.

Two pair bodies ride the sweep: the closed-form vdW + Coulomb
energy/force/virial sweep (once per MD step) and the QEq hessian matvec +
Est sweep (once per CG iteration).  `sweep` runs the hand-written CUDA
kernel of csrc/pairsweep.cu for a CUDA tensor and `sweep_plain`, the same
function in plain PyTorch, for a CPU tensor.

Window rule.  The TPU kernel rounds each window start down to 128 lanes
(a Mosaic alignment rule) and carries W = wslots slots.  Here a window is
the exact reach of the target block, Wp = (block_zc + 2*zreach)*ccap
slots from nb + (zb_lo - zreach + zb*block_zc)*ccap, clamped into its
column; `sweep_plain` narrows it per target to the target's own z-cell
+- zreach cells.  Every pair within rctap is a candidate under all three
rules (the extra candidates lie beyond the reach), and no slot appears
twice.
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

# launches of each CUDA kernel, counted by `sweep` where it launches one
launches = {"nonbond": 0, "qeq": 0}


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
    def Wp(self) -> int:
        """Exact window of a target block: its z-cells plus the reach."""
        return (self.block_zc + 2 * self.zreach) * self.ccap

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


def bin_slots(pose, valid, grid: PairGrid, n: int) -> SlotMap:
    """Assign extended atoms to slots (stable sort by cell id, fixed
    capacity) — the cell-binning analog of LINKEDLIST (ref:
    main.F90:277-318), built on the rebuild cadence."""
    m = pose.shape[0]
    dev = pose.device
    nc = np.array(grid.nc)
    ctot = int(np.prod(nc))
    ccap = grid.ccap
    lo = torch.as_tensor(grid.lo, dtype=pose.dtype, device=dev)
    cs = torch.as_tensor(grid.cellsize, dtype=pose.dtype, device=dev)
    rel = (pose - lo) / cs
    nc_f = torch.as_tensor(nc, dtype=pose.dtype, device=dev)
    inside = valid & ((rel >= 0) & (rel < nc_f)).all(dim=1)
    cid3 = torch.minimum(rel.to(torch.int64).clamp(min=0),
                         torch.as_tensor(nc - 1, device=dev))
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
    return SlotMap(slot_src=slot_src[:-1], slot_of_atom=slot_of_atom[:-1],
                   overflow=overflow)


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


# ---------------------------------------------------------------------------
# pair functions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PairFn:
    """One pair body of the sweep: its name (the CUDA entry), the packed
    planes K it reads, its output rows, its type-pair table (nso, nso, P)
    and taper coefficients, and its scalar constants."""
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
    dr2 = torch.sum(d * d, dim=0)
    nso = fn.table.shape[0]
    ti = r[3].to(torch.int64).clamp(0, nso - 1)
    tj = s[3].to(torch.int64).clamp(0, nso - 1)
    prm = fn.table[ti, tj]                                   # (P, npar)
    ok = (dr2 <= fn.rc2) & (dr2 > 1e-6) & (prm[:, 0] > 0.5)
    dr2s = torch.where(ok, dr2, 1.0)
    dr1 = torch.sqrt(dr2s)
    tap, dtap = _taper(dr2s, dr1, fn.ctap)
    return d, ok, dr2s, dr1, tap, dtap, prm


def _qeq_weights_of(fn: PairFn, r, s):
    """The QEq body's pair weights (2, P): the hessian element and the
    hessian times the Est weight; its rows are these times the source's
    hs, ht and q."""
    _, ok, dr2s, dr1, tap, _, prm = _pair_geometry(fn, r, s)
    gamij = torch.where(ok, prm[:, 1], 1.0)
    hess = units.CCLMB0_QEQ * tap * (dr1 * dr2s + gamij) ** (-1.0 / 3.0)
    hess = torch.where(ok, hess, 0.0)
    estw = torch.where(s[4] > 0.5, 1.0, 0.5)
    return torch.stack([hess, hess * estw])


def _pair_terms(fn: PairFn, r, s):
    """Per-pair output rows (out_k, P) of `fn` for target planes r (K, P)
    and source planes s (K, P); pairs that fail a gate contribute 0."""
    if fn.name == "qeq":
        w = _qeq_weights_of(fn, r, s)
        return w[[0, 0, 1]] * s[5:8]
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


# the plain sweep's last pair list per (grid, rc2, device), with the
# position and type planes and the target rows it came from (see
# _pair_list); clear it to time the whole plain sweep
plain_pairs = {}


def _same_rows(a, b):
    if a is None or b is None:
        return a is b
    return a.shape == b.shape and torch.equal(a, b)


def _pair_list(grid: PairGrid, packed, rc2: float, chunk: int, rows=None):
    """(target index, target slot, source slot) of every pair of filled
    slots within rc2, for the filled targets among `rows` (all targets if
    None).  Each filled target slot takes, per stencil column, the filled
    slots of its own z-cell +- zreach cells, where every partner within the
    cutoff lies.  The last list per (grid, rc2, device) is kept with the
    position and type planes and the rows it came from: a CG solve sweeps
    the same positions once per iteration."""
    dev = packed.device
    key = (grid, rc2, dev)
    hit = plain_pairs.get(key)
    if (hit is not None and _same_rows(hit[1], rows)
            and torch.equal(hit[0], packed[:4])):
        return hit[2]
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
        d = packed[:3, ts[sl], None] - packed[:3][:, cand.clamp(min=0)]
        dr2 = torch.sum(d * d, dim=0)
        bi, ci = torch.nonzero((cand >= 0) & (dr2 <= rc2) & (dr2 > 1e-6),
                               as_tuple=True)
        parts.append((real[sl][bi], ts[sl][bi], cand[bi, ci]))
    pairs = tuple(torch.cat(x) for x in zip(*parts)) if parts else (
        torch.zeros(0, dtype=torch.int64, device=dev),) * 3
    plain_pairs[key] = (packed[:4].clone(), rows, pairs)
    return pairs


# the QEq pair weights (hessian, hessian x Est weight) of the last pair list
# per (grid, rc2, device), with the list and constants they came from
plain_qeq_weights = {}


def _qeq_weights(grid: PairGrid, packed, fn: PairFn, pairs, per: int):
    """`_qeq_weights_of` on `pairs`.  They depend on nothing but the
    position and type planes that key the pair list, so a CG solve
    computes them once and reuses them every iteration."""
    key = (grid, fn.rc2, packed.device)
    hit = plain_qeq_weights.get(key)
    if (hit is not None and hit[0] is pairs and hit[1] is fn.table
            and hit[2] is fn.ctap):
        return hit[3]
    _, tsl, src = pairs
    w = torch.cat([_qeq_weights_of(fn, packed[:5, tsl[p0:p0 + per]],
                                   packed[:5, src[p0:p0 + per]])
                   for p0 in range(0, tsl.shape[0], per)]
                  or [packed.new_zeros((2, 0))], dim=1)
    plain_qeq_weights[key] = (pairs, fn.table, fn.ctap, w)
    return w


def sweep_plain(grid: PairGrid, packed, fn: PairFn, rows=None,
                chunk: int = None):
    """The sweep in plain PyTorch: the kernel's function on the same slot
    layout, output (out_k, n_targets), any float dtype.  With `rows` (a
    tensor of target indices) only those targets' rows are computed, each
    exactly as without it, and the other rows are 0.

    Padded slots contribute exactly zero in the kernel (FAR coordinates
    fail the cutoff), so only the pairs of filled slots within the cutoff
    (`_pair_list`) reach the pair function, in chunks; the QEq body's
    pair weights are kept per pair list (`_qeq_weights`)."""
    dev = packed.device
    if chunk is None:
        chunk = 1 << (25 if dev.type == "cuda" else 22)
    pairs = _pair_list(grid, packed, fn.rc2, chunk, rows)
    tgt, tsl, src = pairs
    out = torch.zeros((fn.out_k, grid.n_targets), dtype=packed.dtype,
                      device=dev)
    per = max(1, chunk // 16)
    if fn.name == "qeq":
        w = _qeq_weights(grid, packed, fn, pairs, per)
        for p0 in range(0, tgt.shape[0], per):
            sl = slice(p0, p0 + per)
            vals = w[[0, 0, 1], sl] * packed[5:8, src[sl]]
            out.index_add_(1, tgt[sl], vals)
        return out
    for p0 in range(0, tgt.shape[0], per):
        sl = slice(p0, p0 + per)
        vals = _pair_terms(fn, packed[:, tsl[sl]], packed[:, src[sl]])
        out.index_add_(1, tgt[sl], vals)
    return out


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


def build(force: bool = False):
    """Compile csrc/pairsweep.cu into build/rxmd_tpu_torch (keyed by a hash
    of the source and flags) unless that library exists or `force`; returns
    its path and the seconds spent compiling (0.0 when it was already
    built)."""
    with open(_SRC, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join(_NVCC_FLAGS).encode())
    so = os.path.join(_BUILD_DIR, f"libpairsweep_{key.hexdigest()[:16]}.so")
    if os.path.exists(so) and not force:
        return so, 0.0
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


def _library():
    global _lib
    if _lib is None:
        so, _ = build()
        lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        geom = [ci] * 10
        lib.pairsweep_nonbond.argtypes = [vp] * 6 + geom + [cf] * 4 + [vp]
        lib.pairsweep_nonbond.restype = ci
        lib.pairsweep_qeq.argtypes = [vp] * 6 + geom + [cf] * 2 + [vp]
        lib.pairsweep_qeq.restype = ci
        lib.pairsweep_error_string.argtypes = [ci]
        lib.pairsweep_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_tables = {}


def _device_tables(grid: PairGrid, device):
    key = (grid, device)
    if key not in _tables:
        col_base, coloffs = _target_tables(grid)
        _tables[key] = (torch.as_tensor(col_base, device=device),
                        torch.as_tensor(coloffs, device=device))
    return _tables[key]


def _launch(grid: PairGrid, packed, fn: PairFn):
    K, nslots = packed.shape
    if (packed.dtype != torch.float32 or not packed.is_contiguous()
            or K != fn.K or nslots != grid.nslots):
        raise ValueError(
            f"{fn.name} sweep takes a contiguous float32 ({fn.K}, "
            f"{grid.nslots}) tensor, got {packed.dtype} {tuple(packed.shape)}")
    nso = fn.table.shape[0]
    for t, shape in ((fn.table, (nso, nso, fn.table.shape[2])),
                     (fn.ctap, (8,))):
        if (t.device != packed.device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{fn.name} sweep constants must be contiguous "
                             f"float32 {shape} on {packed.device}")
    if grid.C != 128:
        raise ValueError(f"the sweep kernel runs 128-slot blocks, not "
                         f"{grid.C}")
    lib = _library()
    col_base, coloffs = _device_tables(grid, packed.device)
    out = torch.empty((fn.out_k, grid.n_targets), dtype=torch.float32,
                      device=packed.device)
    npc = grid.tc_n[0] * grid.tc_n[1]
    nzc = grid.nc[2] * grid.ccap
    geom = (npc, grid.n_zb, len(grid.cols), grid.C, grid.Wp, nzc,
            (grid.zb_lo - grid.zreach) * grid.ccap, grid.zb_lo * grid.ccap,
            nso, grid.nslots)
    ptrs = (packed.data_ptr(), col_base.data_ptr(), coloffs.data_ptr(),
            fn.table.data_ptr(), fn.ctap.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    if fn.name == "nonbond":
        err = lib.pairsweep_nonbond(*ptrs, *geom, fn.rc2, fn.pvdW1h,
                                    fn.pvdW1inv, units.CCLMB0, stream)
    else:
        err = lib.pairsweep_qeq(*ptrs, *geom, fn.rc2, units.CCLMB0_QEQ,
                                stream)
    if err != 0:
        raise RuntimeError(f"{fn.name} sweep launch failed: "
                           f"{lib.pairsweep_error_string(err).decode()}")
    launches[fn.name] += 1
    return out


def sweep(grid: PairGrid, packed, fn: PairFn, rows=None):
    """Run one sweep: (out_k, n_targets) where target t = (column p,
    z-block zb, slot c) maps to slot col_base[p] + (zb_lo + zb*block_zc)*
    ccap + c.  A CUDA tensor goes through the CUDA kernel (or raises),
    which computes every target; a CPU tensor through `sweep_plain`, which
    computes only `rows` when given (the targets the caller reads)."""
    if packed.device.type == "cuda":
        return _launch(grid, packed, fn)
    if packed.device.type == "cpu":
        return sweep_plain(grid, packed, fn, rows)
    raise ValueError(f"no pair sweep for device {packed.device}")
