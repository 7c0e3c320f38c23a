"""Neighbor-list construction on fixed-shape padded tensors (counterpart of
rxmd_tpu.neighbors).

  * an *extended* atom set: the N owned atoms followed by ghost periodic
    images, described by (owner, shift) tables.  Ghost positions are
    ``pos[owner] + shift @ H.T``, so autograd carries ghost forces back to
    their owners (ref: COPYATOMS(MODE_CPBK), comm.F90:74-78).
  * fixed-capacity neighbor index tables: bonded (N, kb) within the
    per-pair sigma-bond cutoff, nonbonded (N, knb) within the taper cutoff
    (ref: main.F90:321-477).  Padding is index -1.

Scatters that JAX writes with ``mode="drop"`` and an out-of-range index
write here into one extra dump slot that is sliced off afterwards: on CUDA
an out-of-range index is a device-side assert, not a dropped update.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ImageTable(NamedTuple):
    """Mapping from extended index -> (owning atom, periodic shift)."""
    owner: torch.Tensor   # (M,) int64, m % N
    shift: torch.Tensor   # (M, 3) shift in lattice-vector units
    nimg: tuple           # images per axis

    @property
    def n_images(self) -> int:
        s = 1
        for k in self.nimg:
            s *= 2 * k + 1
        return s

    @property
    def n_own(self) -> int:
        return self.owner.shape[0] // self.n_images

    def owner_of(self, idx):
        """Owner of an extended index (owner[m] = m % N by construction)."""
        if self.n_images == 1:
            return idx
        return idx % self.n_own


def make_image_table(n: int, nimg=(1, 1, 1), dtype=torch.float64,
                     device="cpu") -> ImageTable:
    """All periodic images with |s_k| <= nimg_k; the zero shift comes first so
    ext index m < n is the owned atom m itself."""
    rng = [np.arange(-k, k + 1) for k in nimg]
    shifts = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
    order = np.argsort((shifts != 0).any(axis=1), kind="stable")
    shifts = shifts[order]
    S = shifts.shape[0]
    owner = np.tile(np.arange(n, dtype=np.int64), S)
    shift = np.repeat(shifts, n, axis=0)
    return ImageTable(torch.as_tensor(owner, device=device),
                      torch.as_tensor(shift, dtype=dtype, device=device),
                      tuple(int(k) for k in nimg))


def nimg_for_cutoff(H: np.ndarray, rcut: float) -> tuple:
    """Images per axis needed so every neighbor within rcut has a ghost
    (perpendicular distances between opposite box faces)."""
    H = np.asarray(H)
    inv = np.linalg.inv(H)
    d = 1.0 / np.linalg.norm(inv, axis=0)
    return tuple(int(np.ceil(rcut / dk)) for dk in d)


def ext_positions(pos, H, img: ImageTable):
    """Positions of the extended set; differentiable in pos."""
    return pos[img.owner] + img.shift.to(pos.dtype) @ H.T


class Neighbors(NamedTuple):
    idxb: torch.Tensor    # (N, kb) int64 ext indices, -1 padded
    cntb: torch.Tensor    # (N,) int64
    idxnb: torch.Tensor   # (N, knb) int64 ext indices, -1 padded
    cntnb: torch.Tensor   # (N,)

    @property
    def maskb(self):
        return self.idxb >= 0

    @property
    def masknb(self):
        return self.idxnb >= 0

    @property
    def center_rows(self) -> int:
        """The atoms that center per-atom work (the nonbonded list, the
        many-body terms, the charges): the first `center_rows` rows of
        every per-atom array.  All atoms on one device; a domain's
        residents in the sharded engine, whose ghosts carry bonded rows
        alone."""
        return self.idxnb.shape[0]


def _select_k(mask, k):
    """Column indices of up to k True entries per row (lowest index first),
    -1 padded; a capacity beyond the candidate width pads with -1."""
    n, C = mask.shape
    keff = min(k, C)
    pos = torch.cumsum(mask, dim=1) - 1
    sel = mask & (pos < keff)
    rows = torch.arange(n, device=mask.device)[:, None]
    dst = torch.where(sel, rows * keff + pos, n * keff)   # n*keff: dump slot
    col = torch.arange(C, device=mask.device).expand(n, C)
    idx = torch.full((n * keff + 1,), -1, dtype=torch.int64,
                     device=mask.device)
    idx.scatter_(0, dst.reshape(-1), col.reshape(-1))
    idx = idx[:-1].reshape(n, keff)
    if keff < k:
        idx = torch.nn.functional.pad(idx, (0, k - keff), value=-1)
    return idx


# candidate pairs per row block of the brute-force build: bounds its
# (rows, M, 3) difference tensor to 2^24 pairs (a triclinic 8,064-atom box
# with 27 images has 1.76e9 candidates, 21 GB of float32 differences)
BRUTE_BLOCK = 1 << 24


def build_neighbors_brute(pos, H, types, img: ImageTable, rc2_by_type,
                          rctap2, kb: int, knb: int) -> Neighbors:
    """O(N*M) all-pairs neighbor search over the extended set (below 400
    atoms and for triclinic boxes).  rc2_by_type: (nso, nso) squared
    sigma-bond cutoffs.  Rows go in blocks of as many as keep a block
    under BRUTE_BLOCK candidates; the lists do not depend on it."""
    n = pos.shape[0]
    dev = pos.device
    pose = ext_positions(pos, H, img)
    m = pose.shape[0]
    row_chunk = max(1, BRUTE_BLOCK // m)
    tj = types[img.owner]
    cols = torch.arange(m, device=dev)
    parts = []
    for r0 in range(0, n, row_chunk):
        rows = torch.arange(r0, min(n, r0 + row_chunk), device=dev)
        d = pos[rows][:, None, :] - pose[None, :, :]
        dr2 = torch.sum(d * d, dim=-1)                   # (B, M)
        del d
        not_self = rows[:, None] != cols[None, :]
        rc2_pair = rc2_by_type[types[rows][:, None], tj[None, :]]
        maskb = (dr2 < rc2_pair) & not_self              # strict <, main.F90:366
        masknb = (dr2 <= rctap2) & not_self              # <=, main.F90:458
        parts.append((_select_k(maskb, kb), maskb.sum(dim=1),
                      _select_k(masknb, knb), masknb.sum(dim=1)))
    return Neighbors(*(torch.cat(p) for p in zip(*parts)))


def tighten(pos, H, types, img: ImageTable, nbrs: Neighbors, rc2_by_type,
            rctap2, kb: int, knb: int) -> Neighbors:
    """Filter Verlet-skinned lists down to the true cutoffs and compact
    them to capacities kb, knb (lowest slot first); the counts say whether
    a row overflowed."""
    pose = ext_positions(pos, H, img)

    def shrink(idx_full, cap, within):
        mask = idx_full >= 0
        idx = torch.where(mask, idx_full, 0)
        d = pos[:, None, :] - pose[idx]
        keep = mask & within(torch.sum(d * d, dim=-1), idx)
        slot = _select_k(keep, cap)
        out = torch.where(slot >= 0,
                          torch.gather(idx, 1, slot.clamp(min=0)), -1)
        return out, keep.sum(dim=1)

    tj = types[img.owner]
    idxb, cntb = shrink(
        nbrs.idxb, kb,
        lambda dr2, ix: dr2 < rc2_by_type[types[:, None], tj[ix]])
    idxnb, cntnb = shrink(nbrs.idxnb, knb, lambda dr2, ix: dr2 <= rctap2)
    return Neighbors(idxb=idxb, cntb=cntb, idxnb=idxnb, cntnb=cntnb)


def sphere_stencil(cellsize, rcut):
    """Pruned cell-offset stencil covering a sphere of radius rcut
    (ref: GetNonbondingMesh init.F90:525-607)."""
    cellsize = np.asarray(cellsize, dtype=float)
    reach = (np.ceil(rcut / cellsize)).astype(int) + 1
    offs = []
    for i in range(-reach[0], reach[0] + 1):
        for j in range(-reach[1], reach[1] + 1):
            for k in range(-reach[2], reach[2] + 1):
                v = np.array([i, j, k], dtype=float)
                v = np.where(v > 0, v - 1, np.where(v < 0, v + 1, 0.0))
                if np.sum((v * cellsize) ** 2) <= rcut * rcut:
                    offs.append((i, j, k))
    return tuple(offs)


class CellGrid(NamedTuple):
    """Static geometry of the binning grid (host-side setup)."""
    lo: tuple            # region lower corner (3,)
    cellsize: tuple      # (3,)
    ncells: tuple        # (3,) ints
    ccap: int            # max atoms per cell
    stencil_b: tuple     # bonded stencil offsets
    stencil_nb: tuple    # nonbonded (taper) stencil offsets


def make_cell_grid(lo, hi, maxrc, rctap, density_per_A3=0.15,
                   ccap=None) -> CellGrid:
    """Size a grid over [lo, hi): cells at least maxrc wide so the bonded
    stencil is 27 cells; the nonbonded stencil is sphere-pruned."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    ext = hi - lo
    ncells = np.maximum(np.floor(ext / max(maxrc, 2.0)).astype(int), 1)
    cellsize = ext / ncells
    if ccap is None:
        ccap = max(6, int(np.ceil(np.prod(cellsize) * density_per_A3 * 1.4))
                   + 2)
    st_b = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for k in (-1, 0, 1))
    st_nb = sphere_stencil(cellsize, rctap)
    return CellGrid(lo=tuple(lo), cellsize=tuple(cellsize),
                    ncells=tuple(int(x) for x in ncells), ccap=int(ccap),
                    stencil_b=st_b, stencil_nb=st_nb)


_FAR = 1.0e4      # padded-slot coordinate: dr2 ~ 1e8 fails every cutoff

_grid_consts = {}


def grid_consts(grid: CellGrid, dtype, device):
    """The grid's constants on `device`: lo and cellsize (`dtype`), the
    cell counts, and the bonded and nonbonded stencils (int64).  Made once
    per (grid, dtype, device) and kept, so a build run again, as a CUDA
    graph's capture runs it after its eager first use, copies nothing
    from the host (a captured stream cannot).  The capacity is not part
    of them (a grid may deepen its cells)."""
    key = (grid._replace(ccap=0), dtype, torch.device(device))
    if key not in _grid_consts:
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=device)
        _grid_consts[key] = (
            t(grid.lo, dtype), t(grid.cellsize, dtype),
            t(grid.ncells, torch.int64), t(grid.stencil_b, torch.int64),
            t(grid.stencil_nb, torch.int64))
    return _grid_consts[key]


def _cell_table_packed(pos, valid, types, grid: CellGrid):
    """Cell binning with packed per-slot payloads: positions + type in a
    (ncell, ccap, 4) table (FAR sentinel in empty slots), the ext-row
    index table, each atom's cell, and the max cell occupancy."""
    m = pos.shape[0]
    dev = pos.device
    nc = np.array(grid.ncells)
    ctot = int(np.prod(nc))
    ccap = grid.ccap
    lo, cs, nc_t = grid_consts(grid, pos.dtype, dev)[:3]
    rel = (pos - lo) / cs
    cid3 = torch.floor(rel).to(torch.int64)
    cid3 = torch.minimum(cid3.clamp(min=0), nc_t - 1)
    cid = (cid3[:, 0] * nc[1] + cid3[:, 1]) * nc[2] + cid3[:, 2]
    cid = torch.where(valid, cid, ctot)
    order = torch.argsort(cid, stable=True)
    scid = cid[order]
    start = torch.searchsorted(scid, torch.arange(ctot + 1, device=dev))
    rank = torch.arange(m, device=dev) - start[scid]
    inb = (rank < ccap) & (scid < ctot)
    dst = torch.where(inb, scid * ccap + rank, ctot * ccap)  # dump slot
    payload = torch.cat([pos, types.to(pos.dtype)[:, None]], dim=1)[order]
    slot_pay = torch.full((ctot * ccap + 1, 4), _FAR, dtype=pos.dtype,
                          device=dev)
    slot_pay.index_copy_(0, dst, payload)
    slot_idx = torch.full((ctot * ccap + 1,), -1, dtype=torch.int64,
                          device=dev)
    slot_idx.index_copy_(0, dst, order)
    occ = torch.max(torch.where(scid < ctot, rank + 1, 0))
    return (slot_pay[:-1].reshape(ctot, ccap, 4),
            slot_idx[:-1].reshape(ctot, ccap), cid3, occ)


# rows of one pass of the cell-list build.  A pass holds each of its rows'
# candidates at once (S * ccap payloads, indices, distances and masks:
# ~0.4 MB a row on the RDX deck's nonbonded stencil in float32), so a
# larger list is built pass by pass into its (rows, cap) output and the
# build's transient memory stays that of one pass.  At or below it the
# build is one pass.
LIST_ROWS = 8192


def passes(rows):
    """The passes of a cell-list build over `rows` rows."""
    return max(-(-int(rows) // LIST_ROWS), 1)


def build_neighbors_cells(pos, valid, types, grid: CellGrid, rc2_by_type,
                          rctap2, kb: int, knb: int, nrows: int = None,
                          nb_rows: int = None, bond_rows=None):
    """O(M) cell-list neighbor build over an extended atom set (used from
    400 atoms).  `pos` are real coordinates inside the grid region; `valid`
    masks live entries.  Returns (Neighbors: bonded rows for the first
    `nrows` entries, nonbonded rows for the first `nb_rows` (default
    `nrows`), max cell occupancy).  With `bond_rows` (row indices, -1
    padded) only those rows get bonded lists, the others stay empty.  The
    sharded engine needs bonded rows for its ghosts near its domain too
    (their bond orders), nonbonded rows only for its residents.  Each
    list is built in passes of `LIST_ROWS` rows, row for row the same."""
    m = pos.shape[0]
    dev = pos.device
    nrows = nrows or m
    nb_rows = nb_rows or nrows
    slot_pay, slot_idx, cid3, overflow = _cell_table_packed(
        pos, valid, types, grid)
    nc = np.array(grid.ncells)
    ctot = int(np.prod(nc))
    ccap = grid.ccap
    # one empty cell appended as the out-of-bounds target
    slot_pay = torch.cat([slot_pay, torch.full((1, ccap, 4), _FAR,
                                               dtype=pos.dtype, device=dev)])
    slot_idx = torch.cat([slot_idx, torch.full((1, ccap), -1,
                                               dtype=torch.int64, device=dev)])
    _, _, nc_t, st_b, st_nb = grid_consts(grid, pos.dtype, dev)

    def lists(rows, offs, bonded, cap):
        nr = rows.shape[0]
        if nr <= LIST_ROWS:
            return one_pass(rows, offs, bonded, cap)
        idx = torch.empty((nr, cap), dtype=torch.int64, device=dev)
        cnt = torch.empty((nr,), dtype=torch.int64, device=dev)
        for r0 in range(0, nr, LIST_ROWS):
            r1 = min(nr, r0 + LIST_ROWS)
            idx[r0:r1], cnt[r0:r1] = one_pass(rows[r0:r1], offs, bonded,
                                              cap)
        return idx, cnt

    def one_pass(rows, offs, bonded, cap):
        nr = rows.shape[0]
        nb3 = cid3[rows][:, None, :] + offs[None, :, :]          # (B, S, 3)
        oob = ((nb3 < 0) | (nb3 >= nc_t)).any(dim=-1)
        nbc = (nb3[..., 0] * nc[1] + nb3[..., 1]) * nc[2] + nb3[..., 2]
        nbc = torch.where(oob, ctot, nbc)
        S = offs.shape[0]
        pay = slot_pay[nbc].reshape(nr, S * ccap, 4)
        cand = slot_idx[nbc].reshape(nr, S * ccap)
        d = pos[rows][:, None, :] - pay[..., :3]
        dr2 = torch.sum(d * d, dim=-1)
        if bonded:
            # empty slots carry the FAR type: clamp the lookup, their
            # dr2 ~ 1e8 fails the cutoff anyway
            nso = rc2_by_type.shape[0]
            tj = pay[..., 3].clamp(max=nso - 1).to(torch.int64)
            inr = dr2 < rc2_by_type[types[rows][:, None], tj]
        else:
            inr = dr2 <= rctap2
        mask = inr & (cand != rows[:, None])
        slot = _select_k(mask, cap)
        idx = torch.where(slot >= 0,
                          torch.gather(cand, 1, slot.clamp(min=0)), -1)
        return idx, mask.sum(dim=1)

    if bond_rows is None:
        idxb, cntb = lists(torch.arange(nrows, device=dev), st_b, True, kb)
    else:
        # -1 entries pad a fixed-length selection: their rows land in a
        # dump row past the end
        ok = bond_rows >= 0
        ib, cb = lists(torch.where(ok, bond_rows, 0), st_b, True, kb)
        dst = torch.where(ok, bond_rows, nrows)
        idxb = torch.full((nrows + 1, kb), -1, dtype=torch.int64, device=dev)
        idxb[dst] = ib
        cntb = torch.zeros(nrows + 1, dtype=cb.dtype, device=dev)
        cntb[dst] = cb
        idxb, cntb = idxb[:nrows], cntb[:nrows]
    idxnb, cntnb = lists(torch.arange(nb_rows, device=dev), st_nb, False,
                         knb)
    return Neighbors(idxb=idxb, cntb=cntb, idxnb=idxnb, cntnb=cntnb), overflow


def check_overflow(nbrs: Neighbors):
    """Host-side overflow check; returns (max_bonded, max_nonbonded) and
    raises if either exceeds its capacity (ref: main.F90:402-407)."""
    mb = int(nbrs.cntb.max())
    mnb = int(nbrs.cntnb.max())
    check_counts(mb, mnb, nbrs.idxb.shape[1], nbrs.idxnb.shape[1])
    return mb, mnb


def check_counts(mb, mnb, kb, knb):
    """Raise if the largest bonded row `mb` exceeds its capacity `kb`, or
    the largest nonbonded row `mnb` exceeds `knb` (counts read already)."""
    if mb > kb:
        raise RuntimeError(f"bonded neighbor overflow: {mb} > capacity {kb}")
    if mnb > knb:
        raise RuntimeError(
            f"nonbonded neighbor overflow: {mnb} > capacity {knb}")
