"""The benchmark's plain reference: ReaxFF with QEq charges, from positions,
types and a box alone.

`reax`, `neighbors`, `ffield`, `units`, `qeq` and `system` beside this file
are frozen copies of the port's plain CPU path (rxmd_tpu_torch at the commit
that added this benchmark), adapted to import nothing of the port: PQEq is
left out.  Here they run without the port's speed machinery: neighbor lists
at the exact cutoffs (no Verlet skin), the angle, torsion and hydrogen-bond
lists enumerated exactly in every call (no cached lists), the QEq hessian
over the nonbonded list (no pair sweep, no dense fold), the closed-form
nonbond and QEq kernels that the port's float32 path states, and a full CG
to a relative Est change of QEQ_TOL.  Everything the port derives from a
state (lists, bond orders, charges, energies, forces) is worked out again
from (positions, types, box).

`dtype` is the precision the reference computes in: float64 judges the port;
bfloat16 is the control (the same reference in the precision below the
configuration's float32), which the checks have to fail.

A deck of more than `max_atoms` atoms does not fit one pass on a card, so
its energy and forces are worked out in spatial blocks: each block's atoms
(the residents) with every atom or periodic image within `halo` of the
block (the ghosts), whose rows are real positions (an identity image, as a
domain of the sharded engine holds them).  The ghosts carry bonded lists,
the residents also nonbonded ones; a block's terms are those its
residents center, under the same global-id rules that count each term
once, so the blocks' energies and forces add up to the whole deck's.  Its
charges come from one CG over the whole deck, its lists in passes of
`LIST_ROWS` rows.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from . import ffield, neighbors, qeq, reax, units
from .system import box_matrix, read_geninit_xyz, replicate

# the reference's CG stop: a relative change of Est under 1e-12 (float32
# stops at its floor, 20 ulp = 2.4e-6), capped far above what it takes
QEQ_TOL = 1e-12
QEQ_NMAX = 3000

# In float64 on one H100 a 32,256-atom deck peaked at 12.8 GiB building
# its lists and 18.8 GiB in its energy and forces, both in proportion to
# its atoms: a deck above MAX_ATOMS is evaluated in blocks of at most
# BLOCK_ROWS rows (residents and ghosts), its lists in passes of
# LIST_ROWS rows; so 258,048 atoms peaked at 23.8 GiB.
MAX_ATOMS = 32768
BLOCK_ROWS = 49152
LIST_ROWS = 16384


def load_deck(cell_path, ffield_path, mc):
    """(ForceField, positions (n, 3) [A], types (n,), H (3, 3)): the cell
    file replicated `mc`, in float64 numpy."""
    ff = ffield.parse_ffield(ffield_path)
    frac, types, cell = read_geninit_xyz(cell_path, ff.name_to_type)
    frac, types, cell = replicate(frac, types, cell, mc)
    H = box_matrix(*cell)
    return ff, frac @ H.T, types, H


def block_counts(L, n, halo, rows):
    """Blocks per axis of an orthogonal box of sides L holding n atoms:
    the fewest, split along the longest block side first, whose rows (a
    block's atoms and those within `halo` of it, at the deck's mean
    density) stay within `rows`."""
    L = np.asarray(L, dtype=np.float64)
    b = np.ones(3, dtype=np.int64)
    rho = n / np.prod(L)
    while rho * np.prod(L / b + 2.0 * halo) > rows:
        b[np.argmax(L / b)] += 1
    return tuple(int(k) for k in b)


def _caps(tc):
    """The per-call enumerations' capacities from reax.term_counts."""
    return {"ks": tc["degmax"] + 2, "kh": tc["h_slots"] + 1,
            "hb": max(tc["hb"], 1)}


class Evaluator:
    """ReaxFF + QEq of one deck's types and box in `dtype` on `device`;
    above `max_atoms` atoms (an orthogonal box) in blocks of at most
    `block_rows` rows (module docstring)."""

    def __init__(self, ff, types, H, dtype=torch.float64, device="cpu",
                 max_atoms=MAX_ATOMS, block_rows=BLOCK_ROWS):
        self.ff = ff
        self.dtype = dtype
        self.device = torch.device(device)
        self.n = len(types)
        self.types = torch.as_tensor(np.asarray(types), dtype=torch.int64,
                                     device=self.device)
        self.gid = torch.arange(self.n, device=self.device)
        self.H_np = np.asarray(H, dtype=np.float64)
        self.H = torch.as_tensor(self.H_np, dtype=dtype, device=self.device)
        self.ffd = reax.ffdev_from(ff, dtype=dtype, rctap=units.RCTAP0,
                                   device=self.device)
        orth = np.allclose(self.H_np, np.diag(np.diag(self.H_np)))
        self.maxrc = ffield.effective_maxrc(ff, np.asarray(types))
        self.blocks = None
        reach = units.RCTAP0
        if self.n > max_atoms:
            if not orth:
                raise NotImplementedError(
                    f"{self.n} atoms take blocks, which need an orthogonal "
                    "box")
            # a resident's energy reads positions out to three bonded
            # layers (its bond orders' corrections read their atoms'
            # neighbors), its pair terms out to the taper cutoff
            self.halo = max(3.0 * self.maxrc, units.RCTAP0) + 0.1
            self.blocks = block_counts(np.diag(self.H_np), self.n,
                                       self.halo, block_rows)
            reach = self.halo
        nimg = neighbors.nimg_for_cutoff(self.H_np, reach)
        self.img = neighbors.make_image_table(self.n, nimg, dtype,
                                              self.device)
        self.grid = None
        if self.n >= 400 and orth:
            L = np.diag(self.H_np)
            nim = np.asarray(nimg)
            self.grid = neighbors.make_cell_grid(
                -nim * L, (1.0 + nim) * L, max(self.maxrc, 2.0),
                units.RCTAP0)

    def _wrap(self, pos):
        """Positions wrapped into the box (fractional coordinates mod 1)."""
        frac = pos @ torch.linalg.inv(self.H.double()).T.to(pos.dtype)
        return (frac - torch.floor(frac)) @ self.H.T

    def _cells(self, pose, ext_types, grid, kb, knb, nrows, nb_rows=None,
               row_block=None):
        """The cell-list build over real positions `pose` (every row
        live), its cells as deep as the densest cell."""
        valid = torch.ones(pose.shape[0], dtype=torch.bool,
                           device=pose.device)
        occ = int(neighbors._cell_table_packed(pose, valid, ext_types,
                                               grid)[3])
        grid = grid._replace(ccap=max(grid.ccap, occ))
        nbrs, _ = neighbors.build_neighbors_cells(
            pose, valid, ext_types, grid, self.ffd.rc2b, self.ffd.rctap2,
            kb, knb, nrows=nrows, nb_rows=nb_rows, row_block=row_block)
        return nbrs

    def _build(self, pos, kb, knb):
        if self.grid is None:
            return neighbors.build_neighbors_brute(
                pos, self.H, self.types, self.img, self.ffd.rc2b,
                self.ffd.rctap2, kb, knb)
        pose = neighbors.ext_positions(pos, self.H, self.img)
        return self._cells(pose, self.types[self.img.owner], self.grid, kb,
                           knb, self.n, row_block=None if self.blocks is None
                           else LIST_ROWS)

    @staticmethod
    def _trimmed(build):
        """build(kb, knb) at each row's capacity the largest row's count."""
        probe = build(48, 2048)
        mb, mnb = neighbors.check_overflow(probe)
        return build(max(int(mb), 1), max(int(mnb), 1))

    def neighbor_lists(self, pos):
        """The bonded and nonbonded lists at the exact cutoffs, each row's
        capacity the largest row's count."""
        return self._trimmed(lambda kb, knb: self._build(pos, kb, knb))

    @torch.no_grad()
    def evaluate(self, pos, isqeq=1, qsfp=None, lex_fqs=1.0):
        """dict(q, comps, force, bo_sum, qeq_iters) at positions `pos`
        ((n, 3) float64 numpy): charges by a full CG (isqeq=1) or by the
        extended Lagrangian's one iteration from `qsfp` (isqeq=2), the
        (14,) PE components in the port's slot order (0 total, 1 Ebond, 2
        Elp, 3 Eover, 4 Eunder, 5 Eval, 6 Epen, 7 Ecoa, 8 Etors, 9 Econj,
        10 Ehb, 11 Evdw, 12 Eclmb, 13 Echarge), the forces and each atom's
        summed bond order; float64 numpy."""
        t = self._t
        x = self._wrap(t(pos))
        nbrs = self.neighbor_lists(x)
        if self.blocks is None:
            tc = reax.term_counts(x, self.H, self.types, self.gid, self.img,
                                  nbrs, self.ffd)
        zeros = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        res = qeq.solve(x, zeros, zeros if qsfp is None else t(qsfp),
                        self.types, self.ffd, isqeq=isqeq,
                        nmax=QEQ_NMAX if isqeq == 1 else 1, tol=QEQ_TOL,
                        lex_fqs=lex_fqs, H=self.H, img=self.img, nbrs=nbrs,
                        closed_form=True, dense_max=0)
        if self.blocks is None:
            comps, f = reax.energy_and_forces(
                x, res.q, self.H, self.types, self.gid, self.img, nbrs,
                self.ffd, lists=None, caps=_caps(tc), closed_form=True)
            bo_sum = self._bo_sum(x, nbrs)
        else:
            bo_sum = self._bo_sum(x, nbrs)
            del nbrs
            comps, f = self._blocked(x, res.q)
        host = self._host
        return dict(q=host(res.q), comps=host(comps), force=host(f),
                    bo_sum=host(bo_sum), qeq_iters=int(res.iters))

    def _bo_sum(self, x, nbrs):
        bo = reax.bond_order(x, self.H, self.types, self.img, nbrs, self.ffd)
        bo0 = bo.bo[..., 0]
        return torch.where(bo.mask & (bo0 > 0), bo0, 0.0).sum(dim=1)

    def _blocked(self, x, q):
        """(PE components, forces) of wrapped positions `x` with charges
        `q`, summed over the blocks (module docstring)."""
        L = np.diag(self.H_np)
        b = np.asarray(self.blocks)
        pose = neighbors.ext_positions(x, self.H, self.img)
        owner = self.img.owner
        comps = torch.zeros(14, dtype=self.dtype, device=self.device)
        f = torch.zeros_like(x)
        inside = lambda p, lo, hi: ((p >= self._t(lo))
                                    & (p < self._t(hi))).all(dim=1)
        for cell in itertools.product(*(range(k) for k in self.blocks)):
            lo, hi = L * np.asarray(cell) / b, L * (np.asarray(cell) + 1) / b
            # the last block on an axis also takes an atom that rounding
            # put at the box's upper face
            top = np.where(np.asarray(cell) == b - 1, np.inf, hi)
            res = torch.nonzero(inside(x, lo, top)).flatten()
            near = inside(pose, lo - self.halo, hi + self.halo)
            near[res] = False       # ext rows < n: the atoms, zero shift
            sub = torch.cat([res, torch.nonzero(near).flatten()])
            cb, fb = self._block(pose[sub], owner[sub], res.shape[0],
                                 lo - self.halo, hi + self.halo, q)
            comps = comps + cb
            f.index_add_(0, owner[sub], fb)
        return comps, f

    def _block(self, p, own, nr, lo, hi, q):
        """(PE components of the first `nr` rows' terms, forces on every
        row) of the rows at real positions `p` (inside [lo, hi)), atoms
        `own`: the residents, then the ghosts."""
        m = p.shape[0]
        img = neighbors.ImageTable(
            owner=torch.arange(m, device=self.device),
            shift=torch.zeros((m, 3), dtype=self.dtype, device=self.device),
            nimg=(0, 0, 0))
        ty, g, qs = self.types[own], self.gid[own], q[own]
        amask = torch.arange(m, device=self.device) < nr
        grid = neighbors.make_cell_grid(lo - 1.0, hi + 1.0,
                                        max(self.maxrc, 2.0), units.RCTAP0)
        nbrs = self._trimmed(lambda kb, knb: self._cells(
            p, ty, grid, kb, knb, m, nb_rows=nr))
        tc = reax.term_counts(p, self.H, ty, g, img, nbrs, self.ffd, amask)
        ctx = reax.nb_ctx(p, qs, self.H, ty, img, nbrs, g, amask, self.ffd)
        evdw, eclmb, echarge, f_nb = reax.nonbond_ctx_energy_forces(
            ctx, qs[:nr], ty[:nr], amask[:nr], self.ffd, True, img=img)
        del ctx
        f_nb = torch.cat([f_nb, f_nb.new_zeros((m - nr, 3))])
        return reax.energy_and_forces(
            p, qs, self.H, ty, g, img, nbrs, self.ffd, lists=None,
            amask=amask, caps=_caps(tc),
            external_nonbond=(evdw, eclmb, echarge, f_nb), closed_form=True)

    # -- the integrator (ref: main.F90:45-98), in the reference's dtype --
    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _host(self, a):
        return a.double().cpu().numpy()

    def mdmode5(self, vel, treq):
        """Velocities scaled to the kinetic temperature `treq` [K] (mdmode
        5, ref: main.F90:45-61), float64 numpy."""
        m = self._t(self.ff.mass)[self.types]
        v = self._t(vel)
        ke = 0.5 * torch.sum(m * torch.sum(v * v, dim=1)) / self.n
        return self._host(torch.sqrt(treq / (ke * units.UTEMP)) * v)

    def half_step(self, pos, vel, force, dt_fs):
        """The first half kick and the drift of a velocity-Verlet step
        (ref: main.F90:64-72): (velocities, positions), float64 numpy."""
        dt = dt_fs / units.UTIME
        dthm = (0.5 * dt / self._t(self.ff.mass)[self.types])[:, None]
        v = self._t(vel) + dthm * self._t(force)
        return self._host(v), self._host(self._t(pos) + dt * v)

    def kick(self, vel, force, dt_fs):
        """The second half kick (ref: main.F90:97-98), float64 numpy."""
        dt = dt_fs / units.UTIME
        dthm = (0.5 * dt / self._t(self.ff.mass)[self.types])[:, None]
        return self._host(self._t(vel) + dthm * self._t(force))
