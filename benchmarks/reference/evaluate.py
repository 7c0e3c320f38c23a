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
"""
from __future__ import annotations

import numpy as np
import torch

from . import ffield, neighbors, qeq, reax, units
from .system import box_matrix, read_geninit_xyz, replicate

# the reference's CG stop: a relative change of Est under 1e-12 (float32
# stops at its floor, 20 ulp = 2.4e-6), capped far above what it takes
QEQ_TOL = 1e-12
QEQ_NMAX = 3000


def load_deck(cell_path, ffield_path, mc):
    """(ForceField, positions (n, 3) [A], types (n,), H (3, 3)): the cell
    file replicated `mc`, in float64 numpy."""
    ff = ffield.parse_ffield(ffield_path)
    frac, types, cell = read_geninit_xyz(cell_path, ff.name_to_type)
    frac, types, cell = replicate(frac, types, cell, mc)
    H = box_matrix(*cell)
    return ff, frac @ H.T, types, H


class Evaluator:
    """ReaxFF + QEq of one deck's types and box in `dtype` on `device`."""

    def __init__(self, ff, types, H, dtype=torch.float64, device="cpu"):
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
        nimg = neighbors.nimg_for_cutoff(self.H_np, units.RCTAP0)
        self.img = neighbors.make_image_table(self.n, nimg, dtype,
                                              self.device)
        orth = np.allclose(self.H_np, np.diag(np.diag(self.H_np)))
        self.grid = None
        if self.n >= 400 and orth:
            L = np.diag(self.H_np)
            nim = np.asarray(nimg)
            maxrc = ffield.effective_maxrc(ff, np.asarray(types))
            self.grid = neighbors.make_cell_grid(
                -nim * L, (1.0 + nim) * L, max(maxrc, 2.0), units.RCTAP0)

    def _wrap(self, pos):
        """Positions wrapped into the box (fractional coordinates mod 1)."""
        frac = pos @ torch.linalg.inv(self.H.double()).T.to(pos.dtype)
        return (frac - torch.floor(frac)) @ self.H.T

    def _build(self, pos, kb, knb):
        rc2b, rctap2 = self.ffd.rc2b, self.ffd.rctap2
        if self.grid is None:
            return neighbors.build_neighbors_brute(
                pos, self.H, self.types, self.img, rc2b, rctap2, kb, knb)
        pose = neighbors.ext_positions(pos, self.H, self.img)
        valid = torch.ones(pose.shape[0], dtype=torch.bool,
                           device=pose.device)
        ext_types = self.types[self.img.owner]
        occ = int(neighbors._cell_table_packed(pose, valid, ext_types,
                                               self.grid)[3])
        grid = self.grid._replace(ccap=max(self.grid.ccap, occ))
        nbrs, _ = neighbors.build_neighbors_cells(
            pose, valid, ext_types, grid, rc2b, rctap2, kb, knb,
            nrows=self.n)
        return nbrs

    def neighbor_lists(self, pos):
        """The bonded and nonbonded lists at the exact cutoffs, each row's
        capacity the largest row's count."""
        probe = self._build(pos, 48, 2048)
        mb, mnb = neighbors.check_overflow(probe)
        return self._build(pos, max(int(mb), 1), max(int(mnb), 1))

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
        tc = reax.term_counts(x, self.H, self.types, self.gid, self.img,
                              nbrs, self.ffd)
        caps = {"ks": tc["degmax"] + 2, "kh": tc["h_slots"] + 1,
                "hb": max(tc["hb"], 1)}
        zeros = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        res = qeq.solve(x, zeros, zeros if qsfp is None else t(qsfp),
                        self.types, self.ffd, isqeq=isqeq,
                        nmax=QEQ_NMAX if isqeq == 1 else 1, tol=QEQ_TOL,
                        lex_fqs=lex_fqs, H=self.H, img=self.img, nbrs=nbrs,
                        closed_form=True, dense_max=0)
        comps, f = reax.energy_and_forces(
            x, res.q, self.H, self.types, self.gid, self.img, nbrs, self.ffd,
            lists=None, caps=caps, closed_form=True)
        bo = reax.bond_order(x, self.H, self.types, self.img, nbrs, self.ffd)
        bo0 = bo.bo[..., 0]
        bo_sum = torch.where(bo.mask & (bo0 > 0), bo0, 0.0).sum(dim=1)
        host = self._host
        return dict(q=host(res.q), comps=host(comps), force=host(f),
                    bo_sum=host(bo_sum), qeq_iters=int(res.iters))

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
