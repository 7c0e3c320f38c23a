"""The pair engine of md.Engine, chosen once per engine (`choose`, `make`):
the nonbond and QEq pair terms over the cell-column pair sweep (`Sweep`,
"sweep": ops/pairsweep's CUDA kernels, float32 on a card; closed form,
orthogonal box, cached term lists, neither PQEq nor LG; the default
wherever it can run), the dense minimum-image forms (`Dense`, "dense") or
the pair context over the nonbonded list (`PairList`, "ell"; under PQEq,
`PQEqPairList`: pqeq.solve and reax.e_nonbond_pqeq walk the list).

qeq.solve applies a hessian operator, `hessian(eta)` -> (matvec,
matvec_est): matvec(X) = (diag(eta) + H) X for the CG's (n, 2) state,
matvec_est(Hv, q) = (matvec(Hv), per-atom Est pair sums at q), made in
the solve after its set-up.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from . import neighbors, pqeq, qeq, reax
from .ops import pairsweep


def choose(cfg, closed_form, H, n, rctap, lg, device, dtype):
    """A configuration's pair engine: where rxmd_tpu routes (md.py:248,
    272), except that pair_kernel=None takes the sweep wherever it can
    run, and pair_kernel=True where it cannot raises, naming why."""
    ortho = bool(np.allclose(H, np.diag(np.diag(H))))
    no_sweep = [name for cond, name in (
        (not closed_form, "the interpolation tables (nonbond_closed_form="
                          "False, the float64 default)"),
        (not ortho, "a triclinic box"),
        (not cfg.term_cache, "term_cache=False"),
        (cfg.tighten_lists, "tighten_lists"),
        (cfg.isPQEq, "PQEq"),
        (lg, "LG dispersion"),
    ) if cond]
    if cfg.pair_kernel is not False and not no_sweep:
        if device.type == "cuda" and dtype != torch.float32:
            raise ValueError(
                f"Engine(device='cuda', dtype={dtype}): the CUDA sweep "
                "kernels are float32; pass --dtype float32 (dtype="
                "torch.float32), or nonbond_closed_form=False for the "
                "pair-list engine, or run on the CPU")
        return "sweep"
    if cfg.pair_kernel:
        raise ValueError("pair_kernel=True: the pair sweep cannot run "
                         + ", ".join(no_sweep))
    if (closed_form and ortho and not cfg.isPQEq
            and float(np.diag(H).min()) > 2.0 * rctap
            and n <= cfg.dense_direct_max):
        return "dense"
    return "ell"


def make(eng, H):
    """The pair engine of md.Engine `eng` (H: its box as numpy)."""
    kind = PQEqPairList if eng.pq is not None else {
        "sweep": Sweep, "dense": Dense, "ell": PairList}[eng.pair_engine]
    return kind(eng, H)


class PairEngine:
    """What the engines share: no layout (what a rebuild or a probe makes
    and the steps read) nor its counts ("slots", "qeq" of md.REBUILD_COUNTS
    and md.PROBE_COUNTS), no pair data, no nonbond ((evdw, eclmb, echarge,
    f_nb, w_nb); None joins it to the bonded terms' autograd pass), a QEq
    solve over `hessian`, and `probe(run)`, where `run(layout, graph)`
    dispatches a probe (as a CUDA graph where `graph` allows) and returns
    (result, counts).  It holds md.Engine weakly: a reference cycle would
    keep the engine's device memory until a garbage collection."""

    def __init__(self, eng, H):
        self.eng = weakref.proxy(eng)

    def layout(self, pos, H, like=None):
        return None

    def counts(self, layout, data=None):
        return None

    def window(self, layout, got):
        return layout

    def capacity(self, layout):
        return None

    def check_slots(self, got):
        pass

    def check_need(self, need, layout):
        pass

    def need(self, data):
        return None

    def probe(self, run):
        return run(None, True)[0]

    def data(self, pos, s, nbrs, layout):
        return None

    def solve(self, pos, q, qsfp, s, nbrs, data, isqeq, spos, loop):
        """(charges, CG iterations, shells) of a solve from `q`."""
        cfg = self.eng.cfg
        res = qeq.solve(q, qsfp, s.types, self.eng.ffd,
                        self.hessian(pos, s, nbrs, data, isqeq), isqeq=isqeq,
                        nmax=cfg.NMAXQEq, tol=cfg.QEq_tol,
                        lex_fqs=cfg.Lex_fqs, loop=loop)
        return res.q, res.iters, spos

    def nonbond(self, pos, q, s, data, with_virial):
        return None


class SweepLayout(NamedTuple):
    sm: pairsweep.SlotMap  # the slot map (None in a probe's input)
    qcap: int              # QEq list capacity (None: exact, a host read)


class Sweep(PairEngine):
    """The pair sweep: its slot grid (no slot-count cap), pair functions
    and QEq list capacity ("qeq list" a window's, "probe qeq list")."""

    def __init__(self, eng, H):
        super().__init__(eng, H)
        self.grid = pairsweep.make_pair_grid(H, eng.rctap, skin=eng.skin,
                                             ccap=8)
        rc2 = float(eng.ffd.rctap2)
        self.nb_fn = pairsweep.make_nonbond_pair_fn(eng.ffd, eng.ff.nso, rc2)
        self.qeq_fn = pairsweep.make_qeq_pair_fn(eng.ffd, eng.ff.nso, rc2)

    def layout(self, pos, H, like=None):
        pose = neighbors.ext_positions(pos, H, self.eng.img)
        valid = torch.ones(pose.shape[0], dtype=torch.bool,
                           device=pose.device)
        sm = pairsweep.bin_slots(pose, valid, self.grid, pos.shape[0])
        return SweepLayout(sm, None if like is None else like.qcap)

    def counts(self, layout, data=None):
        sm = layout.sm
        return sm.overflow, (data.need() if data is not None else
                             pairsweep.walk_candidates(
                                 self.grid, pairsweep.atom_walk(sm)))

    def window(self, layout, got):
        return layout._replace(qcap=self.eng._size("qeq list", got["qeq"]))

    def capacity(self, layout):
        return layout.qcap

    def check_slots(self, got):
        if got["slots"] > self.grid.ccap:
            raise RuntimeError(
                f"pair-sweep cell overflow: {got['slots']} > "
                f"ccap={self.grid.ccap} (increase ccap or cell size)")

    def check_need(self, need, layout):
        if need > layout.qcap:
            raise RuntimeError(
                f"QEq list overflow: {int(need)} entries > capacity "
                f"{layout.qcap} (pairsweep.walk_candidates bounds them)")

    def need(self, data):
        return data.need()

    def probe(self, run):
        """The first probe runs eagerly with an exact list and sizes the
        probes'; a probe whose list outgrows it grows it and reruns."""
        eng = self.eng
        while True:
            qcap = eng._sizes.get("probe qeq list")
            res, got = run(SweepLayout(None, qcap), qcap is not None)
            if qcap is None or got["qeq"] > qcap:
                eng._size("probe qeq list", got["qeq"])
                if qcap is not None:
                    eng.timers.count("probe QEq list regrowths", 1)
                    continue
            eng.timers.peak("probe QEq list", got["qeq"],
                            eng._sizes["probe qeq list"])
            return res

    def data(self, pos, s, nbrs, layout):
        return SweepOps(self, pos, s.H, s.types, s.gid, layout,
                        self.eng.plain_sweeps)

    def hessian(self, pos, s, nbrs, data, isqeq):
        return data.hessian

    def nonbond(self, pos, q, s, data, with_virial):
        amask = torch.ones(s.n, dtype=torch.bool, device=pos.device)
        rows = data.nonbond(q)
        evdw, eclmb = torch.sum(rows[0]), torch.sum(rows[1])
        echarge = reax.charge_energy(q, s.types, amask, self.eng.ffd)
        f_nb, w_nb = rows[2:5].T, None
        if with_virial:
            v = torch.sum(rows[5:11], dim=1)   # xx,yy,zz,yz,zx,xy
            w_nb = torch.stack([torch.stack([v[0], v[5], v[4]]),
                                torch.stack([v[5], v[1], v[3]]),
                                torch.stack([v[4], v[3], v[2]])])
        return evdw, eclmb, echarge, f_nb, w_nb


class SweepOps:
    """The sweep's pair data: its kernels (plain versions for CPU tensors
    or under md.Engine.plain_sweeps) over the layout's walk at a step's
    positions: `sweep3`, the QEq matvec of the CG's (n, 2) state and,
    unless q is None, the Est rows (its QEq list built at its first call,
    `need()` what that asks), and `nonbond`, each (rows, n)."""

    def __init__(self, sweep, pos, H, types, gid, layout, plain):
        ps = pairsweep
        self.grid, self.fn, self.nb_fn = sweep.grid, sweep.qeq_fn, sweep.nb_fn
        sm, self.cap = layout
        n = self.n = pos.shape[0]
        img = sweep.eng.img
        pose = neighbors.ext_positions(pos, H, img)
        src = sm.slot_src
        ok = self.okslot = src >= 0
        srcc = torch.where(ok, src, 0)
        own = self.own64 = srcc % n if img.n_images > 1 else srcc
        self.pos3 = torch.where(ok[:, None], pose[srcc], ps.FAR).T  # (3, ns)
        self.tslot = torch.where(ok, types[own].to(pos.dtype), 0.0)
        self.gidf = torch.where(ok, gid[own].to(pos.dtype), -1.0)
        self.isprim = ((src < n) & ok).to(pos.dtype)
        self.walk = ps.atom_walk(sm)
        self.own = own.to(torch.int32)
        self._build, self._apply, self._nb = (
            (ps.qeq_build_plain, ps.qeq_apply_plain, ps.nonbond_plain)
            if plain else (ps.qeq_build, ps.qeq_apply, ps.nonbond))
        self.list = None

    def qeq_planes(self):
        """(5, nslots) planes x, y, z, type, is_primary."""
        return torch.cat([self.pos3, self.tslot[None], self.isprim[None]])

    def nonbond_planes(self, q):
        """(6, nslots) planes x, y, z, type, gid, q."""
        qs = torch.where(self.okslot, q[self.own64], 0.0)[None]
        return torch.cat([self.pos3, self.tslot[None], self.gidf[None], qs])

    def sweep3(self, X, qc):
        if self.list is None:
            self.list = self._build(self.grid, self.walk, self.qeq_planes(),
                                    self.fn, self.own, self.n, self.cap)
        rows = self._apply(self.list, self.walk, X, qc)
        return rows[0], rows[1], rows[2]

    def nonbond(self, q):
        return self._nb(self.grid, self.walk, self.nonbond_planes(q),
                        self.nb_fn)

    def need(self):
        return None if self.list is None else self.list.need

    def hessian(self, eta):
        def matvec(X):
            mvs, mvt, _ = self.sweep3(X, None)
            return eta[:, None] * X + torch.stack([mvs, mvt], dim=1)

        def matvec_est(Hv, q):
            mvs, mvt, estp = self.sweep3(Hv, q)
            return eta[:, None] * Hv + torch.stack([mvs, mvt], dim=1), estp
        return matvec, matvec_est


class Dense(PairEngine):
    """The dense minimum-image forms."""

    @staticmethod
    def operator(pos, H, types, ffd):
        """The hessian operator over reax.qeq_dense_direct's matrices."""
        def hessian(eta):
            Hd, Hw = reax.qeq_dense_direct(pos, H, types, ffd)
            return (lambda X: eta[:, None] * X + Hd @ X,
                    lambda Hv, q: (eta[:, None] * Hv + Hd @ Hv, Hw @ q))
        return hessian

    def hessian(self, pos, s, nbrs, data, isqeq):
        return self.operator(pos, s.H, s.types, self.eng.ffd)

    def nonbond(self, pos, q, s, data, with_virial):
        amask = torch.ones(s.n, dtype=torch.bool, device=pos.device)
        out = reax.nonbond_dense(pos, q, s.H, s.types, amask, self.eng.ffd,
                                 with_virial=with_virial)
        return out if with_virial else (*out, None)


class PairList(PairEngine):
    """The pair context over the nonbonded list (ELL): its pair data is
    the context and, with the tables, their rows (reax.pair_rows)."""

    @staticmethod
    def operator(ctx, rows, types, ffd, img, nbrs, isqeq=1, dense_max=None,
                 refresh=None, resident_ext=None):
        """The hessian operator over the pair context `ctx` (with periodic
        self-images, ref: qeq.F90:200-256): the closed form (`rows` None)
        or table column 4 (reax.pair_rows'), folded into a dense matrix
        for a full CG at n <= `dense_max` (None: never).  A sharded domain
        passes `refresh` (MODE_QCOPY1/2, qeq.F90:86-164) and the extended
        rows it owns, `resident_ext`."""
        refresh = refresh or (lambda x: x)

        def hessian(eta):
            n, dtype = eta.shape[0], eta.dtype
            if rows is None:
                prm = reax.ctx_prm(ctx, types, ffd)
                hess = reax.cf_qeq_kernel(ctx.dr2, prm, ffd, ctx.mask
                                          & (ctx.dr2 < ffd.rctap2))
            else:
                table, ok = rows
                hess = torch.where(ok & (ctx.dr2 < ffd.rctap2),
                                   table[..., 4], 0.0)
            mask = nbrs.masknb
            oj = img.owner_of(ctx.idx)
            hz = torch.where(mask, hess, 0.0)
            # Est pair weight: 0.5 per directed entry, 1 where the neighbor
            # is this domain's atom, no image or ghost (ref: qeq.F90:304-306)
            own = (ctx.idx < n if resident_ext is None
                   else resident_ext[ctx.idx])
            est_w = torch.where(own, 1.0, 0.5).to(dtype)
            if dense_max is not None and n <= dense_max and isqeq != 2:
                # accumulate sums repeated (row, owner) in a fixed order
                row = torch.arange(n, device=eta.device)[:, None]
                Hd = torch.zeros((n, n), dtype=dtype, device=eta.device)
                Hd.index_put_((row.expand_as(oj).reshape(-1),
                               oj.reshape(-1)), hz.reshape(-1),
                              accumulate=True)

                def fold_est(Hv, q):
                    qj = torch.where(mask, q[oj], 0.0)
                    return (eta[:, None] * Hv + Hd @ Hv,
                            torch.sum(est_w * hz * qj, dim=1))
                return lambda X: eta[:, None] * X + Hd @ X, fold_est

            def matvec(X):
                Xs = torch.where(mask[..., None], refresh(X)[oj], 0.0)
                return eta[:, None] * X + torch.einsum("nk,nkc->nc", hz, Xs)

            def matvec_est(Hv, q):
                # one (n, knb, 3) gather feeds both H·(hs, ht) and the Est
                # pair sum (cf. the reference's single get_hsh pass)
                Y = torch.cat([Hv, q[:, None]], dim=1)
                Ys = torch.where(mask[..., None], refresh(Y)[oj], 0.0)
                mv = eta[:, None] * Hv + torch.einsum("nk,nkc->nc", hz,
                                                      Ys[..., :2])
                return mv, torch.sum(est_w * hz * Ys[..., 2], dim=1)
            return matvec, matvec_est
        return hessian

    def data(self, pos, s, nbrs, layout):
        eng = self.eng
        amask = torch.ones(s.n, dtype=torch.bool, device=pos.device)
        ctx = reax.nb_ctx(pos, None, s.H, s.types, eng.img, nbrs, s.gid,
                          amask, eng.ffd)
        return ctx, (None if eng.closed_form
                     else reax.pair_rows(ctx, s.types, eng.ffd))

    def hessian(self, pos, s, nbrs, data, isqeq):
        return self.operator(*data, s.types, self.eng.ffd, self.eng.img,
                             nbrs, isqeq, self.eng.cfg.qeq_dense_max)

    def nonbond(self, pos, q, s, data, with_virial):
        eng = self.eng
        amask = torch.ones(s.n, dtype=torch.bool, device=pos.device)
        out = reax.nonbond_ctx_energy_forces(
            data[0], q, s.types, amask, eng.ffd, eng.closed_form,
            with_virial=with_virial, pre=data[1], img=eng.img)
        return out if with_virial else (*out, None)


class PQEqPairList(PairEngine):
    """The pair list under PQEq: `pqeq.solve` walks the skinned nonbonded
    list itself, and the core/shell nonbond joins the bonded terms'
    autograd pass (no pair data, no nonbond of its own)."""

    def solve(self, pos, q, qsfp, s, nbrs, data, isqeq, spos, loop):
        eng, cfg = self.eng, self.eng.cfg
        qn, spos_n, iters, _ = pqeq.solve(
            pos, spos, q, qsfp, s.H, s.types, eng.img, nbrs, eng.ffd, eng.pq,
            isqeq=isqeq, nmax=cfg.NMAXQEq, tol=cfg.QEq_tol, loop=loop,
            lex_fqs=cfg.Lex_fqs, efield_strength=cfg.eFieldStrength,
            efield_dir=cfg.eFieldDir if cfg.isEfield else None)
        return qn, iters, spos_n
