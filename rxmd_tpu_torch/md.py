"""MD engine: velocity Verlet + QEq + the cell-column pair sweep
(counterpart of rxmd_tpu.md.Engine for one device).

One step follows the reference main loop (ref: main.F90:37-100): half
kick -> extended-Lagrangian charge DOF leapfrog -> drift -> QEq (every
qstep) -> FORCE -> kinetic stress -> half kick.  A rebuild wraps the
positions and rebuilds the skinned neighbor lists, the cached angle /
torsion / hbond lists and the pair sweep's slot layout; the host loop
rebuilds on a fixed cadence or when the drift monitor trips.

Ported configuration: orthogonal box, NVE (mdmode=1), closed-form
nonbond, cached term lists, QEq off / full CG (isQEq=1) / extended
Lagrangian (isQEq=2), the pair sweep as the only nonbond and QEq engine.
Anything else raises NotImplementedError.  Steps run one per host
iteration (`block_steps` is not used).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from . import neighbors, qeq, reax, units
from .config import RunConfig
from .ffield import ForceField, effective_maxrc
from .ops import pairsweep
from .system import State


def _round_up(x, m):
    return int(-(-x // m) * m)


def _cell_grid(ff, state, img, skin, rctap):
    """Cell-list grid over the image region for orthogonal boxes with
    n >= 400 (brute force below that), as rxmd_tpu sizes it, but with the
    cell capacity raised to the densest cell of `state` plus 25% + 2:
    rxmd_tpu's density estimate can fall short of it (11 atoms against
    ccap 10 on the 8,064-atom test deck), and a fuller cell drops atoms
    from every list that reads it."""
    H = state.H.cpu().numpy()
    if state.n < 400 or not np.allclose(H, np.diag(np.diag(H))):
        return None
    maxrc = effective_maxrc(ff, state.types.cpu().numpy())
    L = np.diag(H)
    grid = neighbors.make_cell_grid(
        -np.asarray(img.nimg) * L, (1.0 + np.asarray(img.nimg)) * L,
        max(maxrc + skin, 2.0), rctap + skin)
    pose = neighbors.ext_positions(state.pos, state.H, img)
    occ = int(neighbors._cell_table_packed(
        pose, torch.ones(pose.shape[0], dtype=torch.bool, device=pose.device),
        state.types[img.owner], grid)[3])
    return grid._replace(ccap=max(grid.ccap, int(occ * 1.25) + 2))


def _build(state, img, grid, rc2b, rctap2, kb, knb):
    if grid is not None:
        pose = neighbors.ext_positions(state.pos, state.H, img)
        valid = torch.ones(pose.shape[0], dtype=torch.bool,
                           device=pose.device)
        nbrs, occ = neighbors.build_neighbors_cells(
            pose, valid, state.types[img.owner], grid, rc2b, rctap2, kb, knb,
            nrows=state.n)
        if int(occ) > grid.ccap:                 # see _cell_grid
            raise RuntimeError(f"neighbor cell overflow: {int(occ)} atoms > "
                               f"ccap={grid.ccap}")
        return nbrs
    return neighbors.build_neighbors_brute(state.pos, state.H, state.types,
                                           img, rc2b, rctap2, kb, knb)


def _trim(lst):
    """A flat term list cut to its `cnt` entries: the builders pack the
    valid ones to the front, and eager tensors need no fixed capacity."""
    cnt = int(lst.cnt)
    return lst._replace(**{f: getattr(lst, f)[:cnt] for f in lst._fields
                           if f != "cnt"})


def _skinned_cutoffs(ffd, rctap, skin):
    rc2b = ffd.rc2b
    rc2b_ext = (torch.sqrt(rc2b) + skin) ** 2 * (rc2b > 0)
    rctap2_ext = torch.tensor((rctap + skin) ** 2, dtype=rc2b.dtype,
                              device=rc2b.device)
    return rc2b_ext, rctap2_ext


@torch.no_grad()
def probe_capacities(ff: ForceField, state: State, ffd, rctap,
                     skin: float = 0.0, term_slack: float = 1.0,
                     term_margin: float = 0.0):
    """Measure neighbor and interaction-list occupancies of a configuration
    and derive padded static capacities (the analog of the reference's
    maxas headroom statistics, main.F90:128-146), on the state's device."""
    H = state.H.cpu().numpy()
    nimg = neighbors.nimg_for_cutoff(H, rctap + skin)
    img = neighbors.make_image_table(state.n, nimg, state.pos.dtype,
                                     state.device)
    grid = _cell_grid(ff, state, img, skin, rctap)
    rc2b_p, rctap2_p = _skinned_cutoffs(ffd, rctap, skin)
    probe = _build(state, img, grid, rc2b_p, rctap2_p, 32, 2048)
    mb, mnb = neighbors.check_overflow(probe)
    kb = _round_up(int(mb * 1.5) + 2, 4)
    knb = min(_round_up(int(mnb * 1.3) + 8, 64), 4096)
    nbrs_skinned = _build(state, img, grid, rc2b_p, rctap2_p, kb, knb)
    tc = reax.term_counts(state.pos, state.H, state.types, state.gid, img,
                          nbrs_skinned, ffd, slack=term_slack,
                          margin=term_margin)
    # margins sized for evolving dynamics, not the t=0 snapshot (angle /
    # torsion counts creep ~8% over the first ps, hbond candidates grow
    # past 1.4x, and per-center counts fluctuate harder than totals)
    caps = {"ang": _round_up(int(tc["ang"] * 1.5) + 64, 256),
            "tor": _round_up(int(tc["tor"] * 1.5) + 64, 512),
            "hb": max(_round_up(int(tc["hb"] * 1.8) + 2, 4), 4),
            "hbf": max(_round_up(int(tc["hbf"] * 1.8) + 64, 256), 256),
            "ks": _round_up(tc["degmax"] + 2, 2),
            "kh": max(_round_up(tc.get("h_slots", 4) + 1, 2), 2),
            "ang_row": _round_up(int(tc["ang_row"] * 2.2) + 8, 8),
            "tor_row": _round_up(int(tc["tor_row"] * 2.2) + 8, 8),
            "hb_row": max(_round_up(int(tc["hb"] * 2.2) + 16, 8), 16)}
    return kb, knb, caps


class PhaseTimer:
    """Device time per named phase from CUDA events; `ms()` synchronizes
    and returns the summed milliseconds and call counts per phase."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def __call__(self, name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.setdefault(name, []).append((start, end))

    def ms(self):
        torch.cuda.synchronize()
        return {k: (sum(s.elapsed_time(e) for s, e in v), len(v))
                for k, v in self.events.items()}


class Engine:
    """Single-device MD engine on `device` ("cuda" needs a card: without
    one the constructor raises; it never moves to the CPU by itself)."""

    def __init__(self, ff: ForceField, state: State, cfg: RunConfig,
                 dtype=None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device")
        H = state.H.cpu().numpy()
        missing = [name for cond, name in (
            (cfg.mdmode != 1, f"mdmode={cfg.mdmode} (only NVE, mdmode=1)"),
            (cfg.isQEq not in (0, 1, 2), f"isQEq={cfg.isQEq}"),
            (cfg.isPQEq, "PQEq"),
            (ff.is_lg, "LG dispersion"),
            (cfg.isEfield, "the electric field"),
            (bool(cfg.spring_const), "spring restraints"),
            (not cfg.term_cache, "uncached many-body terms (term_cache)"),
            (cfg.tighten_lists, "tighten_lists"),
            (cfg.nonbond_closed_form is False,
             "the interpolation-table nonbond path"),
            (cfg.pair_kernel is False, "the ELL and dense nonbond/QEq forms"),
            (cfg.save_run_profile, "the run profile"),
            (not np.allclose(H, np.diag(np.diag(H))), "a triclinic box"),
        ) if cond]
        if missing:
            raise NotImplementedError(
                "rxmd_tpu_torch has no path for " + ", ".join(missing))
        self.ff = ff
        self.cfg = cfg
        self.device = device
        self.dtype = dtype or getattr(torch, cfg.dtype)
        rctap = units.RCTAP0
        self.rctap = rctap
        self.ffd = reax.ffdev_from(ff, dtype=self.dtype, rctap=rctap,
                                   device=device)
        self.state = state.astype(self.dtype).to(device)

        # time step and derived constants (ref: init.F90:66-69,102-108)
        self.dt = cfg.dt_fs / units.UTIME
        self.lex_w2 = 2.0 * cfg.Lex_k / self.dt / self.dt
        f = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        self.dthm = f(self.dt * 0.5 / ff.mass)
        self.hmas = f(0.5 * ff.mass)
        self.treq_red = cfg.treq / units.UTEMP0

        self.skin = cfg.nbr_skin
        self.rebuild_every = cfg.rebuild_every
        nimg = neighbors.nimg_for_cutoff(H, rctap + self.skin)
        self.img = neighbors.make_image_table(state.n, nimg, self.dtype,
                                              device)
        self.grid = _cell_grid(ff, self.state, self.img, self.skin, rctap)
        self.rc2b_ext, self.rctap2_ext = _skinned_cutoffs(self.ffd, rctap,
                                                          self.skin)
        self.term_slack = cfg.term_slack
        self.term_margin = cfg.term_margin
        kb, knb, self.caps = probe_capacities(
            ff, self.state, self.ffd, rctap, skin=self.skin,
            term_slack=self.term_slack, term_margin=self.term_margin)
        self.kb = cfg.kb_cap or kb
        self.knb = cfg.knb_cap or knb

        # the cell-column pair sweep is the nonbond and QEq engine (no
        # slot-count cap: the slot table lives in device memory)
        self.pairk = pairsweep.make_pair_grid(H, rctap, skin=self.skin,
                                              ccap=8)
        rc2 = float(self.ffd.rctap2)
        self._nb_fn = pairsweep.make_nonbond_pair_fn(self.ffd, ff.nso, rc2)
        self._qeq_fn = pairsweep.make_qeq_pair_fn(self.ffd, ff.nso, rc2)
        # the sweep the pair ops run: `pairsweep.sweep` takes the CUDA
        # kernels for CUDA tensors; a reference run may set
        # `pairsweep.sweep_plain` here to run the plain version on any device
        self.pair_sweep = pairsweep.sweep
        self.cg_iters = 0          # CG iterations summed over every QEq solve

        # rebuild trigger: pair lists are valid while drift < skin/2, cached
        # term lists while drift < term_margin/2
        lim = self.skin
        if self.term_margin > 0.0:
            lim = min(lim, self.term_margin)
        self.drift_trigger = 0.5 * lim
        # drift-monitor polling cadence: each poll is a device->host read
        self.drift_check_from = 4
        self.drift_check_every = 2
        # per-phase CUDA-event timing: set to a PhaseTimer to record
        self.phases = None

    def _phase(self, name):
        return (contextlib.nullcontext() if self.phases is None
                else self.phases(name))

    # ------------------------------------------------------------------
    def _build_nbrs(self, pos, H, types):
        """Neighbor lists with the Verlet-skin-extended cutoffs."""
        s = dataclasses.replace(self.state, pos=pos, H=H, types=types)
        return _build(s, self.img, self.grid, self.rc2b_ext, self.rctap2_ext,
                      self.kb, self.knb)

    def _bin_pair_slots(self, pos, H):
        """Cell-slot binning for the pair sweep (rebuild cadence)."""
        pose = neighbors.ext_positions(pos, H, self.img)
        valid = torch.ones(pose.shape[0], dtype=torch.bool,
                           device=pose.device)
        return pairsweep.bin_slots(pose, valid, self.pairk, pos.shape[0])

    def _make_pair_ops(self, pos, H, types, sm):
        """Closures running the pair sweeps for this step's positions:
        sweep3 (QEq matvec + Est rows) and nonbond (energy/force/virial
        rows), each (rows, n) per primary atom."""
        ps = pairsweep
        pg = self.pairk
        n = pos.shape[0]
        S = self.img.n_images
        pose = neighbors.ext_positions(pos, H, self.img)
        src = sm.slot_src
        ok = src >= 0
        srcc = torch.where(ok, src, 0)
        own = srcc % n if S > 1 else srcc
        pos3 = torch.where(ok[:, None], pose[srcc], ps.FAR).T     # (3, ns)
        tslot = torch.where(ok, types[own].to(pos.dtype), 0.0)
        gidf = torch.where(ok, self.state.gid[own].to(pos.dtype), -1.0)
        isprim = ((src < n) & ok).to(pos.dtype)
        okf = ok.to(pos.dtype)
        soa = sm.slot_of_atom
        qeq_fn, nb_fn = self._qeq_fn, self._nb_fn
        sweep = self.pair_sweep

        class PairOps:
            @staticmethod
            def qeq_planes(hs, ht, qc):
                """(8, nslots) planes x, y, z, type, is_primary, hs, ht, q."""
                ch = torch.stack([hs, ht, qc], dim=1)[own].T * okf
                return torch.cat([pos3, tslot[None], isprim[None], ch])

            @staticmethod
            def nonbond_planes(q):
                """(6, nslots) planes x, y, z, type, gid, q."""
                qs = torch.where(ok, q[own], 0.0)[None]
                return torch.cat([pos3, tslot[None], gidf[None], qs])

            @staticmethod
            def sweep3(hs, ht, qc):
                out = sweep(pg, PairOps.qeq_planes(hs, ht, qc), qeq_fn)
                rows = ps.gather_rows(pg, out, soa)
                return rows[0], rows[1], rows[2]

            @staticmethod
            def nonbond(q):
                out = sweep(pg, PairOps.nonbond_planes(q), nb_fn)
                return ps.gather_rows(pg, out, soa)

        return PairOps

    def _external_nonbond(self, pair_ops, q, types, with_virial):
        """Assemble the external-nonbond tuple from the sweep rows."""
        rows = pair_ops.nonbond(q)
        evdw = torch.sum(rows[0])
        eclmb = torch.sum(rows[1])
        echarge = torch.sum(units.CECHRGE * (
            self.ffd.chi[types] * q + 0.5 * self.ffd.eta[types] * q * q))
        f_nb = rows[2:5].T
        w_nb = None
        if with_virial:
            s = torch.sum(rows[5:11], dim=1)   # xx,yy,zz,yz,zx,xy
            w_nb = torch.stack([torch.stack([s[0], s[5], s[4]]),
                                torch.stack([s[5], s[1], s[3]]),
                                torch.stack([s[4], s[3], s[2]])])
        return evdw, eclmb, echarge, f_nb, w_nb

    def _wrap(self, pos, H):
        """Wrap positions into the primary cell."""
        frac = torch.remainder(pos @ torch.linalg.inv(H).T, 1.0)
        return frac @ H.T

    def _qeq_step(self, pos, q, qsfp, qsfv, types, pair_ops, isqeq=None):
        cfg = self.cfg
        isqeq = cfg.isQEq if isqeq is None else isqeq
        if isqeq == 0:
            return q, qsfp, qsfv, 0
        with self._phase("qeq"):
            res = qeq.solve(pos, q, qsfp, types, self.ffd, pair_ops,
                            isqeq=isqeq, nmax=cfg.NMAXQEq, tol=cfg.QEq_tol,
                            lex_fqs=cfg.Lex_fqs)
        self.cg_iters += res.iters
        if isqeq == 1:
            # fictitious charges re-seeded from pre-QEq q (ref: qeq.F90:42-43)
            return res.q, q, torch.zeros_like(qsfv), res.iters
        return res.q, qsfp, qsfv, res.iters

    def _forces(self, pos, q, s: State, lists, pair_ops, with_virial):
        with self._phase("nonbond"):
            ext_nb = self._external_nonbond(pair_ops, q, s.types, with_virial)
        with self._phase("bonded"):
            return reax.energy_and_forces(
                pos, q, s.H, s.types, s.gid, self.img, self.nbrs, self.ffd,
                lists, with_virial=with_virial, external_nonbond=ext_nb)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _rebuild(self, s: State):
        """Wrap positions into the box, rebuild the skinned neighbor lists,
        the cached many-body lists (slackened gates) and the slot layout."""
        with self._phase("rebuild"):
            pos = self._wrap(s.pos, s.H)
            nbrs = self._build_nbrs(pos, s.H, s.types)
            bo = reax.bond_order(pos, s.H, s.types, self.img, nbrs, self.ffd)
            amask = torch.ones(s.n, dtype=torch.bool, device=pos.device)
            kw = dict(slack=self.term_slack, margin=self.term_margin)
            caps = self.caps
            al = reax.build_angle_list(s.types, self.img, nbrs, bo, amask,
                                       self.ffd, cap=caps["ang"],
                                       ks=caps["ks"], rowcap=caps["ang_row"],
                                       **kw)
            tl = reax.build_torsion_list(s.types, s.gid, self.img, nbrs, bo,
                                         amask, self.ffd, cap=caps["tor"],
                                         ks=caps["ks"],
                                         rowcap=caps["tor_row"], **kw)
            hl = reax.build_hbond_list(pos, s.H, s.types, self.img, nbrs, bo,
                                       amask, self.ffd, cap=caps["hbf"],
                                       kh=caps["kh"], rowcap=caps["hb_row"],
                                       **kw)
            sm = self._bin_pair_slots(pos, s.H)
        self.state = dataclasses.replace(s, pos=pos)
        self.nbrs, self.tlists, self._slotmap = nbrs, (al, tl, hl), sm
        neighbors.check_overflow(nbrs)
        self._check_list_overflow()
        self._check_slot_overflow()
        self.tlists = tuple(_trim(lst) for lst in self.tlists)
        self._pos_ref = pos
        self._steps_since_rebuild = 0
        self._maxdr2_dev = None

    def _check_list_overflow(self):
        """Abort on interaction-list overflow like the reference
        (ref: main.F90:402-407), naming every cap that tripped."""
        names = ("ang", "tor", "hbf")
        counts = [int(lst.cnt) for lst in self.tlists]
        caps = [lst.valid.shape[0] for lst in self.tlists]
        errors = []
        rows = [nm + "_row" if nm != "hbf" else "hb_row"
                for nm, c in zip(names, counts) if c >= reax.ROW_OVERFLOW]
        if rows:
            errors.append(f"PER-ROW overflow in {'/'.join(rows)} — raise the "
                          "corresponding *_row capacities")
        total = [f"{nm} {c}/{cap}" for nm, c, cap in zip(names, counts, caps)
                 if cap < c < reax.ROW_OVERFLOW]
        if total:
            errors.append(f"total overflow: {', '.join(total)} — raise caps")
        if errors:
            raise RuntimeError("interaction-list overflow: "
                               + "; ".join(errors) + f" (caps={self.caps}; "
                               "ref aborts too, main.F90:402-407)")

    def _check_slot_overflow(self):
        ov = int(self._slotmap.overflow)
        if ov > self.pairk.ccap:
            raise RuntimeError(
                f"pair-sweep cell overflow: {ov} > ccap={self.pairk.ccap} "
                "(increase ccap or cell size)")

    @torch.no_grad()
    def prepare(self):
        """Initial rebuild, QEq and FORCE before the main loop
        (ref: main.F90:27-32)."""
        self._rebuild(self.state)
        s = self.state
        pair_ops = self._make_pair_ops(s.pos, s.H, s.types, self._slotmap)
        # cold-start extended Lagrangian: one full CG solve seeds the
        # fictitious charge DOF
        isq = 1 if self.cfg.isQEq == 2 else None
        q, qsfp, qsfv, nq = self._qeq_step(s.pos, s.q, s.qsfp, s.qsfv,
                                           s.types, pair_ops, isqeq=isq)
        if self.cfg.isQEq == 2:
            qsfp, qsfv = q, torch.zeros_like(qsfv)
        comps, f = self._forces(s.pos, q, s, self.tlists, pair_ops, False)
        self.state = dataclasses.replace(s, q=q, qsfp=qsfp, qsfv=qsfv)
        self.force = f
        self.comps = comps
        self.nqeq = nq
        self._astr = torch.zeros((6,), dtype=self.dtype, device=self.device)
        self._astr_steps = 0
        return comps

    @torch.no_grad()
    def step(self):
        """One velocity-Verlet MD step on the engine state."""
        cfg = self.cfg
        dt = self.dt
        s = self.state
        f = self.force
        dthm = self.dthm[s.types][:, None]
        # first half kick (ref: main.F90:64, vkick main.F90:192-207)
        v = s.vel + dthm * f
        # extended-Lagrangian charge DOF leapfrog (ref: main.F90:67-68)
        qsfv = s.qsfv + 0.5 * dt * self.lex_w2 * (s.q - s.qsfp)
        qsfp = s.qsfp + dt * qsfv
        # drift (ref: main.F90:72); wrapping happens at list rebuilds
        pos = s.pos + dt * v

        pair_ops = self._make_pair_ops(pos, s.H, s.types, self._slotmap)
        if s.step % cfg.qstep == 0:
            q, qsfp, qsfv, nq = self._qeq_step(pos, s.q, qsfp, qsfv, s.types,
                                               pair_ops)
        else:
            q, nq = s.q, 0
        comps, f2, w = self._forces(pos, q, s, self.tlists, pair_ops, True)

        # per-step stress accumulation: kinetic m v_a v_b with the
        # half-kicked velocity + potential virial (ref: main.F90:86-94)
        m = (2.0 * self.hmas)[s.types]
        kin = torch.einsum("i,ia,ib->ab", m, v, v)
        sw = kin + 0.5 * (w + w.T)
        self._astr = self._astr + torch.stack(
            [sw[0, 0], sw[1, 1], sw[2, 2], sw[1, 2], sw[2, 0], sw[0, 1]])
        self._astr_steps += 1

        # second half kick (ref: main.F90:97-98)
        v = v + dthm * f2
        qsfv = qsfv + 0.5 * dt * self.lex_w2 * (q - qsfp)
        # Verlet-drift monitor: max displacement since the last rebuild
        self._maxdr2_dev = torch.max(torch.sum((pos - self._pos_ref) ** 2,
                                               dim=1))
        self.state = dataclasses.replace(s, pos=pos, vel=v, q=q, qsfp=qsfp,
                                         qsfv=qsfv, step=s.step + 1)
        self.force, self.comps, self.nqeq = f2, comps, nq
        self._steps_since_rebuild += 1

    def run(self, nsteps=None, log=print):
        """Host driver loop (ref: main.F90:37-103): one step per
        iteration, rebuilding on the cadence or when the drift monitor
        (polled every `drift_check_every` steps) trips."""
        cfg = self.cfg
        nsteps = nsteps if nsteps is not None else cfg.ntime_step
        if not hasattr(self, "force"):
            self.prepare()
        t0 = time.perf_counter()
        for _ in range(nsteps):
            if self.state.step % cfg.pstep == 0 and log:
                log(self.printe_line())
            ssr = self._steps_since_rebuild
            drifted = (self._maxdr2_dev is not None
                       and ssr >= self.drift_check_from
                       and ssr % self.drift_check_every == 0
                       and float(self._maxdr2_dev) ** 0.5
                       > 0.8 * self.drift_trigger)
            if ssr >= self.rebuild_every or drifted:
                self._rebuild(self.state)
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if log:
            log(self.printe_line())
            log(f"total (sec): {wall:.4f}  "
                f"atom-steps/s: {self.state.n * nsteps / wall:.3e}")
        return wall

    # ------------------------------------------------------------------
    def pressure_gpa(self, reset=True):
        """Pressure [GPa] from the per-step accumulated stress, normalized
        like the reference PRINTE: tr(astr)/3 / volume * USTRS / steps
        (ref: main.F90:252-253); the accumulator resets after each print."""
        astr = self._astr.cpu().numpy()
        vol = abs(float(torch.linalg.det(self.state.H)))
        nst = self._astr_steps or max(self.cfg.pstep, 1)
        ss = astr[:3].sum() / 3.0 / vol * units.USTRS / nst
        if reset:
            self._astr = torch.zeros_like(self._astr)
            self._astr_steps = 0
        return float(ss)

    def printe_line(self):
        """PRINTE-format observables (ref: main.F90:210-263)."""
        s = self.state
        n = s.n
        ke = float(torch.sum(self.hmas[s.types]
                             * torch.sum(s.vel * s.vel, dim=1))) / n
        pe = self.comps.cpu().numpy() / n
        te = ke + pe[0]
        tt = ke * units.UTEMP
        ss = self.pressure_gpa()
        qq = float(s.q.sum())
        return (f"MDstep: {s.step:9d} {te: .5E} {pe[0]: .5E} {ke: .5E} "
                f"{pe[1]: .3E} {pe[2:5].sum(): .3E} {pe[5:8].sum(): .3E} "
                f"{pe[8:10].sum(): .3E} {pe[10]: .3E} {pe[11:14].sum(): .3E} "
                f"{tt:8.2f} {ss:8.2f} {qq:8.2f} {int(self.nqeq):4d}")

    def init_velocity(self, seed=0):
        """Gaussian velocities scaled to treq with zero net momentum
        (ref: INITVELOCITY init.F90:292-360); numpy's generator, so both
        packages draw the same numbers from one seed."""
        s = self.state
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(s.n, 3))
        m = (2.0 * self.hmas).cpu().numpy()[s.types.cpu().numpy()]
        v -= (m[:, None] * v).sum(0) / m.sum()
        ke = 0.5 * (m * (v * v).sum(1)).sum() / s.n
        v *= np.sqrt(1.5 * self.treq_red / ke)
        self.state = dataclasses.replace(
            s, vel=torch.as_tensor(v, dtype=self.dtype, device=self.device))
