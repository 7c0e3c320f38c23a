"""MD engine: velocity Verlet + QEq + a pair engine for the nonbond and
QEq pair terms (counterpart of rxmd_tpu.md.Engine for one device).

One step follows the reference main loop (ref: main.F90:37-100):
thermostat (every sstep) -> half kick -> extended-Lagrangian charge DOF
leapfrog -> [momentum reset under a field] -> drift -> QEq (every qstep)
-> FORCE (+ field and spring forces) -> kinetic stress -> half kick.  A
rebuild wraps the positions and rebuilds the skinned neighbor lists, the
cached angle / torsion / hbond lists and the pair engine's layout; the
host loop rebuilds on a fixed cadence or when the drift monitor trips,
prints PRINTE lines, writes frames and keeps the per-phase timers.

The pair engine (`Engine.pairs`, pairs.py; `Engine.pair_engine` names
it), chosen at construction, makes its layout at a rebuild and a probe,
its pair data each step, solves QEq and gives the nonbond; the programs
carry its layout without knowing which engine runs.
Boxes may be triclinic; the term lists may be cached or enumerated in
every energy call (term_cache=False), and the neighbor lists tightened to
the true cutoffs every step (tighten_lists).  mdmodes 0, 1, 4-8 (and 10
through `opt.conjugate_gradient`); QEq off / full CG (isQEq=1) / extended
Lagrangian (isQEq=2), or PQEq (`PQEqParm`: core/shell charges, taper
12.5 A, the shells relaxed one capped step per solve, the nonbond and its
forces by autograd); the ReaxFF-lg dispersion and inner-core terms of an
LG force field (closed form or tables); the electric field (on shells
too) and spring restraints.

The host schedule is rxmd_tpu's (`Engine.run`): single steps, and blocks
of `block_steps` steps between the host's boundaries and within the drift
budget.  A step is a function of its inputs (`_step_fn`, a block
`_multi_step`), which on a card every configuration runs as CUDA graphs
(graphs.py; `uses_graphs`), the CG's chunks (QEq's and PQEq's) read by
the host in between (qeq.py); the CPU, the sweep's plain versions, and
runs with `graphs` off run the same functions eagerly.
A step reads nothing on the host: the lists it builds itself (the
tightened neighbor lists, the uncached terms' lists, the sweep's QEq
list) have fixed capacities, and their counts come out with the step for
the host to check at a block's end (`_check_lists`).

The optimizer's probe (mdmode 10, `probe`) is a program too: rxmd_tpu's
jitted evaluation (`_probe_fn`: wrap, neighbor lists, the pair layout,
a full QEq solve, the uncached terms' forces at the engine's
capacities), run as a CUDA graph on a card in a cache of its own, its PE
and every count a capacity bounds read by the host in one transfer.  So
is the rebuild (`_rebuild`): rxmd_tpu's jitted rebuild programs
(`_rebuild_fn`: wrap, neighbor lists, the bond order and the term lists
at their full capacities, the pair layout and its counts), a CUDA graph
on a card in a cache of its own, its counts and the steps' pending ones
read in one transfer, the lists then cut to the window's buckets on the
host.

Tracing (utils/timers.py): each dispatch names its program ("prepare",
"step", "block", "probe", "rebuild") for the device marks of the phases
"pairs", "qeq", "nonbond", "bonded" and "rebuild" (and reax's inside
"bonded"); host spans time the host loop's parts, a block's dispatch
apart from its end read, the rebuild's and the probe's dispatch, read and
checks.  While a profiler session records, the marks are read after the
block end, rebuild, probe and run end reads.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from . import graphs, neighbors, pairs, pqeq, reax, units
from .config import RunConfig
from .ffield import ForceField, effective_maxrc
from .io import refbin, traj
from .system import State
from .utils import timers as trace
from .utils.timers import RunProfile, Timers


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


def _build(state, img, grid, rc2b, rctap2, kb, knb, counts=None):
    """The neighbor lists: over the cell grid, raising where a cell
    overflows its capacity, or with `counts` (a dict) its densest cell
    left in counts["cells"] (a device tensor, no host read); brute force
    without a grid."""
    if grid is not None:
        pose = neighbors.ext_positions(state.pos, state.H, img)
        valid = torch.ones(pose.shape[0], dtype=torch.bool,
                           device=pose.device)
        nbrs, occ = neighbors.build_neighbors_cells(
            pose, valid, state.types[img.owner], grid, rc2b, rctap2, kb, knb,
            nrows=state.n)
        if counts is None:
            _check_cells(int(occ), grid)
        else:
            counts["cells"] = occ
        return nbrs
    return neighbors.build_neighbors_brute(state.pos, state.H, state.types,
                                           img, rc2b, rctap2, kb, knb)


def _check_cells(occ, grid):
    if occ > grid.ccap:                          # see _cell_grid
        raise RuntimeError(f"neighbor cell overflow: {occ} atoms > "
                           f"ccap={grid.ccap}")


def _bucket(n, cap=None):
    """n rounded up to one of a few sizes per octave (steps of 1/16 to 1/8
    of n), at most `cap`."""
    n = max(int(n), 1)
    step = 1 << max(n.bit_length() - 4, 0)
    n = -(-n // step) * step
    return n if cap is None else min(n, cap)


def _trim(lst, size=None):
    """A flat term list cut to `size` >= its `cnt` entries (None: `cnt`):
    the lists hold their valid entries first, so the padding entries are
    invalid, and the terms skip them."""
    size = int(lst.cnt) if size is None else size
    return lst._replace(**{f: getattr(lst, f)[:size] for f in lst._fields
                           if f != "cnt"})


def _skinned_cutoffs(ffd, rctap, skin):
    rc2b = ffd.rc2b
    rc2b_ext = (torch.sqrt(rc2b) + skin) ** 2 * (rc2b > 0)
    rctap2_ext = torch.tensor((rctap + skin) ** 2, dtype=rc2b.dtype,
                              device=rc2b.device)
    return rc2b_ext, rctap2_ext


def _bond_table_from(bo, nbrs, gid, img, bo_cutoff):
    """(partner gids, bond orders, counts) rows compacted to the front
    (ref: WriteBND fileio.F90:27-148, BNDcutoff=0.3)."""
    keep = bo.mask & (bo.bo[..., 0] > bo_cutoff)
    idx = torch.where(bo.mask, nbrs.idxb, 0)
    gids = torch.where(keep, gid[img.owner[idx]], -1)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    gids = torch.gather(gids, 1, order)
    bos = torch.gather(torch.where(keep, bo.bo[..., 0], 0.0), 1, order)
    return gids, bos, keep.sum(dim=1)


# the capacities a step's own lists are held to, in StepOut.over's order:
# the uncached terms' angle and torsion lists, candidate bonds and
# hydrogens per center and hbond entries per donor (reax.energy_components'
# counts), and the tightened neighbor lists (tighten_lists)
CAP_NAMES = ("ang", "tor", "ks", "kh", "hb", "kb_t", "knb_t")


def _over_vector(counts):
    """A step's capacity counts (a dict of device tensors) as one (7,)
    int64 vector in CAP_NAMES' order (0 where none was counted), or None
    where the step counted none."""
    if not counts:
        return None
    z = next(iter(counts.values())).new_zeros(())
    return torch.stack([counts.get(k, z).to(torch.int64) for k in CAP_NAMES])


def _max_or(a, b):
    """The elementwise maximum of two tensors, either of which may be
    None."""
    return a if b is None else b if a is None else torch.maximum(a, b)


class StepOut(NamedTuple):
    """What a step or a block of steps returns (rxmd_tpu md.py:714, 736)."""
    state: State          # the state after the (last) step
    force: torch.Tensor   # its forces
    comps: torch.Tensor   # (14,) PE components of the last step
    nq: torch.Tensor      # () CG iterations of the last step
    nq_sum: torch.Tensor  # () CG iterations summed over the steps
    ke: torch.Tensor      # () kinetic energy after the last step
    maxdr2: torch.Tensor  # () max squared drift since the rebuild
    astr: torch.Tensor    # (6,) accumulated stress
    need: torch.Tensor    # () max QEq list entries of the steps, or None
    vmax2: torch.Tensor   # () final max v^2 of a block, None for a step
    over: torch.Tensor    # (7,) max capacity counts of the steps (CAP_NAMES)
                          # or None


class ProbeIn(NamedTuple):
    """An optimizer probe's input (`Engine._probe_fn`)."""
    state: State          # the engine's state at the probe's positions
    hinv: torch.Tensor    # (3, 3) H^-1: the box is fixed under mdmode 10
    layout: object        # the pair layout's capacities (pairs.py)


class ProbeOut(NamedTuple):
    """What a probe returns (rxmd_tpu opt.py:48: PE, forces, charges)."""
    pe: torch.Tensor      # () potential energy
    force: torch.Tensor   # (n, 3)
    q: torch.Tensor       # (n,) the solve's charges
    nq: torch.Tensor      # () its CG iterations
    counts: torch.Tensor  # int64, PROBE_COUNTS' order


# a probe's counts, in ProbeOut.counts' order: the densest neighbor cell,
# the largest bonded and nonbonded neighbor rows, the pair layout's densest
# slot cell and QEq list entries (pairs.PairEngine.counts), then the
# capacity counts of CAP_NAMES (0 where a configuration counts none)
PROBE_COUNTS = ("cells", "kb", "knb", "slots", "qeq") + CAP_NAMES


class RebuildIn(NamedTuple):
    """A rebuild's input (`Engine._rebuild_fn`)."""
    pos: torch.Tensor     # (n, 3) positions, unwrapped
    H: torch.Tensor       # (3, 3) the box
    types: torch.Tensor   # (n,)
    gid: torch.Tensor     # (n,)
    hinv: torch.Tensor    # (3, 3) H^-1


class RebuildOut(NamedTuple):
    """What a rebuild returns (rxmd_tpu md.py:591-603)."""
    pos: torch.Tensor     # (n, 3) the positions wrapped into the box
    nbrs: neighbors.Neighbors   # the skinned neighbor lists
    lists: tuple          # (angle, torsion, hbond) lists at their full
                          # capacities (caps "ang", "tor", "hbf"), or None
    layout: object        # the pair layout (pairs.py), None off the sweep
    counts: torch.Tensor  # int64, REBUILD_COUNTS' order


# a rebuild's counts, in RebuildOut.counts' order: the densest neighbor
# cell, the largest bonded and nonbonded neighbor rows, the angle, torsion
# and hbond lists' entries, the pair layout's densest slot cell and QEq
# list candidates (pairs.PairEngine.counts); 0 where there are none
REBUILD_COUNTS = ("cells", "kb", "knb", "ang", "tor", "hbf", "slots", "qeq")


# mdmodes of the reference main loop (ref: main.F90:25,45-61): 1 NVE, 0 and
# 6 velocity redraws, 4 vsfact scaling, 5 scaling to treq, 7 per-element
# scaling, 8 scaling when >5% off treq, 10 structural optimization
MDMODES = (0, 1, 4, 5, 6, 7, 8, 10)


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
    # tight (no-skin) occupancies for the per-step tightened lists
    tight = neighbors.tighten(state.pos, state.H, state.types, img,
                              nbrs_skinned, ffd.rc2b, ffd.rctap2, kb, knb)
    kb_t = _round_up(int(tight.cntb.max() * 1.3) + 2, 4)
    knb_t = min(_round_up(int(tight.cntnb.max() * 1.2) + 8, 64), 4096)
    tc = reax.term_counts(state.pos, state.H, state.types, state.gid, img,
                          nbrs_skinned, ffd, slack=term_slack,
                          margin=term_margin)
    # margins sized for evolving dynamics, not the t=0 snapshot (angle /
    # torsion counts creep ~8% over the first ps, hbond candidates grow
    # past 1.4x, and per-center counts fluctuate harder than totals: on
    # the 8,064-atom CHON deck held at 300 K the most candidate bonds at a
    # center went from 11 to 13 and the most hydrogens on a donor from 5
    # to 7 within 1,500 steps)
    caps = {"ang": _round_up(int(tc["ang"] * 1.5) + 64, 256),
            "tor": _round_up(int(tc["tor"] * 1.5) + 64, 512),
            "hb": max(_round_up(int(tc["hb"] * 1.8) + 2, 4), 4),
            "hbf": max(_round_up(int(tc["hbf"] * 1.8) + 64, 256), 256),
            "ks": _round_up(tc["degmax"] + 4, 2),
            "kh": max(_round_up(tc.get("h_slots", 4) + 4, 2), 2),
            "kb_t": kb_t, "knb_t": knb_t,
            "ang_row": _round_up(int(tc["ang_row"] * 2.2) + 8, 8),
            "tor_row": _round_up(int(tc["tor_row"] * 2.2) + 8, 8),
            "hb_row": max(_round_up(int(tc["hb"] * 2.2) + 16, 8), 16)}
    return kb, knb, caps


class Engine:
    """Single-device MD engine on `device` ("cuda" needs a card: without
    one the constructor raises; it never moves to the CPU by itself)."""

    def __init__(self, ff: ForceField, state: State, cfg: RunConfig,
                 dtype=None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device")
        dtype = dtype or getattr(torch, cfg.dtype)
        missing = [name for cond, name in (
            (cfg.mdmode not in MDMODES, f"mdmode={cfg.mdmode}"),
            (cfg.isQEq not in (0, 1, 2), f"isQEq={cfg.isQEq}"),
        ) if cond]
        if missing:
            raise NotImplementedError(
                "rxmd_tpu_torch has no path for " + ", ".join(missing))
        rctap = units.RCTAP0_PQEQ if cfg.isPQEq else units.RCTAP0
        self.pq = None
        if cfg.isPQEq:
            par = pqeq.parse_pqeq_par(cfg.pqeq_parm_path)
            # chi/eta overrides before the FFDev, on a copy: the caller's
            # ForceField keeps its own
            ff = pqeq.apply_to_ff(dataclasses.replace(
                ff, chi=ff.chi.copy(), eta=ff.eta.copy()), par)
            self.pq = pqeq.make_pqeq(par, dtype=dtype, rctap=rctap,
                                     device=device)
            tmax = int(state.types.max())
            if tmax >= self.pq.ntype:
                # parameters match ffield types by row order (ref:
                # cmdline.F90:213-226): a type beyond the table must not
                # gather a clamped row
                raise ValueError(
                    f"atom type {tmax} has no PQEq parameters "
                    f"({self.pq.ntype} rows in {cfg.pqeq_parm_path})")
        H = state.H.cpu().numpy()
        # closed-form kernels in float32, the reference's interpolation
        # tables in float64, unless the config says
        self.closed_form = (cfg.nonbond_closed_form
                            if cfg.nonbond_closed_form is not None
                            else dtype == torch.float32)
        # cached term lists index the skinned neighbor slots, which the
        # per-step tightening renumbers
        self.term_cache = cfg.term_cache and not cfg.tighten_lists
        self.pair_engine = pairs.choose(cfg, self.closed_form, H, state.n,
                                        rctap, ff.is_lg, device, dtype)
        if cfg.mdmode == 0:
            # ref: init.F90:56-63, on a copy: the caller's RunConfig keeps
            # its own
            cfg = dataclasses.replace(cfg, isQEq=1)
        self.ff = ff
        self.cfg = cfg
        self.device = device
        self.dtype = dtype
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
        self.term_slack = cfg.term_slack if self.term_cache else 1.0
        self.term_margin = cfg.term_margin if self.term_cache else 0.0
        kb, knb, self.caps = probe_capacities(
            ff, self.state, self.ffd, rctap, skin=self.skin,
            term_slack=self.term_slack, term_margin=self.term_margin)
        self.kb = cfg.kb_cap or kb
        self.knb = cfg.knb_cap or knb

        self.pairs = pairs.make(self, H)
        # a reference run may set this to run the sweep's plain versions,
        # which CPU tensors take, on any device
        self.plain_sweeps = False
        # QEq solves, and CG iterations summed over them (on the device)
        self.qeq_solves = 0
        self.cg_iters = torch.zeros((), dtype=torch.int64, device=device)
        # dispatches as CUDA graphs on a card (uses_graphs); a reference
        # run may turn this off to run them eagerly
        self.graphs = True
        self._graphs = None
        # the optimizer's probe programs (`probe`): a cache of their own,
        # which a rebuild's new window shapes never drop
        self._probe_graphs = None
        # the rebuild program (`_rebuild_fn`): a cache of its own too, and
        # H^-1 of the box it last wrapped into
        self._rebuild_graphs = None
        self._hinv = None
        # steps per block dispatch (rxmd_tpu md.py:308), the schedule's
        # velocity bound and last block drift, the rebuild window's id,
        # the QEq list's entries and the capacity counts (CAP_NAMES) since
        # the last check
        self.block_steps = max(int(cfg.block_steps), 1)
        self._vmax = self._last_maxdr = None
        self._window_id = 0
        self._sizes = {}
        self._qeq_need = self._over = None

        # rebuild trigger: pair lists are valid while drift < skin/2, cached
        # term lists while drift < term_margin/2 (0 without a cache)
        lim = self.skin
        if self.term_margin > 0.0:
            lim = min(lim, self.term_margin)
        self.drift_trigger = 0.5 * lim
        # drift-monitor polling cadence: each poll is a device->host read
        self.drift_check_from = 4
        self.drift_check_every = 2

        # spring restraints toward the initial configuration
        # (ref: SpringForce pot.F90:95-110, ipos init.F90:231-232)
        self.ipos = self.state.pos if cfg.spring_const else None
        self._spring_mask = (
            torch.isin(self.state.types,
                       torch.as_tensor(list(cfg.spring_types),
                                       dtype=torch.int64, device=device))
            if cfg.spring_const and cfg.spring_types
            else torch.ones((state.n,), dtype=torch.bool, device=device))

        # per-phase host wall-clock accounting (ref: it_timer
        # module.F90:215-217, FinalizeMD report main.F90:128-186)
        self.timers = Timers()

    # ------------------------------------------------------------------
    def _build_nbrs(self, pos, H, types, counts=None):
        """Neighbor lists with the Verlet-skin-extended cutoffs (`counts`:
        see `_build`)."""
        s = dataclasses.replace(self.state, pos=pos, H=H, types=types)
        return _build(s, self.img, self.grid, self.rc2b_ext, self.rctap2_ext,
                      self.kb, self.knb, counts)

    def _tight_nbrs(self, pos, H, types, nbrs, counts=None):
        """The skinned lists filtered to the true cutoffs (tighten_lists),
        raising where a row overflows its tight capacity; with `counts` (a
        dict) their largest rows go to counts["kb_t"] and ["knb_t"]
        instead (device tensors, no host read; the host checks them at
        the block's end, `_check_lists`)."""
        if not self.cfg.tighten_lists:
            return nbrs
        tight = neighbors.tighten(pos, H, types, self.img, nbrs,
                                  self.ffd.rc2b, self.ffd.rctap2,
                                  self.caps["kb_t"], self.caps["knb_t"])
        if counts is None:
            neighbors.check_overflow(tight)
        else:
            counts["kb_t"] = tight.cntb.max()
            counts["knb_t"] = tight.cntnb.max()
        return tight

    def _pair_data(self, pos, s: State, nbrs, layout):
        """This step's pair data, shared by QEq and the nonbond term."""
        with trace.phase("pairs"):
            return self.pairs.data(pos, s, nbrs, layout)

    def _wrap(self, pos, H, hinv=None):
        """Wrap positions into the primary cell (`hinv`: H^-1 if known;
        inverting H reads the host, a singular-matrix check)."""
        hinv = torch.linalg.inv(H) if hinv is None else hinv
        frac = torch.remainder(pos @ hinv.T, 1.0)
        return frac @ H.T

    def _qeq_step(self, pos, q, qsfp, qsfv, s: State, nbrs, pairs,
                  isqeq=None, spos=None, loop=None):
        """(q, qsfp, qsfv, CG iterations, spos) after the pair engine's
        solve (under PQEq with its shell step from `spos`; `loop` drives the
        CG's chunks).  Mutates nothing: a CUDA graph holds it."""
        isqeq = self.cfg.isQEq if isqeq is None else isqeq
        if isqeq == 0:
            return q, qsfp, qsfv, 0, spos
        with trace.phase("qeq"):
            qn, iters, spos = self.pairs.solve(pos, q, qsfp, s, nbrs, pairs,
                                               isqeq, spos, loop)
        if isqeq == 1:
            # fictitious charges re-seeded from pre-QEq q (ref: qeq.F90:42-43)
            return qn, q, torch.zeros_like(qsfv), iters, spos
        return qn, qsfp, qsfv, iters, spos

    def _potential(self, pos, q, s: State, nbrs, lists, pairs, with_virial,
                   spos=None, counts=None):
        """Potential energy components, forces [and virial]: the pair
        engine's nonbond spliced into the bonded terms' autograd pass; under
        PQEq the core/shell nonbond at shells `spos` joins that pass.
        Uncached terms enumerate exact lists, raising at once on an
        overflow, or with `counts` (a dict) lists of the engine's
        capacities, their counts left in it (reax.energy_components)."""
        with trace.phase("nonbond"):
            ext_nb = self.pairs.nonbond(pos, q, s, pairs, with_virial)
        with trace.phase("bonded"):
            return reax.energy_and_forces(
                pos, q, s.H, s.types, s.gid, self.img, nbrs, self.ffd,
                lists, with_virial=with_virial, external_nonbond=ext_nb,
                caps=self.caps, pq=self.pq, spos=spos, counts=counts)

    def _external_forces(self, pos, q, types=None):
        """Electric-field and spring forces, or None without either."""
        cfg = self.cfg
        f_extra = None
        if cfg.isEfield:
            # constant-field force on the core charges, q + Z under PQEq
            # (ref: EEfield module.F90:359-383)
            if types is None:
                types = self.state.types
            qc = q if self.pq is None else q + self.pq.Z[types]
            f_extra = torch.zeros_like(pos)
            f_extra[:, cfg.eFieldDir] = (-qc * cfg.eFieldStrength
                                         * units.EEV_KCAL)
        if cfg.spring_const:
            # harmonic restraint toward the initial positions
            # (ref: SpringForce pot.F90:95-110)
            fs = -cfg.spring_const * (pos - self.ipos)
            fs = torch.where(self._spring_mask[:, None], fs, 0.0)
            f_extra = fs if f_extra is None else f_extra + fs
        return f_extra

    def _forces(self, pos, q, s: State, nbrs, lists, pairs, with_virial,
                spos=None, counts=None):
        out = self._potential(pos, q, s, nbrs, lists, pairs, with_virial,
                              spos, counts)
        f_extra = self._external_forces(pos, q, s.types)
        if f_extra is None:
            return out
        f = out[1] + f_extra
        if with_virial:
            # the reference includes every force in the Σ pos·f stress
            # accumulation (pot.F90:60-72)
            return out[0], f, out[2] + torch.einsum("ia,ib->ab", f_extra,
                                                    pos)
        return out[0], f

    def _thermostat(self, s: State, do_scale):
        """mdmode-dispatched velocity scaling (ref: main.F90:45-61); a new
        State, the old one's tensors untouched.  Velocities at rest (zero
        kinetic energy, as geninit writes them) have no temperature to
        scale and stay at rest; rxmd_tpu's factor sqrt(treq/0) * 0 makes
        them NaN there."""
        cfg = self.cfg
        if not do_scale or cfg.mdmode not in (4, 5, 7, 8):
            return s
        v = s.vel
        if cfg.mdmode == 4:
            v = cfg.vsfact * v
        elif cfg.mdmode == 5:
            ke = torch.sum(self.hmas[s.types] * torch.sum(v * v, dim=1))
            gke = ke / s.n
            ctmp = (self.treq_red * units.UTEMP0) / (gke * units.UTEMP)
            v = torch.where(ke > 0, torch.sqrt(ctmp), 1.0) * v
        elif cfg.mdmode == 7:
            # per-element rescale to treq (ref: main.F90:722-763); elements
            # with one atom or none get factor 0, as in rxmd_tpu
            nso = self.hmas.shape[0]
            cnt = torch.zeros(nso, dtype=v.dtype, device=v.device).index_add_(
                0, s.types, torch.ones_like(v[:, 0]))
            ket = torch.zeros(nso, dtype=v.dtype, device=v.device).index_add_(
                0, s.types, self.hmas[s.types] * torch.sum(v * v, dim=1))
            ctmp = torch.where(cnt > 1.0, ket / torch.clamp(cnt, min=1.0),
                               1.0)
            scale = torch.sqrt((self.treq_red * units.UTEMP0)
                               / (ctmp * units.UTEMP))
            fac = torch.where(cnt > 1.0, torch.where(ket > 0, scale, 1.0),
                              0.0)
            v = self._zero_momentum(s.types, fac[s.types][:, None] * v)
        else:
            # rescale only if >5% off target (ref: main.F90:684-718)
            ke = torch.sum(self.hmas[s.types] * torch.sum(v * v, dim=1)) / s.n
            ctmp = torch.sqrt((self.treq_red * units.UTEMP0)
                              / (ke * units.UTEMP))
            need = (ke > 0) & (torch.abs(ctmp - 1.0) > 0.05)
            v = torch.where(need, self._zero_momentum(s.types, ctmp * v), v)
        return dataclasses.replace(s, vel=v)

    def _zero_momentum(self, types, v):
        """Remove center-of-mass momentum (ref: main.F90:766-797)."""
        m = (2.0 * self.hmas)[types]
        vcm = torch.sum(m[:, None] * v, dim=0) / torch.sum(m)
        return v - vcm[None, :]

    @torch.no_grad()
    def remove_angular_momentum(self):
        """Remove rigid rotation about the center of mass: subtract
        (I^-1 L) x r from every velocity (what the reference's dead
        `angular_momentum`, main.F90:480-553, documents; as rxmd_tpu)."""
        s = self.state
        m = (2.0 * self.hmas)[s.types]
        com = torch.sum(m[:, None] * s.pos, dim=0) / torch.sum(m)
        dr = s.pos - com
        L = torch.sum(m[:, None] * torch.linalg.cross(dr, s.vel, dim=-1),
                      dim=0)
        r2 = torch.sum(dr * dr, dim=1)
        inert = (torch.eye(3, dtype=s.pos.dtype, device=s.pos.device)
                 * torch.sum(m * r2)
                 - torch.einsum("i,ia,ib->ab", m, dr, dr))
        omega = torch.linalg.solve(inert, L)
        self.state = dataclasses.replace(
            s, vel=s.vel - torch.linalg.cross(omega[None, :].expand_as(dr),
                                              dr, dim=-1))

    # ------------------------------------------------------------------
    def _rebuild_fn(self, carry: RebuildIn):
        """A rebuild as a function of its inputs (rxmd_tpu's jitted rebuild
        programs, md.py:545-604): a RebuildOut.  The positions wrapped
        into the box (by `carry.hinv`), the skinned neighbor lists, with
        cached terms the bond order and the angle, torsion and hbond lists
        (slackened gates, `term_slack`/`term_margin`) at their full
        capacities, and the pair layout with its counts.  It reads the
        engine's constants, mutates nothing and reads nothing on the host,
        so a CUDA graph can hold it; every count a capacity bounds comes
        out in `counts`, for the host to check (`_rebuild`)."""
        pos0, H, types, gid, hinv = carry
        counts = {}
        lists = None
        with trace.phase("rebuild"):
            pos = self._wrap(pos0, H, hinv)
            nbrs = self._build_nbrs(pos, H, types, counts)
            z = nbrs.cntb.new_zeros(())
            if self.term_cache:
                bo = reax.bond_order(pos, H, types, self.img, nbrs, self.ffd)
                amask = torch.ones(pos.shape[0], dtype=torch.bool,
                                   device=pos.device)
                kw = dict(slack=self.term_slack, margin=self.term_margin)
                caps = self.caps
                lists = (
                    reax.build_angle_list(
                        types, self.img, nbrs, bo, amask, self.ffd,
                        cap=caps["ang"], ks=caps["ks"],
                        rowcap=caps["ang_row"], **kw),
                    reax.build_torsion_list(
                        types, gid, self.img, nbrs, bo, amask, self.ffd,
                        cap=caps["tor"], ks=caps["ks"],
                        rowcap=caps["tor_row"], **kw),
                    reax.build_hbond_list(
                        pos, H, types, self.img, nbrs, bo, amask, self.ffd,
                        cap=caps["hbf"], kh=caps["kh"],
                        rowcap=caps["hb_row"], **kw))
            layout = self.pairs.layout(pos, H)
            pcounts = self.pairs.counts(layout)
        vec = torch.stack([t.to(torch.int64) for t in (
            counts.get("cells", z), nbrs.cntb.max(), nbrs.cntnb.max(),
            *((z,) * 3 if lists is None else (lst.cnt for lst in lists)),
            *(pcounts or (z, z)))])
        return RebuildOut(pos, nbrs, lists, layout, vec)

    @torch.no_grad()
    def _rebuild(self, s: State):
        """Wrap positions into the box, rebuild the skinned neighbor lists,
        the cached many-body lists (slackened gates; none for uncached
        terms) and the pair layout: the rebuild program (`_rebuild_fn`) as
        a CUDA graph where `uses_graphs()` (a cache of its own), else
        eagerly, then one host read of its counts together with the steps'
        counts since the last check.  The steps' lists are checked first
        (`_check_lists`), then the rebuild's, each raising with its
        message; the term lists are then cut to the window's padded
        lengths (`_size`, views of the program's output) and the pair
        layout sized for the window.  Counted after the read: the neighbor
        build's row passes ("nbr build passes", neighbors.passes) and, on
        a card, the level "reserved free GiB": memory the allocator
        reserves and no tensor takes."""
        H = s.H
        if self._hinv is None or self._hinv[0] is not H:
            self._hinv = (H, torch.linalg.inv(H))
        carry = RebuildIn(s.pos, H, s.types, s.gid, self._hinv[1])
        tm = self.timers
        tm.count("rebuilds", 1)
        with trace.span("dispatch"), trace.program("rebuild", self.device):
            if self.uses_graphs():
                if self._rebuild_graphs is None:
                    self._rebuild_graphs = graphs.GraphCache(self.device)
                out = self._run_graph(
                    self._rebuild_graphs, "rebuild",
                    lambda _, c, loop: self._rebuild_fn(c), (), carry, 0)
            else:
                out = self._rebuild_fn(carry)
        with trace.span("read"):
            vals = torch.cat([out.counts.double()] + [
                t.double() for t in self._pending()]).tolist()
        trace.drain()
        if self.grid is not None:
            tm.count("nbr build passes", neighbors.passes(s.n))
        if self.device.type == "cuda":
            tm.level("reserved free GiB",
                     (torch.cuda.memory_reserved(self.device)
                      - torch.cuda.memory_allocated(self.device)) / 2**30)
        with trace.span("checks"):
            self._check_lists(vals[len(REBUILD_COUNTS):])
            got = dict(zip(REBUILD_COUNTS, (int(v) for v in vals)))
            self._check_grids(got)
            tm.peak("bonded nbr list", got["kb"], self.kb)
            tm.peak("nonbonded nbr list", got["knb"], self.knb)
            lists = out.lists
            if lists is not None:
                names = ("ang", "tor", "hbf")
                cnts = [got[nm] for nm in names]
                caps = [lst.valid.shape[0] for lst in lists]
                err = self._list_overflow(names, cnts, caps)
                if err:
                    raise RuntimeError(err)
                for name, c, cap in zip(("angle list", "torsion list",
                                         "hbond list"), cnts, caps):
                    tm.peak(name, c, cap)
                lists = tuple(_trim(lst, self._size(nm, c, cap)) for lst,
                              nm, c, cap in zip(lists, names, cnts, caps))
            layout = self.pairs.window(out.layout, got)
        self.nbrs, self.tlists, self._layout = out.nbrs, lists, layout
        self.state = dataclasses.replace(s, pos=out.pos)
        self._pos_ref = out.pos
        self._steps_since_rebuild = 0
        self._maxdr2_dev = None
        self._window_id += 1

    def _size(self, name, n, cap=None):
        """The padded length of the rebuild window's list `name` for `n`
        entries: the largest bucket (`_bucket`) it has needed so far, so
        the window's shapes stop changing after a few rebuilds and a CUDA
        graph captured over them serves every later window."""
        size = max(self._sizes.get(name, 0), _bucket(n, cap))
        self._sizes[name] = size
        return size

    def _pending(self):
        """The steps' counts not yet checked, as a list of tensors: the
        QEq list's entries, then the capacity counts (CAP_NAMES)."""
        return [t.reshape(-1) for t in (self._qeq_need, self._over)
                if t is not None]

    def _check_lists(self, vals=None):
        """Raise if a list of the steps since the last check overflowed
        its capacity: the pair engine's QEq list and the steps' own lists
        (CAP_NAMES against `caps`: the uncached terms and the tightened
        neighbor lists).  One host read, none if `vals` (the values of
        `_pending()`, in order) was read already.  The steps
        run a block or more past an overflow before this raises (the
        host reads at a block's end, a rebuild and a run's end); rxmd_tpu
        drops the entries past a capacity, and the port raises."""
        if vals is None:
            pend = self._pending()
            vals = (torch.cat([t.double() for t in pend]).tolist() if pend
                    else [])
        need = vals[0] if self._qeq_need is not None else None
        over = vals[-len(CAP_NAMES):] if self._over is not None else None
        self._qeq_need = self._over = None
        if need is not None:
            self.pairs.check_need(need, self._layout)
        if over is not None:
            self._check_over(dict(zip(CAP_NAMES, (int(v) for v in over))))

    def _check_over(self, got):
        """Raise, naming each cap, where a step's own list overflowed
        (`got`: CAP_NAMES -> the steps' largest count), with the messages
        of the rebuild's and neighbors.check_overflow's checks."""
        caps = self.caps
        msgs = [m for name, m in (
            ("kb_t", f"bonded neighbor overflow: {got['kb_t']} > capacity "
                     f"{caps['kb_t']} (caps['kb_t'], tighten_lists)"),
            ("knb_t", f"nonbonded neighbor overflow: {got['knb_t']} > "
                      f"capacity {caps['knb_t']} (caps['knb_t'], "
                      "tighten_lists)"),
            ("ks", f"many-body candidate overflow: {got['ks']} bonds at "
                   f"one center > ks={caps['ks']} (raise caps['ks'])"),
            ("kh", f"hbond overflow: {got['kh']} hydrogens on one donor > "
                   f"kh={caps['kh']} (raise caps['kh'])"),
            ("hb", f"hbond overflow: {got['hb']} entries at one donor > "
                   f"cap={caps['hb']} (raise caps['hb'])"))
            if got[name] > caps[name]]
        msgs.append(self._list_overflow(("ang", "tor"), (got["ang"],
                                        got["tor"]), (caps["ang"],
                                                      caps["tor"])))
        if any(msgs):
            raise RuntimeError("; ".join(m for m in msgs if m))

    def _list_overflow(self, names, counts, caps):
        """The reference's interaction-list overflow abort message (ref:
        main.F90:402-407) naming every cap that tripped, `counts` of the
        lists `names` against their `caps`; None if none did."""
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
            return ("interaction-list overflow: " + "; ".join(errors)
                    + f" (caps={self.caps}; ref aborts too, "
                    "main.F90:402-407)")
        return None

    @torch.no_grad()
    def prepare(self):
        """Initial rebuild, QEq and FORCE before the main loop
        (ref: main.F90:27-32)."""
        self._rebuild(self.state)
        s = self.state
        with trace.program("prepare", self.device):
            nbrs = self._tight_nbrs(s.pos, s.H, s.types, self.nbrs)
            pairs = self._pair_data(s.pos, s, nbrs, self._layout)
            # cold-start extended Lagrangian: one full CG solve seeds the
            # fictitious charge DOF
            isq = 1 if self.cfg.isQEq == 2 else None
            q, qsfp, qsfv, nq, spos = self._qeq_step(
                s.pos, s.q, s.qsfp, s.qsfv, s, nbrs, pairs, isqeq=isq,
                spos=s.spos)
            if self.cfg.isQEq == 2:
                qsfp, qsfv = q, torch.zeros_like(qsfv)
            comps, f = self._forces(s.pos, q, s, nbrs, self.tlists, pairs,
                                    False, spos)
        self.state = dataclasses.replace(s, q=q, qsfp=qsfp, qsfv=qsfv,
                                         spos=spos)
        self.force = f
        self.comps = comps
        self.nqeq = nq
        self.cg_iters = self.cg_iters + nq
        self.qeq_solves += bool(self.cfg.isQEq)
        if self.cfg.isQEq:
            self._qeq_need = self.pairs.need(pairs)
            self._check_lists()
        self._astr = torch.zeros((6,), dtype=self.dtype, device=self.device)
        self._astr_steps = 0
        return comps

    def _step_fn(self, s: State, f, nbrs, lists, layout, pos_ref, astr,
                 do_scale, do_qeq, loop=None):
        """One velocity-Verlet step as a function of its inputs (rxmd_tpu's
        `_step_fn`, md.py:637-714): a StepOut.  It reads the engine's
        constants and mutates nothing, so a CUDA graph can hold it;
        `do_scale` and `do_qeq` are the host's decisions for this step,
        `layout` the pair layout, `loop` runs the CG's chunks.  The
        step's own lists (tightened neighbors, uncached terms) have fixed
        capacities: their counts come out in `over`, for the host to
        check at the block's end."""
        cfg = self.cfg
        dt = self.dt
        s = self._thermostat(s, do_scale)
        dthm = self.dthm[s.types][:, None]
        # first half kick (ref: main.F90:64, vkick main.F90:192-207)
        v = s.vel + dthm * f
        # extended-Lagrangian charge DOF leapfrog (ref: main.F90:67-68)
        qsfv = s.qsfv + 0.5 * dt * self.lex_w2 * (s.q - s.qsfp)
        qsfp = s.qsfp + dt * qsfv
        if cfg.isEfield:
            # the field pumps net momentum into the charged system;
            # correct it every step (ref: main.F90:70-71)
            v = self._zero_momentum(s.types, v)
        # drift (ref: main.F90:72); wrapping happens at list rebuilds
        pos = s.pos + dt * v

        counts = {}
        nbrs = self._tight_nbrs(pos, s.H, s.types, nbrs, counts)
        pairs = self._pair_data(pos, s, nbrs, layout)
        need = None
        if do_qeq:
            q, qsfp, qsfv, nq, spos = self._qeq_step(
                pos, s.q, qsfp, qsfv, s, nbrs, pairs, spos=s.spos,
                loop=loop)
            need = self.pairs.need(pairs)
        else:
            q, nq, spos = s.q, 0, s.spos
        if not isinstance(nq, torch.Tensor):
            nq = torch.full((), nq, dtype=torch.int32, device=pos.device)
        comps, f2, w = self._forces(pos, q, s, nbrs, lists, pairs, True,
                                    spos, counts)

        # per-step stress accumulation: kinetic m v_a v_b with the
        # half-kicked velocity + potential virial (ref: main.F90:86-94)
        m = (2.0 * self.hmas)[s.types]
        kin = torch.einsum("i,ia,ib->ab", m, v, v)
        sw = kin + 0.5 * (w + w.T)
        astr = astr + torch.stack(
            [sw[0, 0], sw[1, 1], sw[2, 2], sw[1, 2], sw[2, 0], sw[0, 1]])

        # second half kick (ref: main.F90:97-98)
        v = v + dthm * f2
        qsfv = qsfv + 0.5 * dt * self.lex_w2 * (q - qsfp)
        ke = torch.sum(self.hmas[s.types] * torch.sum(v * v, dim=1))
        # Verlet-drift monitor: max displacement since the last rebuild
        maxdr2 = torch.max(torch.sum((pos - pos_ref) ** 2, dim=1))
        s2 = dataclasses.replace(s, pos=pos, vel=v, q=q, qsfp=qsfp,
                                 qsfv=qsfv, spos=spos, step=s.step + 1)
        return StepOut(s2, f2, comps, nq, nq, ke, maxdr2, astr, need, None,
                       _over_vector(counts))

    def _multi_step(self, pattern, s: State, f, nbrs, lists, layout, pos_ref,
                    astr, loop=None):
        """len(pattern) steps, (do_scale, do_qeq) each (rxmd_tpu's
        `_make_multi_step`, md.py:717-738): the last step's StepOut with
        the CG iterations summed over the steps (`nq_sum`), the block's
        running maximum of the drift (`maxdr2`), of the QEq list's
        entries and of the capacity counts (`over`), and the final max
        v^2 (`vmax2`)."""
        out = None
        for do_scale, do_qeq in pattern:
            o = self._step_fn(s, f, nbrs, lists, layout, pos_ref, astr,
                              do_scale, do_qeq, loop)
            if out is not None:
                o = o._replace(nq_sum=out.nq_sum + o.nq,
                               maxdr2=torch.maximum(out.maxdr2, o.maxdr2),
                               need=_max_or(out.need, o.need),
                               over=_max_or(out.over, o.over))
            out = o
            s, f, astr = o.state, o.force, o.astr
        return out._replace(vmax2=torch.max(torch.sum(s.vel * s.vel, dim=1)))

    def _block_fn(self, pattern, window, carry, loop):
        """The program a dispatch runs, as graphs.GraphCache takes it: a
        single step for one entry of `pattern`, else a block.  window =
        (nbrs, lists, pair layout, pos_ref); carry = (state, force,
        astr)."""
        nbrs, lists, layout, pos_ref = window
        s, f, astr = carry
        if len(pattern) == 1:
            return self._step_fn(s, f, nbrs, lists, layout, pos_ref, astr,
                                 *pattern[0], loop)
        return self._multi_step(pattern, s, f, nbrs, lists, layout, pos_ref,
                                astr, loop)

    def uses_graphs(self):
        """Whether dispatches run as CUDA graphs: on a card, for every
        configuration, unless `graphs` is off or the sweep's plain
        versions run (they read counts on the host); tracing leaves them
        on (its marks are the device's own)."""
        return (self.graphs and self.device.type == "cuda"
                and not self.plain_sweeps)

    @torch.no_grad()
    def _advance(self, K):
        """Dispatch K steps (one, or a block of K), as a CUDA graph where
        `uses_graphs()`, and keep the host's bookkeeping; returns the
        StepOut."""
        cfg = self.cfg
        s0 = self.state.step
        scale = cfg.mdmode in (4, 5, 7, 8)
        pattern = tuple((scale and (s0 + i) % cfg.sstep == 0,
                         bool(cfg.isQEq) and (s0 + i) % cfg.qstep == 0)
                        for i in range(K))
        window = (self.nbrs, self.tlists, self._layout, self._pos_ref)
        # the host's step count stays out of the program (and its key)
        carry = (dataclasses.replace(self.state, step=0), self.force,
                 self._astr)
        with trace.program("step" if K == 1 else "block", self.device):
            if self.uses_graphs():
                if self._graphs is None:
                    self._graphs = graphs.GraphCache(self.device)
                out = self._run_graph(
                    self._graphs,
                    (pattern, self.pairs.capacity(self._layout)),
                    functools.partial(self._block_fn, pattern), window,
                    carry, self._window_id)
            else:
                out = self._block_fn(pattern, window, carry, None)
        self.state = dataclasses.replace(out.state, step=s0 + K)
        self.force, self.comps, self.nqeq, self._ke = (
            out.force, out.comps, out.nq, out.ke)
        self._astr = out.astr
        self.cg_iters = self.cg_iters + out.nq_sum
        self.qeq_solves += sum(do_qeq for _, do_qeq in pattern)
        self._qeq_need = _max_or(self._qeq_need, out.need)
        self._over = _max_or(self._over, out.over)
        self._maxdr2_dev = out.maxdr2 if K == 1 else None
        self._astr_steps += K
        self._steps_since_rebuild += K
        return out

    def _run_graph(self, cache, key, fn, window, carry, window_id):
        """cache.run(...) (graphs.GraphCache), its captures, capture
        seconds and replays added to the timers: in all, and by the kind
        of the program dispatched (trace.program) and of the CG chunk
        parts captured in it ("chunk", seconds within the program's);
        after a capture on a card, the level "graph pool GiB": what the
        graphs' memory pool (graphs.Memory) holds."""
        caps, secs, reps = cache.captures, cache.capture_s, cache.replays
        out = cache.run(key, fn, window, carry, window_id)
        tm = self.timers
        tm.count("graph replays", cache.replays - reps)
        if cache.captures > caps:
            n, dt = cache.captures - caps, cache.capture_s - secs
            for name, k, sec in (("", n, dt),
                                 (f": {trace.program_kind()}", n, dt),
                                 (": chunk", *cache.last_chunks)):
                if k:
                    tm.count("graph captures" + name, k)
                    tm.add("graph capture" + name, sec, k)
            if self.device.type == "cuda":
                tm.level("graph pool GiB", cache.memory.gib())
        return out

    # ------------------------------------------------------------------
    def _probe_fn(self, carry: ProbeIn, loop=None):
        """One optimizer probe as a function of its inputs (rxmd_tpu's
        jitted `evaluate`, opt.py:40-50): a ProbeOut.  The positions
        wrapped (by `carry.hinv`), the skinned neighbor lists (tightened
        under tighten_lists), the pair layout (`carry.layout`'s capacities)
        and data, a full QEq solve (under PQEq its shell step too, which
        the forces read and nothing keeps; `loop` runs the CG's chunks),
        then the forces over the uncached terms at the engine's `caps`.
        It reads the engine's constants, mutates nothing and reads nothing
        on the host, so a CUDA graph can hold it; every count a capacity
        bounds comes out in `counts`, for the host to check (`probe`)."""
        s, hinv, layout = carry
        counts = {}
        with trace.phase("rebuild"):
            pos = self._wrap(s.pos, s.H, hinv)
            nbrs = self._build_nbrs(pos, s.H, s.types, counts)
            rows = [nbrs.cntb.max(), nbrs.cntnb.max()]
            nbrs = self._tight_nbrs(pos, s.H, s.types, nbrs, counts)
            layout = self.pairs.layout(pos, s.H, layout)
        pairs = self._pair_data(pos, s, nbrs, layout)
        q, _, _, nq, spos = self._qeq_step(pos, s.q, s.qsfp, s.qsfv, s,
                                           nbrs, pairs, isqeq=1,
                                           spos=s.spos, loop=loop)
        comps, f = self._forces(pos, q, s, nbrs, None, pairs, False, spos,
                                counts)
        z = rows[0].new_zeros(())
        over = _over_vector(counts)
        vec = torch.stack([t.to(torch.int64) for t in (
            counts.get("cells", z), *rows,
            *(self.pairs.counts(layout, pairs) or (z, z)))])
        return ProbeOut(comps[0], f, q, nq, torch.cat(
            [vec, z.new_zeros(len(CAP_NAMES)) if over is None else over]))

    @torch.no_grad()
    def probe(self, pos, hinv=None):
        """(PE as a float, forces, charges) at `pos`, which stays
        untouched: the probe program (`_probe_fn`) as a CUDA graph where
        `uses_graphs()` (a cache of its own), else eagerly, then one host
        read of its PE and counts; a count past a capacity raises, naming
        it.  The pair engine may rerun it (pairs.Sweep.probe).  `hinv`:
        H^-1 (else inverted here)."""
        with self.timers("probe"):
            s = dataclasses.replace(self.state, pos=pos, step=0)
            hinv = torch.linalg.inv(s.H) if hinv is None else hinv

            def run(layout, graph):
                carry = ProbeIn(s, hinv, layout)
                self.timers.count("probes", 1)
                with trace.span("dispatch"), trace.program("probe",
                                                           self.device):
                    if self.uses_graphs() and graph:
                        if self._probe_graphs is None:
                            self._probe_graphs = graphs.GraphCache(self.device)
                        out = self._run_graph(
                            self._probe_graphs, "probe",
                            lambda _, c, loop: self._probe_fn(c, loop), (),
                            carry, 0)
                    else:
                        out = self._probe_fn(carry)
                self.cg_iters = self.cg_iters + out.nq
                self.qeq_solves += 1
                with trace.span("read"):
                    pe, *vals = torch.cat([out.pe[None].double(),
                                           out.counts.double()]).tolist()
                trace.drain()
                with trace.span("checks"):
                    got = dict(zip(PROBE_COUNTS, (int(v) for v in vals)))
                    self._check_probe(got)
                self.timers.peak("bonded nbr list", got["kb"], self.kb)
                self.timers.peak("nonbonded nbr list", got["knb"], self.knb)
                self.timers.peak("angle list", got["ang"], self.caps["ang"])
                self.timers.peak("torsion list", got["tor"], self.caps["tor"])
                return (pe, out.force, out.q), got
            return self.pairs.probe(run)

    def _check_grids(self, got):
        """Raise where a rebuild's or probe's densest neighbor cell, largest
        neighbor rows or densest slot cell (`got`: "cells", "kb", "knb",
        "slots" -> value) passed the engine's capacity."""
        if self.grid is not None:
            _check_cells(got["cells"], self.grid)
        neighbors.check_counts(got["kb"], got["knb"], self.kb, self.knb)
        self.pairs.check_slots(got)

    def _check_probe(self, got):
        """Raise where a probe's count (`got`: PROBE_COUNTS -> value)
        passed one of the engine's capacities, with the messages of the
        rebuild's checks."""
        self._check_grids(got)
        self._check_over(got)

    def step(self):
        """One velocity-Verlet MD step on the engine state (after
        `prepare`)."""
        self._advance(1)

    def run(self, nsteps=None, log=print, writer=None):
        """The host loop, rxmd_tpu's schedule line for line (ref:
        main.F90:37-103; rxmd_tpu md.py:892-1020): velocity redraws
        (mdmodes 0 and 6), PRINTE every pstep, `writer(state, comps)`
        every fstep, a rebuild on the cadence or when the drift monitor
        trips, then a block of `block_steps` steps where the steps to the
        next boundary and the drift budget allow it, else one step.  The
        budget: room / (1.25 vmax dt) steps, vmax read once after a start
        or a redraw and then from each block's end; a block's running
        maximum drift replaces the single steps' lazy poll (every
        `drift_check_every` steps from `drift_check_from` on).  Returns
        the loop's wall seconds."""
        cfg = self.cfg
        tm = self.timers
        nsteps = nsteps if nsteps is not None else cfg.ntime_step
        if not hasattr(self, "force"):
            if cfg.mdmode in (0, 6):
                self.init_velocity()
            with tm("first force"):
                self.prepare()
        profile = (RunProfile(cfg.run_profile_path, self.state.n)
                   if cfg.save_run_profile else None)
        t0 = time.perf_counter()
        trig = 0.8 * self.drift_trigger
        k = 0
        while k < nsteps:
            stepno = self.state.step
            if cfg.mdmode in (0, 6) and stepno % cfg.sstep == 0 and k > 0:
                # periodic Maxwell-Boltzmann redraw (ref: main.F90:53-54)
                self.init_velocity(seed=stepno)
                self._vmax = None
            if stepno % cfg.pstep == 0:
                nq = self.nqeq
                if isinstance(nq, torch.Tensor):
                    # one read: this step's CG iterations and the sum
                    with trace.span("QEq count read"):
                        nq, total = torch.stack([
                            nq.to(torch.int64), self.cg_iters]).tolist()
                    tm.counters["QEq iterations"] = total
                if log:
                    with tm("PRINTE"):
                        log(self.printe_line())
                if profile is not None:
                    profile.record(stepno, nq)
            if writer is not None and stepno % cfg.fstep == 0:
                with tm("trajectory output"):
                    writer(self.state, self.comps)
            # drift check: a block's running maximum (read at its end), or
            # the single steps' lazy poll
            ssr = self._steps_since_rebuild
            drifted = False
            if (self._maxdr2_dev is not None
                    and ssr >= self.drift_check_from
                    and ssr % self.drift_check_every == 0):
                with trace.span("drift poll"):
                    drifted = float(self._maxdr2_dev) ** 0.5 > trig
            if self._last_maxdr is not None and self._last_maxdr > trig:
                drifted = True
            if ssr >= self.rebuild_every or drifted:
                if drifted:
                    tm.count("drift-triggered rebuilds", 1)
                with tm("neighbor rebuild"):
                    self._rebuild(self.state)
                self._last_maxdr = None

            # steps to the next host boundary (print, frame, redraw,
            # rebuild cadence, run end), then the drift budget
            with trace.span("schedule"):
                nb = nsteps - k
                nb = min(nb, cfg.pstep - stepno % cfg.pstep)
                if writer is not None:
                    nb = min(nb, cfg.fstep - stepno % cfg.fstep)
                if cfg.mdmode in (0, 6):
                    nb = min(nb, cfg.sstep - stepno % cfg.sstep)
                nb = min(nb, self.rebuild_every - self._steps_since_rebuild)
                if self._vmax is None and nb >= self.block_steps > 1:
                    # no velocity bound yet (start or redraw): one read
                    self._vmax = float(torch.max(torch.sum(
                        self.state.vel * self.state.vel, dim=1))) ** 0.5
                if self._vmax is not None and self._vmax > 0.0:
                    room = trig - (self._last_maxdr or 0.0)
                    budget = int(room / (1.25 * self._vmax * self.dt))
                    nb = min(nb, max(budget, 1))

            if nb >= self.block_steps > 1:
                with tm("MD block (dispatch)"):
                    out = self._advance(self.block_steps)
                with tm("MD block (end read)"):
                    # one read: the block's drift, max v^2, QEq list and
                    # capacity counts
                    vals = [out.maxdr2[None], out.vmax2[None]] \
                        + self._pending()
                    mdr, vmax2, *pend = torch.cat(
                        [v.double() for v in vals]).tolist()
                    trace.drain()
                    self._check_lists(pend)
                self._last_maxdr = mdr ** 0.5
                self._vmax = vmax2 ** 0.5
                nadv = self.block_steps
                tm.count("MD steps in blocks", nadv)
            else:
                with tm("MD step (dispatch)"):
                    self._advance(1)
                nadv = 1
            k += nadv
            tm.count("MD steps", nadv)
        with trace.span("run end"):
            self._check_lists()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        trace.drain()
        wall = time.perf_counter() - t0
        tm.add("MD loop (wall)", wall, nsteps)
        if profile is not None:
            profile.close()
        if log:
            log(self.printe_line())
            log(f"total (sec): {wall:.4f}  "
                f"atom-steps/s: {self.state.n * nsteps / wall:.3e}")
        return wall

    def describe(self):
        """One line naming what this engine runs."""
        cfg = self.cfg
        charges = ("off" if cfg.isQEq == 0 else
                   ("PQEq" if self.pq is not None else "QEq")
                   + (" full CG" if cfg.isQEq == 1 else " ext. Lagrangian"))
        return (f"engine: pair engine {self.pair_engine}, "
                f"{'closed form' if self.closed_form else 'tables'}, "
                f"{str(self.dtype)[6:]} on {self.device}; charges {charges}"
                f"{'; LG dispersion' if self.ff.is_lg else ''}; taper "
                f"{self.rctap} A; blocks of {self.block_steps} steps, "
                f"{'as CUDA graphs' if self.uses_graphs() else 'eager'}")

    def summary(self):
        """What runs (`describe`), then the end-of-run per-phase timing /
        occupancy / memory report (ref: FinalizeMD main.F90:128-186), its
        "QEq iterations" the sum over every solve (`cg_iters`, one read),
        and the last profiler session's table (utils.timers)."""
        self.timers.counters["QEq iterations"] = int(self.cg_iters)
        return ([self.describe()]
                + self.timers.summary_lines(device=self.device)
                + trace.session_lines())

    # ------------------------------------------------------------------
    @torch.no_grad()
    def bond_table(self, bo_cutoff=0.3):
        """(partner gids (N,kb), bond orders, counts) for .bnd output
        (ref: WriteBND fileio.F90:27-148, BNDcutoff=0.3)."""
        s = self.state
        nbrs = self._build_nbrs(s.pos, s.H, s.types)
        bo = reax.bond_order(s.pos, s.H, s.types, self.img, nbrs, self.ffd)
        return _bond_table_from(bo, nbrs, s.gid, self.img, bo_cutoff)

    def write_frame(self, base_path: str):
        """Write configured trajectory formats (ref: OUTPUT fileio.F90:5-20)."""
        cfg = self.cfg
        names = self.ff.atom_names
        if cfg.is_xyz:
            traj.write_xyz(base_path + ".xyz", self.state, names)
        if cfg.is_pdb:
            traj.write_pdb(base_path + ".pdb", self.state, names)
        if cfg.is_bondfile:
            g, b, c = self.bond_table()
            traj.write_bnd(base_path + ".bnd", self.state, g, b, c)
        if cfg.is_binary:
            refbin.write_rxff_bin(base_path + ".bin", self.state)

    @torch.no_grad()
    def stress(self):
        """Stress tensor [GPa] of the current state: kinetic term plus the
        potential virial (the bonded terms' autograd strain gradient plus
        the pair engine's pair virial) over the volume, on the current
        lists and slot layout (ref: pot.F90:65-72 + main.F90:86-94).  Field and spring forces are not in it, as in
        rxmd_tpu's strain-derivative stress.  Symmetric 3x3 numpy array;
        pressure = trace/3."""
        if not hasattr(self, "nbrs"):
            self._rebuild(self.state)
        s = self.state
        nbrs = self._tight_nbrs(s.pos, s.H, s.types, self.nbrs)
        pairs = self._pair_data(s.pos, s, nbrs, self._layout)
        _, _, w = self._potential(s.pos, s.q, s, nbrs, self.tlists, pairs,
                                  True, s.spos)
        m = (2.0 * self.hmas)[s.types]
        kin = torch.einsum("i,ia,ib->ab", m, s.vel, s.vel)
        vol = torch.abs(torch.linalg.det(s.H))
        sym = 0.5 * (w + w.T)
        return ((kin + sym) / vol * units.USTRS).cpu().numpy()

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
