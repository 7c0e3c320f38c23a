"""Sharded MD engine: 3-D spatial domain decomposition, one process per
domain on torch.distributed (counterpart of rxmd_tpu.parallel.engine).

The reference's MPI rank grid (ref: init.F90:75-100) as a process mesh
(`comm.Comm`): each process owns one subdomain with a fixed resident
capacity `ncap`; rxmd_tpu drives all domains from one process with
shard_map, here each domain is its own process (NCCL on the cards, gloo on
the CPU), so `processors 2 2 2` takes 8 processes.

  REBUILD (every `rebuild_every` steps or on the drift trigger): wrap ->
  migration (COPYATOMS MODE_MOVE, comm.F90:232-270) -> halo plan
  (MODE_COPY, pot.F90:28) -> cell-list neighbor lists with the Verlet
  skin -> bond order and the cached angle / torsion / hbond lists.

  STEP: thermostat -> kick -> drift -> ghost refresh through the saved
  plan -> the pair context -> QEq or PQEq with all-reduced CG scalars and
  a ghost refresh per matvec (MODE_QCOPY1/2, qeq.F90:86-164) -> forces as
  the gradient of this domain's energy, the ghost forces sent home by
  `halo.apply_plan`'s backward (MODE_CPBK) -> kick, drift monitor.

Within a domain the engine runs the single-device code (`reax`, `qeq`,
`pqeq`) in "identity image" mode over rows = residents then ghosts, the
energy summed over resident rows.  Unlike rxmd_tpu, which gives every
extended row a nonbonded list, the nonbonded list, the QEq / PQEq vectors
and the pair context cover the residents only (the ghosts need bonded
rows alone, for their bond orders); the values are the same.  The pair
terms run over the pair list (no sweep, no dense form), as rxmd_tpu routes
its sharded engine (rxmd_tpu/parallel/engine.py:488-499).

The programs rxmd_tpu compiles with shard_map (engine.py:622-741,
949-988) are pure functions here: a step or a K-step block (`_block_fn`,
the thermostat's cadence read on the device from the first step's
number), prepare's evaluation (`_prep_fn`), the optimizer's probe
(`_probe_fn`), the rebuild (`_rebuild_fn`) and the optimizer's resync
(`_resync_fn`), each reading nothing on the host but the CG's chunk
flags.  On a card they run as CUDA graphs through graphs.GraphCache with
their NCCL collectives inside (parallel/comm.py): a key's first use
eagerly, its second captured, later ones replayed; every rank dispatches
the same keys in the same order.  The host reads a rebuild's mesh-wide
counts once (twice when its window's rows outgrow their bucket); the
window it leaves (the Block) is padded to buckets that only grow and are
the same on every rank, so a rebuild within them keeps the programs.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import graphs, neighbors, pqeq, qeq, reax, units
from ..config import RunConfig
from ..ffield import ForceField, effective_maxrc
from ..md import (CAP_NAMES, MDMODES, Engine as MDEngine, _max_or,
                  _over_vector, _skinned_cutoffs, _trim, probe_capacities)
from ..neighbors import _select_k
from ..pairs import PairList
from ..system import State, make_state
from ..utils import timers as trace
from ..utils.timers import Timers
from . import halo
from .comm import Comm, device_for_rank, world


def identity_image(m: int, dtype, device) -> neighbors.ImageTable:
    """Ext rows are real atoms (residents + exchanged ghosts): the owner is
    the identity and the shifts are zero (rxmd_tpu engine.py:44-48)."""
    return neighbors.ImageTable(
        owner=torch.arange(m, device=device),
        shift=torch.zeros((m, 3), dtype=dtype, device=device),
        nimg=(0, 0, 0))


@dataclasses.dataclass
class ShardedState:
    """Per-atom state of one domain, (ncap, ...) rows (`distribute` returns
    all domains' blocks stacked, block d at rows d*ncap:(d+1)*ncap)."""
    frac: torch.Tensor   # global fractional coordinates
    vel: torch.Tensor
    q: torch.Tensor
    qsfp: torch.Tensor
    qsfv: torch.Tensor
    spos: torch.Tensor   # PQEq shell displacement from core (zeros if QEq)
    frac0: torch.Tensor  # initial coordinates (spring restraint reference,
                         # ref: ipos init.F90:231-232); migrates with atoms
    types: torch.Tensor
    gid: torch.Tensor
    valid: torch.Tensor

    def block(self, d, ncap, device=None):
        return ShardedState(**{
            f: getattr(self, f)[d * ncap:(d + 1) * ncap].to(device)
            for f in FIELDS})


FIELDS = tuple(f.name for f in dataclasses.fields(ShardedState))


def factor_mesh(n: int):
    """Factor n into a 3-tuple, largest axis first (like choosing vprocs)."""
    best = (n, 1, 1)
    for a in range(1, n + 1):
        if n % a:
            continue
        for b in range(1, n // a + 1):
            if (n // a) % b:
                continue
            c = n // a // b
            cand = tuple(sorted((a, b, c), reverse=True))
            if max(cand) - min(cand) < max(best) - min(best):
                best = cand
    return best


def distribute(state: State, mesh_shape, ncap) -> ShardedState:
    """Assign atoms to domain blocks by subdomain, on the host (the analog
    of geninit's binning, ref: geninit.F90:493-527): every block of the
    mesh, block d = (ix*ny + iy)*nz + iz, atoms in state order."""
    H = state.H.cpu().numpy()
    Hi = np.linalg.inv(H)
    frac = (state.pos.cpu().numpy() @ Hi.T) % 1.0
    nx, ny, nz = mesh_shape
    ndev = nx * ny * nz
    cell = np.minimum((frac * [nx, ny, nz]).astype(int),
                      np.array([nx, ny, nz]) - 1)
    lin = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]

    def blk(arr):
        arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else arr
        out = np.zeros((ndev * ncap,) + arr.shape[1:], arr.dtype)
        for d in range(ndev):
            sel = np.where(lin == d)[0]
            if len(sel) > ncap:
                raise RuntimeError(f"domain {d} overflows ncap={ncap}")
            out[d * ncap:d * ncap + len(sel)] = arr[sel]
        return torch.as_tensor(out)

    valid = np.zeros(ndev * ncap, bool)
    for d in range(ndev):
        valid[d * ncap:d * ncap + int((lin == d).sum())] = True
    fblk = blk(frac.astype(state.pos.cpu().numpy().dtype))
    return ShardedState(
        frac=fblk, vel=blk(state.vel), q=blk(state.q), qsfp=blk(state.qsfp),
        qsfv=blk(state.qsfv), spos=blk(state.spos), frac0=fblk.clone(),
        types=blk(state.types), gid=blk(state.gid),
        valid=torch.as_tensor(valid))


class Block(NamedTuple):
    """A rebuild's products: ext types and gids, the halo plan, the ext
    rows computed on (`keep`: the residents, the live ghosts, then empty
    ghost rows up to the window's bucket) and their identity image, the
    neighbor lists and the cached term lists (None: uncached terms)."""
    tex: torch.Tensor
    gex: torch.Tensor
    plan: halo.HaloPlan
    keep: torch.Tensor
    img: neighbors.ImageTable
    nbrs: neighbors.Neighbors
    lists: tuple


class Window(NamedTuple):
    """What a step program reads of its rebuild (rxmd_tpu's step_block
    inputs, engine.py:632-633): the Block and the positions the drift is
    measured from."""
    block: Block
    frac_ref: torch.Tensor


class StepOut(NamedTuple):
    """What a step or a block of steps returns, with no host read
    (rxmd_tpu engine.py:667-678, 700-704)."""
    state: ShardedState
    force: torch.Tensor
    comps: torch.Tensor   # (14,) global PE components of the last step
    nq: torch.Tensor      # () int32 CG iterations of the last step
    nq_sum: torch.Tensor  # () summed over the steps
    astr: torch.Tensor    # (6,) accumulated global stress
    stats: torch.Tensor   # float64, the mesh-wide maxima of the steps'
                          # drift^2 and of the final v^2, then the uncached
                          # terms' counts (md.CAP_NAMES), if any
    natoms: torch.Tensor  # () the mesh's residents (rxmd_tpu's diag)


class ProbeIn(NamedTuple):
    """An optimizer probe's input (`ShardedEngine._probe_fn`)."""
    state: ShardedState   # the engine's state (its rows stay as they are)
    pos: torch.Tensor     # (ncap, 3) the probe's block positions
    rows: int             # ghost rows kept (live ghosts, then empty rows)
    brows: int            # rows that may get bonded lists
    ccap: int             # the cell grid's depth


class ProbeOut(NamedTuple):
    """What a probe returns (rxmd_tpu engine.py:971: PE, forces, charges)."""
    pe: torch.Tensor      # () global potential energy
    force: torch.Tensor   # (ncap, 3)
    q: torch.Tensor       # (ncap,)
    nq: torch.Tensor      # () CG iterations
    counts: torch.Tensor  # int64, PROBE_COUNTS' order, mesh-wide maxima


# a probe's counts, in ProbeOut.counts' order: the largest halo send, the
# largest bonded and nonbonded rows, the densest cell, the live ghosts,
# the ghosts within the bonded depth plus the residents, then the uncached
# terms' counts of md.CAP_NAMES
PROBE_COUNTS = ("halo", "kb", "knb", "cells", "ghosts", "bonded") + CAP_NAMES


class RebuildIn(NamedTuple):
    """A rebuild's input (`ShardedEngine._rebuild_fn`)."""
    state: ShardedState   # the domain's state, its atoms not yet migrated
    rows: int             # ghost rows kept (live first, then empty rows)
    ccap: int             # the cell grid's depth


class RebuildOut(NamedTuple):
    """What a rebuild returns (rxmd_tpu's rebuild_fn, engine.py:622-628)."""
    state: ShardedState   # wrapped and migrated
    block: Block          # the plan and lists over `rows` ghost rows
    diag: torch.Tensor    # int64, REBUILD_COUNTS' order, mesh-wide maxima


# a rebuild's counts, in RebuildOut.diag's order: the largest migration
# send, the atoms without a free slot, the largest halo send, the largest
# bonded and nonbonded rows, the angle, torsion and hbond lists' entries
# (0 for uncached terms), the live ghosts and the densest cell
REBUILD_COUNTS = ("mig", "lost", "halo", "kb", "knb", "ang", "tor", "hbf",
                  "ghosts", "cells")


class ShardedEngine:
    """MD engine of one domain of a 3-D mesh, one process per domain.

    `mesh_shape` defaults to `factor_mesh(world size)`; its product must
    equal the number of processes in the torch.distributed group (one
    process without a group runs mesh (1, 1, 1)).  `device` "cuda" takes
    card rank % device_count and needs one (it never moves to the CPU by
    itself); "cpu" runs the plain PyTorch path, over gloo.  `rctap` and
    `skin_layers` are the knobs rxmd_tpu's dry run turns down: below the
    defaults (the taper cutoff, three bonded layers) the physics is cut.
    `mcap` bounds the atoms one migration message carries (default a
    quarter of the resident capacity)."""

    def __init__(self, ff: ForceField, state: State, cfg: RunConfig,
                 mesh_shape=None, dtype=None, device="cuda", mcap=None,
                 rctap=None, skin_layers=3.0):
        if mesh_shape is None:
            mesh_shape = factor_mesh(world()[1])
        self.comm = comm = Comm(mesh_shape)
        self.mesh_shape = comm.mesh_shape
        self.ndev = ndev = comm.size
        device = device_for_rank(comm.rank, device)
        dtype = dtype or getattr(torch, cfg.dtype)
        missing = [name for c, name in (
            (cfg.mdmode not in MDMODES, f"mdmode={cfg.mdmode}"),
            (cfg.isQEq not in (0, 1, 2), f"isQEq={cfg.isQEq}"),
            (cfg.tighten_lists, "tighten_lists"),
        ) if c]
        if missing:
            raise NotImplementedError(
                "the sharded engine has no path for " + ", ".join(missing))
        if cfg.pair_kernel:
            raise ValueError("pair_kernel=True: the sharded engine runs the "
                             "pair list, never the pair sweep")
        H = state.H.cpu().numpy()
        if not np.allclose(H, np.diag(np.diag(H))):
            raise NotImplementedError(
                "ShardedEngine assumes an orthogonal box (the fractional "
                "halo skins are per-axis slabs); use md.Engine for "
                "triclinic cells")
        if cfg.mdmode == 0:
            # ref: init.F90:56-63, on a copy: the caller's RunConfig keeps
            # its own
            cfg = dataclasses.replace(cfg, isQEq=1)
        if rctap is None:
            rctap = units.RCTAP0_PQEQ if cfg.isPQEq else units.RCTAP0
        self.rctap = rctap = float(rctap)
        self.pq = None
        if cfg.isPQEq:
            par = pqeq.parse_pqeq_par(cfg.pqeq_parm_path)
            # chi/eta overrides before the FFDev, on a copy: the caller's
            # ForceField keeps its own (rxmd_tpu writes them into it)
            ff = pqeq.apply_to_ff(dataclasses.replace(
                ff, chi=ff.chi.copy(), eta=ff.eta.copy()), par)
            self.pq = pqeq.make_pqeq(par, dtype=dtype, rctap=rctap,
                                     device=device)
            tmax = int(state.types.max())
            if tmax >= self.pq.ntype:
                raise ValueError(
                    f"atom type {tmax} has no PQEq parameters "
                    f"({self.pq.ntype} rows in {cfg.pqeq_parm_path})")
        self.ff, self.cfg = ff, cfg
        self.device, self.dtype = device, dtype
        self.n = state.n
        self.ffd = reax.ffdev_from(ff, dtype=dtype, rctap=rctap,
                                   device=device)
        state0 = state.astype(dtype)
        self.step0 = int(state.step)
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.Hg = f(H)
        self.Hi = f(np.linalg.inv(H))
        L = np.diag(H)
        self.closed_form = (cfg.nonbond_closed_form
                            if cfg.nonbond_closed_form is not None
                            else dtype == torch.float32)

        maxrc = effective_maxrc(ff, state.types.cpu().numpy())
        self.skin_nb = cfg.nbr_skin
        # ghost skin: 3*maxrc covers the deepest bonded dependency chain
        # (resident energy -> BO(k,l) with l at 2rc -> deltap(l) needing
        # positions at 3rc); the taper cutoff covers nonbond and QEq; plus
        # the Verlet drift margin (the reference: NMINCELL cell layers,
        # pot.F90:28)
        skin = max(float(skin_layers) * maxrc, rctap) + self.skin_nb + 0.1
        self.skin = skin
        local = L / np.asarray(self.mesh_shape)
        if (local < skin).any() and max(self.mesh_shape) > 1:
            raise RuntimeError(
                f"local box {local} smaller than skin {skin}; use fewer "
                "domains or a larger system (the same constraint as the "
                "reference's cell decomposition)")
        self.ncap = ncap = int(np.ceil(state.n / ndev * 1.6 / 8)) * 8
        # ghost buffer: the volume ratio of the skin expansion, with margin
        grow = np.prod(1 + 2 * skin / local) - 1.0
        self.bcap = bcap = int(np.ceil(ncap * max(grow, 1.0) / 3.0)) + 32
        # migration buffer: atoms crossing during a whole rebuild window
        self.mcap = min(mcap or max(64, ncap // 4), ncap)
        self.spec = halo.HaloSpec(mesh_shape=self.mesh_shape,
                                  skin_frac=tuple(skin / L), ncap=ncap,
                                  bcap=bcap)
        self.mext = ncap + 6 * bcap
        self.mylo = f(np.asarray(comm.coords) / np.asarray(self.mesh_shape))
        self._local = f(local)
        # the rows a window holds, padded to buckets that only grow
        # (md.Engine._size) and the same on every rank, so the programs
        # captured over one window serve the next: the live ghosts (at
        # most `ghost_cap`), in a probe also the rows with bonded lists
        # (at most `bond_cap`); a count past a cap raises, naming it
        self.ghost_cap = 6 * bcap
        self.bond_cap = self.mext
        self._sizes = {}

        self.term_cache = cfg.term_cache
        self.term_slack = cfg.term_slack if self.term_cache else 1.0
        self.term_margin = cfg.term_margin if self.term_cache else 0.0
        # ghosts farther from the domain than this need no bonded rows: a
        # resident's energy reads bond orders out to two bonded layers
        # (whose rows reach the third); the skinned lists, the term lists'
        # margin and the drift between rebuilds add to it
        self.bond_depth = (max(float(skin_layers) - 1.0, 0.0) * maxrc
                           + 2.0 * (self.skin_nb + self.term_margin) + 0.1)
        # capacities from a probe of the whole configuration; the flat
        # term-list capacities are per domain: resident centers divide
        # across domains (4x headroom for density imbalance; an overflow
        # is checked at every rebuild and aborts)
        kb, knb, caps = probe_capacities(
            ff, state0.to(device), self.ffd, rctap, skin=self.skin_nb,
            term_slack=self.term_slack, term_margin=self.term_margin)
        self.kb = cfg.kb_cap or kb
        self.knb = cfg.knb_cap or knb
        self.caps = dict(caps)
        if ndev > 1:
            for k in ("ang", "tor", "hbf"):
                self.caps[k] = min(caps[k], -(-caps[k] * 4 // ndev) + 256)
        self.rc2b_ext, self.rctap2_ext = _skinned_cutoffs(self.ffd, rctap,
                                                          self.skin_nb)
        # local cell grid over the skin-extended subdomain; its cell
        # capacity grows to the densest cell a build meets
        self.grid = neighbors.make_cell_grid(
            -skin * np.ones(3), local + skin, max(maxrc + self.skin_nb, 2.0),
            rctap + self.skin_nb)

        self.dt = cfg.dt_fs / units.UTIME
        self.lex_w2 = 2.0 * cfg.Lex_k / self.dt / self.dt
        self.dthm = f(self.dt * 0.5 / ff.mass)
        self.hmas = f(0.5 * ff.mass)
        self.treq_red = cfg.treq / units.UTEMP0

        self.rebuild_every = cfg.rebuild_every
        lim = self.skin_nb
        if self.term_margin > 0.0:
            lim = min(lim, self.term_margin)
        self.drift_trigger = 0.5 * lim
        self.drift_check_from = 4
        self.drift_check_every = 2
        # steps per block (rxmd_tpu engine.py:731), the schedule's
        # velocity bound and last block drift (md.Engine.run)
        self.block_steps = max(int(cfg.block_steps), 1)
        self._vmax = self._last_maxdr = None

        self._spring_types = (torch.as_tensor(
            list(cfg.spring_types), device=device) if cfg.spring_types
            else None)

        self.sstate = distribute(state0, self.mesh_shape, ncap).block(
            comm.rank, ncap, device)
        self.step_count = self.step0
        # CG iterations summed over every solve (on the device)
        self.cg_iters = torch.zeros((), dtype=torch.int64, device=device)
        self.timers = Timers()
        # the programs (graphs.GraphCache, on a card): steps, blocks and
        # prepare in one cache, the optimizer's probes in their own
        self.graphs = True
        self._graphs = self._probe_graphs = None
        # the rebuild and the optimizer's resync: a cache of their own,
        # which a window's new shapes never drop
        self._rebuild_graphs = None
        self._window_id = 0
        self._over = None     # the steps' uncached-term counts, unchecked

    # ------------------------------------------------------------------
    def _migrate(self, s: ShardedState, extras: dict = None):
        """Move atoms whose coordinate left the local box to the face
        neighbor, one axis at a time (COPYATOMS MODE_MOVE semantics,
        comm.F90:232-270,440; rxmd_tpu engine.py:299-355).  `extras` are
        (ncap, ...) tensors that ride with the atoms (the optimizer's
        MigrateVec3D, ref: cg.F90:292-314).  Returns (state, extras,
        mig_max, lost): the largest send count, for the overflow trap of
        mcap (ref: comm.F90:467-472), and the atoms that found no free
        resident slot (ncap)."""
        comm, ncap, mcap = self.comm, self.ncap, self.mcap
        dev = s.frac.device
        payload = {k: getattr(s, k) for k in FIELDS if k != "valid"}
        payload.update(extras or {})
        fkeys = [k for k, v in payload.items() if v.is_floating_point()]
        ikeys = [k for k in payload if k not in fkeys]
        widths = {k: (payload[k].shape[1] if payload[k].ndim > 1 else 0)
                  for k in payload}
        valid = s.valid
        mig_max = torch.zeros((), dtype=torch.int64, device=dev)
        lost = torch.zeros((), dtype=torch.int64, device=dev)
        slot = torch.arange(mcap, device=dev)

        def pack(keys, rows):
            return torch.cat([payload[k][rows].reshape(rows.shape[0], -1)
                              for k in keys], dim=1)

        def unpack(buf, keys):
            out, c = {}, 0
            for k in keys:
                w = max(widths[k], 1)
                col = buf[:, c:c + w]
                out[k] = col if widths[k] else col[:, 0]
                c += w
            return out

        for ax in range(3):
            n = self.mesh_shape[ax]
            if n == 1:
                continue
            my = comm.coords[ax]
            for d in (+1, -1):
                if n == 2 and d == -1:
                    break      # both directions are one neighbor: send once
                target = torch.clamp((payload["frac"][:, ax] * n).long(), 0,
                                     n - 1)
                go = valid & (target == (my + d) % n)
                sel = _select_k(go[None], mcap)[0]
                ok = sel >= 0
                rows = torch.where(ok, sel, 0)
                cnt = go.sum()
                mig_max = torch.maximum(mig_max, cnt)
                sf = torch.where(ok[:, None], pack(fkeys, rows), 0.0)
                si = torch.where(ok[:, None], pack(ikeys, rows), 0)
                rf = comm.shift(sf, ax, d)
                ri = comm.shift(si, ax, d)
                rcnt = comm.shift(cnt.reshape(1), ax, d)[0]
                # drop the senders, then place the received atoms into the
                # lowest free slots
                valid = valid & ~go
                free = _select_k((~valid)[None], mcap)[0]
                arrived = slot < torch.clamp(rcnt, max=mcap)
                place = arrived & (free >= 0)
                lost = lost + (arrived & (free < 0)).sum()
                # the placed atoms' rows; the others go to a dump row past
                # the residents, which is cut off
                dst = torch.where(place, free, ncap)
                recv = {**unpack(rf, fkeys), **unpack(ri, ikeys)}
                for k in payload:
                    v = torch.cat([payload[k], payload[k][:1]])
                    v[dst] = recv[k].to(v.dtype)
                    payload[k] = v[:ncap]
                valid = torch.cat([valid, valid[:1]])
                valid[dst] = True
                valid = valid[:ncap]
        out_extras = {k: payload.pop(k) for k in (extras or {})}
        return (ShardedState(valid=valid, **payload), out_extras, mig_max,
                lost)

    def _near(self, frac_ext, valid_ext):
        """Positions relative to the domain's origin, and the live rows
        within the bonded dependency depth of the domain (`bond_depth`:
        two bonded layers and the drift; the ghosts beyond only give
        positions to the nonbond and the third bonded layer)."""
        pos_rel = (frac_ext - self.mylo) @ self.Hg.T
        out = torch.clamp(torch.maximum(-pos_rel, pos_rel - self._local),
                          min=0.0)
        near = torch.sum(out * out, dim=1) <= self.bond_depth ** 2
        return pos_rel, valid_ext & near

    def _neighbors(self, pos_rel, valid_ext, tex, bond_rows, grid):
        """Skinned lists of this domain over the ext rows at `pos_rel`:
        nonbonded rows for the live residents, bonded rows for `bond_rows`
        (-1 padded), other rows empty.  Returns (lists, the densest cell,
        which must fit `grid.ccap`)."""
        nbrs, occ = neighbors.build_neighbors_cells(
            pos_rel, valid_ext, tex, grid, self.rc2b_ext, self.rctap2_ext,
            self.kb, self.knb, nb_rows=self.ncap, bond_rows=bond_rows)
        vr = valid_ext[:self.ncap]
        return nbrs._replace(idxnb=torch.where(vr[:, None], nbrs.idxnb, -1),
                             cntnb=torch.where(vr, nbrs.cntnb, 0)), occ

    def _window_rows(self, s: ShardedState, rows, brows, ccap):
        """A fresh halo plan of `s` and the skinned lists over its rows:
        the residents, then the ghost rows compacted to `rows` (live
        first), bonded lists for up to `brows` rows within the bonded
        depth, over the cell grid of depth `ccap`; no host read.  Returns
        (Block without term lists, the rows' positions relative to the
        domain, the live-ghost mask, the near-row mask, the densest
        cell)."""
        spec, comm, ncap, dev = self.spec, self.comm, self.ncap, self.device
        plan, frac_ext, valid_ext = halo.build_plan(s.frac, s.valid, spec,
                                                    comm)
        ghost = valid_ext[ncap:]
        order = torch.argsort((~ghost).to(torch.int8), stable=True)
        keep = torch.cat([torch.arange(ncap, device=dev),
                          ncap + order[:rows]])
        tex = halo.apply_plan(plan, s.types, spec, comm)[keep]
        gex = halo.apply_plan(plan, s.gid, spec, comm)[keep]
        pos_rel, near = self._near(frac_ext[keep], valid_ext[keep])
        nbrs, occ = self._neighbors(
            pos_rel, valid_ext[keep], tex, _select_k(near[None], brows)[0],
            self.grid._replace(ccap=ccap))
        img = identity_image(keep.shape[0], self.dtype, dev)
        return (Block(tex, gex, plan, keep, img, nbrs, None), pos_rel, ghost,
                near, occ)

    def _term_lists(self, pos_rel, tex, gex, img, nbrs, amask, slack,
                    margin):
        """The cached angle / torsion / hbond lists over the residents'
        centers (not cut to their counts)."""
        bo = reax.bond_order(pos_rel, self.Hg, tex, img, nbrs, self.ffd)
        caps, ffd = self.caps, self.ffd
        kw = dict(slack=slack, margin=margin)
        return (
            reax.build_angle_list(tex, img, nbrs, bo, amask, ffd,
                                  cap=caps["ang"], ks=caps["ks"],
                                  rowcap=caps["ang_row"], **kw),
            reax.build_torsion_list(tex, gex, img, nbrs, bo, amask, ffd,
                                    cap=caps["tor"], ks=caps["ks"],
                                    rowcap=caps["tor_row"], **kw),
            reax.build_hbond_list(pos_rel, self.Hg, tex, img, nbrs, bo, amask,
                                  ffd, cap=caps["hbf"], kh=caps["kh"],
                                  rowcap=caps["hb_row"], **kw))

    def _rebuild_fn(self, carry: RebuildIn):
        """A rebuild as a program (rxmd_tpu's rebuild_fn, engine.py:406-461,
        622-628): wrap + migrate + halo plan + skinned neighbor lists over
        the cell grid of depth `carry.ccap` + term lists (with
        `term_cache`, at their full capacities), and the mesh-wide maxima
        of every count (`diag`).  The domain computes over the residents'
        ncap rows, then the live ghost rows, then empty ghost rows up to
        `carry.rows`; the empty rows of the fixed-capacity ghost blocks
        never enter a list or a sum.  It reads the engine's constants,
        mutates nothing and reads nothing on the host, so a CUDA graph
        can hold it with its sends, receives and all-reduce."""
        s, rows, ccap = carry
        ncap, dev = self.ncap, self.device
        with trace.phase("rebuild"):
            frac = torch.where(s.valid[:, None], torch.remainder(s.frac, 1.0),
                               0.0)
            s, _, mig_max, lost = self._migrate(dataclasses.replace(
                s, frac=frac))
            m = ncap + rows
            block, pos_rel, ghost, _, occ = self._window_rows(s, rows, m,
                                                             ccap)
            lists, cnts = None, [mig_max.new_zeros(())] * 3
            if self.term_cache:
                amask = torch.zeros(m, dtype=torch.bool, device=dev)
                amask[:ncap] = s.valid
                lists = self._term_lists(pos_rel, block.tex, block.gex,
                                         block.img, block.nbrs, amask,
                                         self.term_slack, self.term_margin)
                cnts = [lst.cnt for lst in lists]
        nbrs = block.nbrs
        diag = self.comm.pmax(torch.stack([t.to(torch.int64) for t in (
            mig_max, lost, block.plan.cnt_send.max(), nbrs.cntb.max(),
            nbrs.cntnb.max(), *cnts, ghost.sum(), occ)]))
        return RebuildOut(s, block._replace(lists=lists), diag)

    _size = MDEngine._size

    def _rows(self, name, n, attr):
        """The bucket of `n` rows of `name` (`_size`), raising if `n`
        passes the capacity `attr` names (every rank reads the same n)."""
        cap = getattr(self, attr)
        if n > cap:
            raise RuntimeError(f"{name}: {n} > capacity {cap} ({attr})")
        # never more rows than the ghost blocks or the ext rows hold
        return self._size(name, n, min(cap, self.mext if attr == "bond_cap"
                                       else 6 * self.bcap))

    def _check_diag(self, d, caps=None):
        """Abort on any buffer or list overflow on any domain (ref:
        comm.F90:467-472, main.F90:402-407): `d` is the mesh-wide maximum
        (migration, lost atoms, halo sends, bonded and nonbonded rows,
        then with `caps` the angle, torsion and hbond lists), so every rank
        raises alike."""
        mig, lost, hal, mb, mnb = d[:5]
        if mig > self.mcap:
            raise RuntimeError(
                f"migration buffer overflow: {mig} > mcap={self.mcap} "
                "(the reference aborts too, comm.F90:467-472)")
        if lost:
            raise RuntimeError(
                f"resident capacity overflow: {lost} migrated atoms found no "
                f"free slot (ncap={self.ncap})")
        if hal > self.bcap:
            raise RuntimeError(
                f"ghost buffer overflow: {hal} > bcap={self.bcap} "
                "(the reference aborts too, comm.F90:467-472)")
        if mb > self.kb or mnb > self.knb:
            raise RuntimeError(f"neighbor-list overflow: bonded {mb}/"
                               f"{self.kb} nonbonded {mnb}/{self.knb}")
        self.timers.peak("bonded nbr list", mb, self.kb)
        self.timers.peak("nonbonded nbr list", mnb, self.knb)
        if caps is None:
            return
        got = d[5:8]
        rows = [nm for nm, g in zip(("ang_row", "tor_row", "hb_row"), got)
                if g >= reax.ROW_OVERFLOW]
        if rows:
            raise RuntimeError(
                f"interaction-list PER-ROW overflow in {'/'.join(rows)}: "
                f"raise the corresponding *_row capacities (caps={self.caps})")
        if any(g > c for g, c in zip(got, caps)):
            raise RuntimeError(
                f"interaction-list overflow: angles {got[0]}/{caps[0]} "
                f"torsions {got[1]}/{caps[1]} hbonds {got[2]}/{caps[2]} "
                "(ref aborts too, main.F90:402-407)")
        for name, g, c in zip(("angle list", "torsion list", "hbond list"),
                              got, caps):
            self.timers.peak(name, g, c)

    # md.Engine's messages for the uncached terms' capacities (`caps`)
    _check_over = MDEngine._check_over
    _list_overflow = MDEngine._list_overflow

    def _check_lists(self, vals=None):
        """Raise if an uncached term list of the steps since the last check
        passed its capacity (md.Engine._check_lists): one host read of the
        mesh-wide counts, none if `vals` holds them already."""
        if self._over is None:
            return
        vals = self._over.tolist() if vals is None else vals
        self._over = None
        self._check_over(dict(zip(CAP_NAMES, (int(v) for v in vals))))

    def rebuild(self):
        """Wrap, migrate and rebuild the plan and the lists: the rebuild
        program (`_rebuild_fn`) as a CUDA graph where `uses_graphs()` (a
        cache of its own, keyed by its ghost rows and cell depth), else
        eagerly, then one host read of its mesh-wide counts together with
        the steps' uncached-term counts since the last check, the same on
        every rank.  The steps' lists are checked first (`_check_lists`),
        then every count against its capacity (`_check_diag`, `_rows`).
        The ghost rows come from the window's bucket (`_size`; at the
        first rebuild every ghost row, cut to the bucket after the read),
        the term lists at their capacities are cut to theirs; a rebuild
        whose live ghosts outgrow the bucket, or whose densest cell the
        grid's depth, grows it and runs again (a second read)."""
        pend = [] if self._over is None else [self._over.double()]
        while True:
            carry = RebuildIn(self.sstate,
                              self._sizes.get("ghost rows", 6 * self.bcap),
                              self.grid.ccap)
            self.timers.count("rebuilds", 1)
            with trace.span("dispatch"):
                out = self._dispatch(
                    "_rebuild_graphs", "rebuild",
                    lambda _, c, loop: self._rebuild_fn(c), (), carry, 0)
            with trace.span("read"):
                vals = [int(v) for v in torch.cat(
                    [out.diag.double()] + pend).tolist()]
            trace.drain()
            d = vals[:len(REBUILD_COUNTS)]
            if pend:
                self._check_lists(vals[len(d):])
                pend = []
            got = dict(zip(REBUILD_COUNTS, d))
            lists = out.block.lists
            caps = None if lists is None else [lst.valid.shape[0]
                                               for lst in lists]
            grown = got["cells"] > carry.ccap
            if grown:
                # a cell fuller than the grid's capacity deepens the
                # grid's cells and the rebuild runs again
                self.grid = self.grid._replace(
                    ccap=int(got["cells"] * 1.25) + 2)
            else:
                self._check_diag(d, caps)
            rows = self._rows("ghost rows", got["ghosts"], "ghost_cap")
            grown |= rows > carry.rows
            if not grown:
                break
            self.timers.count("rebuild regrowths", 1)
        # the bucket's rows: the live ghosts come first, so the rows past
        # it are empty and no list reads them
        m = self.ncap + rows
        tex, gex, plan, keep, _, nbrs, _ = out.block
        nbrs = nbrs._replace(idxb=nbrs.idxb[:m], cntb=nbrs.cntb[:m])
        if lists is not None:
            lists = tuple(_trim(lst, self._size(nm, got[nm], cap))
                          for lst, nm, cap in zip(lists, ("ang", "tor", "hbf"),
                                                  caps))
        self.sstate = out.state
        self._block = Block(tex[:m], gex[:m], plan, keep[:m],
                            identity_image(m, self.dtype, self.device), nbrs,
                            lists)
        self._frac_ref = self.sstate.frac
        self._steps_since_rebuild = 0
        self._maxdr2 = None
        self._window_id += 1

    # ------------------------------------------------------------------
    def _compute(self, s: ShardedState, block, do_qeq, prep=False,
                 loop=None, counts=None):
        """Ghost refresh + pair context + QEq/PQEq + forces + virial for the
        domain's configuration `s` over the saved plan and lists
        (rxmd_tpu engine.py:464-609); `loop` runs the CG's chunks, and
        with uncached terms (`block.lists` None) `counts` (a dict) takes
        their counts.  Returns (q, qsfp, qsfv, spos, force on the
        residents, global PE components, global virial (3, 3), CG
        iterations)."""
        tex, gex, plan, keep, img, nbrs, lists = block
        spec, comm, cfg = self.spec, self.comm, self.cfg
        ncap, dtype, dev = self.ncap, self.dtype, self.device
        ffd = self.ffd
        valid = s.valid
        resident_ext = torch.zeros(keep.shape[0], dtype=torch.bool,
                                   device=dev)
        resident_ext[:ncap] = valid

        def refresh(x, is_frac=False):
            return halo.apply_plan(plan, x, spec, comm, is_frac)[keep]
        frac_ext = refresh(s.frac, is_frac=True)
        pos_rel = (frac_ext - self.mylo) @ self.Hg.T
        tr = tex[:ncap]

        ctx = rows_pre = None
        if self.pq is None:
            with trace.phase("pairs"):
                ctx = reax.nb_ctx(pos_rel, None, self.Hg, tex, img, nbrs, gex,
                                  resident_ext, ffd)
                if not self.closed_form:
                    rows_pre = reax.pair_rows(ctx, tr, ffd)

        # the extended Lagrangian's cold start is a full CG
        isqeq = 1 if (prep and cfg.isQEq == 2) else cfg.isQEq
        spos_new = s.spos
        q_new = s.q
        nq = torch.zeros((), dtype=torch.int32, device=dev)
        if isqeq and do_qeq:
            with trace.phase("qeq"):
                if self.pq is not None:
                    qn, sp, nq, _ = pqeq.solve(
                        pos_rel, refresh(s.spos), s.q, s.qsfp, self.Hg, tex,
                        img, nbrs, ffd, self.pq, amask=valid, isqeq=isqeq,
                        nmax=cfg.NMAXQEq, tol=cfg.QEq_tol,
                        lex_fqs=cfg.Lex_fqs,
                        efield_dir=cfg.eFieldDir if cfg.isEfield else None,
                        efield_strength=cfg.eFieldStrength,
                        allreduce=self.comm.psum, refresh=refresh, loop=loop)
                    spos_new = torch.where(valid[:, None], sp, 0.0)
                else:
                    res = qeq.solve(
                        s.q, s.qsfp, tr, ffd, PairList.operator(
                            ctx, rows_pre, tr, ffd, img, nbrs,
                            refresh=refresh, resident_ext=resident_ext),
                        amask=valid, isqeq=isqeq, nmax=cfg.NMAXQEq,
                        tol=cfg.QEq_tol, lex_fqs=cfg.Lex_fqs,
                        allreduce=self.comm.psum, loop=loop)
                    qn, nq = res.q, res.iters
            q_new = torch.where(valid, qn, 0.0)
        if isqeq == 1 and do_qeq and not (prep and cfg.isQEq == 2):
            # fictitious charges re-seeded from pre-QEq q (qeq.F90:42-43)
            qsfp, qsfv = s.q, torch.zeros_like(s.qsfv)
        elif prep and cfg.isQEq == 2:
            qsfp, qsfv = q_new, torch.zeros_like(s.qsfv)
        else:
            qsfp, qsfv = s.qsfp, s.qsfv
        q_ext = refresh(q_new)
        spos_ext = refresh(spos_new)

        # this domain's energy; its gradient reaches the ghosts' owners
        # through apply_plan's backward (MODE_CPBK)
        frac_res = s.frac.detach().requires_grad_(True)
        eps = torch.zeros((3, 3), dtype=dtype, device=dev,
                          requires_grad=True)
        with trace.phase("bonded"), torch.enable_grad():
            strain = torch.eye(3, dtype=dtype, device=dev) + eps
            fx = refresh(frac_res, is_frac=True)
            pr = ((fx - self.mylo) @ self.Hg.T) @ strain.T
            comps_l = reax.energy_components(
                pr, q_ext, strain @ self.Hg, tex, gex, img, nbrs, ffd,
                lists, amask=resident_ext, caps=self.caps,
                include_nonbond=self.pq is not None, pq=self.pq,
                spos=spos_ext, counts=counts if lists is None else None)
            g, ge = torch.autograd.grad(comps_l[0], (frac_res, eps))
        # d E / d pos = dE/dfrac Hi  (pos = frac H^T)
        f = -(g @ self.Hi)
        # each domain's eps gradient is its own share of the strain
        # derivative: summed over the domains once, below
        parts = [comps_l.detach(), -ge.reshape(-1)]
        if ctx is not None:
            with trace.phase("nonbond"):
                ctx = ctx._replace(qj=q_ext[ctx.idx])
                evdw, eclmb, echarge, f_nb, w_nb = \
                    reax.nonbond_ctx_energy_forces(
                        ctx, q_new, tr, valid, ffd, self.closed_form,
                        with_virial=True, pre=rows_pre, img=img)
            f = f + f_nb
            parts[0] = torch.cat([comps_l.detach()[:11],
                                  torch.stack([evdw, eclmb, echarge])])
            parts.append(w_nb.reshape(-1))
        f_extra = self._external_forces(s, q_new)
        if f_extra is not None:
            f = f + f_extra
            # every force enters the sum pos.f stress (ref: pot.F90:60-72)
            pos_abs = s.frac @ self.Hg.T
            parts.append(torch.einsum("ia,ib->ab", f_extra,
                                      pos_abs).reshape(-1))
        red = self.comm.psum(torch.cat(parts))
        comps = torch.cat([red[1:14].sum()[None], red[1:14]])
        w = red[14:23].reshape(3, 3)
        for k in range(23, red.shape[0], 9):
            w = w + red[k:k + 9].reshape(3, 3)
        f = torch.where(valid[:, None], f, 0.0)
        return q_new, qsfp, qsfv, spos_new, f, comps, w, nq

    def _external_forces(self, s: ShardedState, q):
        """Electric-field and spring forces on the residents, or None."""
        cfg = self.cfg
        f_extra = None
        if cfg.isEfield:
            # constant field on the core charges, q + Z under PQEq
            # (ref: EEfield module.F90:359-383)
            qc = q if self.pq is None else q + self.pq.Z[s.types]
            f_extra = torch.zeros_like(s.frac)
            f_extra[:, cfg.eFieldDir] = torch.where(
                s.valid, -qc * cfg.eFieldStrength * units.EEV_KCAL, 0.0)
        if cfg.spring_const:
            # minimum-image displacement from the initial configuration
            # (ref: SpringForce pot.F90:95-110)
            dfr = s.frac - s.frac0
            dfr = dfr - torch.round(dfr)
            fs = -cfg.spring_const * (dfr @ self.Hg.T)
            keep = s.valid
            if self._spring_types is not None:
                keep = keep & torch.isin(s.types, self._spring_types)
            fs = torch.where(keep[:, None], fs, 0.0)
            f_extra = fs if f_extra is None else f_extra + fs
        return f_extra

    # ------------------------------------------------------------------
    def _zero_momentum(self, s: ShardedState, v):
        """Remove the global center-of-mass momentum (ref:
        main.F90:766-797)."""
        m = torch.where(s.valid, (2.0 * self.hmas)[s.types], 0.0)
        red = self.comm.psum(torch.cat([torch.sum(m[:, None] * v, dim=0),
                                   torch.sum(m)[None]]))
        return torch.where(s.valid[:, None], v - (red[:3] / red[3])[None],
                           0.0)

    def _ke_sum(self, s: ShardedState, v):
        return torch.sum(torch.where(
            s.valid, self.hmas[s.types] * torch.sum(v * v, dim=1), 0.0))

    def _thermostat(self, s: ShardedState, do_scale):
        """mdmode-dispatched velocity scaling with global reductions (ref:
        main.F90:45-61), md.Engine._thermostat's rules: velocities at rest
        stay at rest.  `do_scale` is a device bool (rxmd_tpu
        engine.py:370-403): the scaled velocities are computed every step
        and taken where it is set."""
        cfg = self.cfg
        if cfg.mdmode not in (4, 5, 7, 8):
            return s
        v = s.vel
        t0 = self.treq_red * units.UTEMP0
        if cfg.mdmode == 4:
            v2 = cfg.vsfact * v
        elif cfg.mdmode == 5:
            ke = self.comm.psum(self._ke_sum(s, v))
            ctmp = t0 / (ke / self.n * units.UTEMP)
            v2 = torch.where(ke > 0, torch.sqrt(ctmp), 1.0) * v
        elif cfg.mdmode == 7:
            # per-element rescale to treq (ref: main.F90:722-763)
            nso = self.hmas.shape[0]
            w = s.valid.to(v.dtype)
            z = torch.zeros(nso, dtype=v.dtype, device=v.device)
            red = self.comm.psum(torch.cat([
                z.index_add(0, s.types, w),
                z.index_add(0, s.types, w * self.hmas[s.types]
                            * torch.sum(v * v, dim=1))]))
            cnt, ket = red[:nso], red[nso:]
            ctmp = torch.where(cnt > 1.0, ket / torch.clamp(cnt, min=1.0),
                               1.0)
            scale = torch.sqrt(t0 / (ctmp * units.UTEMP))
            fac = torch.where(cnt > 1.0, torch.where(ket > 0, scale, 1.0),
                              0.0)
            v2 = self._zero_momentum(s, fac[s.types][:, None] * v)
        else:
            # rescale only if >5% off target (ref: main.F90:684-718)
            ke = self.comm.psum(self._ke_sum(s, v)) / self.n
            ctmp = torch.sqrt(t0 / (ke * units.UTEMP))
            need = (ke > 0) & (torch.abs(ctmp - 1.0) > 0.05)
            v2 = torch.where(need, self._zero_momentum(s, ctmp * v), v)
        v = torch.where(do_scale, v2, v)
        return dataclasses.replace(
            s, vel=torch.where(s.valid[:, None], v, 0.0))

    # ------------------------------------------------------------------
    # The programs (rxmd_tpu engine.py:622-741): pure functions of their
    # inputs that read the engine's constants, mutate nothing and read
    # nothing on the host but the CG's chunk flags, so a CUDA graph can
    # hold them with their collectives; `_dispatch` runs them.
    def uses_graphs(self):
        """Whether the programs run as CUDA graphs: on a card, for every
        configuration, unless `graphs` is off; tracing leaves them on
        (its marks are the device's own, utils/timers.py)."""
        return self.graphs and self.device.type == "cuda"

    _run_graph = MDEngine._run_graph

    def _dispatch(self, cache, key, fn, window, carry, window_id):
        """fn(window, carry, loop) through the GraphCache named `cache`
        where `uses_graphs()` (every rank dispatches the same keys in the
        same order, so their collectives pair up), else eagerly; the
        device marks inside are keyed by the program's kind: `key` where
        it is a name, else "step" or "block" (`_advance`'s (K, do_qeq))."""
        kind = key if isinstance(key, str) else \
            "step" if key[0] == 1 else "block"
        with trace.program(kind, self.device):
            if not self.uses_graphs():
                return fn(window, carry, None)
            if getattr(self, cache) is None:
                setattr(self, cache, graphs.GraphCache(self.device))
            return self._run_graph(getattr(self, cache), key, fn, window,
                                   carry, window_id)

    def _prep_fn(self, window: Window, carry, loop):
        """prepare's force evaluation (rxmd_tpu's prep_block,
        engine.py:728-734): (state, forces, PE components, CG iterations,
        the uncached terms' mesh-wide counts or None)."""
        (s,) = carry
        counts = {}
        q, qsfp, qsfv, spos, f, comps, _, nq = self._compute(
            s, window.block, True, prep=True, loop=loop, counts=counts)
        over = _over_vector(counts)
        return (dataclasses.replace(s, q=q, qsfp=qsfp, qsfv=qsfv, spos=spos),
                f, comps, nq, None if over is None else self.comm.pmax(over))

    @torch.no_grad()
    def prepare(self):
        """Initial rebuild, QEq and FORCE (ref: main.F90:27-32)."""
        self.rebuild()
        self.sstate, self.force, self.comps, self.nqeq, over = self._dispatch(
            "_graphs", "prepare", self._prep_fn,
            Window(self._block, self._frac_ref), (self.sstate,),
            self._window_id)
        self.cg_iters = self.cg_iters + self.nqeq
        self._over = over
        self._astr = torch.zeros((6,), dtype=self.dtype, device=self.device)
        self._astr_steps = 0
        return self.comps

    def _step_fn(self, s: ShardedState, f, astr, step, window: Window,
                 do_qeq, loop):
        """One velocity-Verlet step of every domain (rxmd_tpu's
        step_block, engine.py:632-677; md.Engine._step_fn's order), at the
        step number `step` (a device int64: the thermostat's cadence is
        read from it).  Returns (state, forces, PE components, CG
        iterations, stress, this domain's largest drift^2 since the
        rebuild, the uncached terms' counts or None)."""
        cfg, dt = self.cfg, self.dt
        s = self._thermostat(s, step % cfg.sstep == 0)
        w = s.valid[:, None]
        dthm = self.dthm[s.types][:, None]
        v = torch.where(w, s.vel + dthm * f, 0.0)
        qsfv = s.qsfv + 0.5 * dt * self.lex_w2 * (s.q - s.qsfp)
        qsfp = s.qsfp + dt * qsfv
        if cfg.isEfield:
            # the field pumps net momentum into the charged system
            # (ref: main.F90:70-71)
            v = self._zero_momentum(s, v)
        # drift in fractional space; wrap and migration happen at
        # rebuilds, so the saved plan stays index-consistent
        frac = torch.where(w, s.frac + (v @ self.Hi.T) * dt, 0.0)
        s = dataclasses.replace(s, frac=frac, vel=v, qsfp=qsfp, qsfv=qsfv)
        counts = {}
        q, qsfp, qsfv, spos, f2, comps, wvir, nq = self._compute(
            s, window.block, do_qeq, loop=loop, counts=counts)
        # per-step stress: kinetic m v_a v_b with the half-kicked velocity
        # + the potential virial (ref: main.F90:86-94 + pot.F90:65-72)
        m = torch.where(s.valid, (2.0 * self.hmas)[s.types], 0.0)
        sw = (self.comm.psum(torch.einsum("i,ia,ib->ab", m, v, v))
              + 0.5 * (wvir + wvir.T))
        astr = astr + torch.stack(
            [sw[0, 0], sw[1, 1], sw[2, 2], sw[1, 2], sw[2, 0], sw[0, 1]])
        v = torch.where(w, v + dthm * f2, 0.0)
        qsfv = qsfv + 0.5 * dt * self.lex_w2 * (q - qsfp)
        # Verlet-drift monitor: this domain's largest displacement since
        # the rebuild
        dr = (frac - window.frac_ref) @ self.Hg.T
        maxdr2 = torch.max(torch.where(s.valid, torch.sum(dr * dr, 1), 0.0))
        s = dataclasses.replace(s, vel=v, q=q, qsfp=qsfp, qsfv=qsfv,
                                spos=spos)
        return s, f2, comps, nq, astr, maxdr2, _over_vector(counts)

    def _block_fn(self, K, do_qeq, window: Window, carry, loop):
        """The program a dispatch runs, as graphs.GraphCache takes it: K
        steps (rxmd_tpu's step_block for one, multi_block's scan for more,
        engine.py:679-704) from carry = (state, forces, stress, the first
        step's number), each step's thermostat cadence from that number +
        i; a StepOut whose reductions (the running drift maximum, the
        final max v^2, the uncached terms' counts, the residents) are
        mesh-wide."""
        s, f, astr, step0 = carry
        nq_sum = mdr = over = None
        for i in range(K):
            s, f, comps, nq, astr, maxdr2, ov = self._step_fn(
                s, f, astr, step0 + i, window, do_qeq, loop)
            nq_sum = nq if nq_sum is None else nq_sum + nq
            mdr = maxdr2 if mdr is None else torch.maximum(mdr, maxdr2)
            over = _max_or(over, ov)
        vmax2 = torch.max(torch.where(s.valid, torch.sum(s.vel * s.vel, 1),
                                      0.0))
        stats = torch.stack([mdr, vmax2]).double()
        if over is not None:
            stats = torch.cat([stats, over.double()])
        return StepOut(s, f, comps, nq, nq_sum, astr, self.comm.pmax(stats),
                       self.comm.psum(s.valid.sum()))

    @torch.no_grad()
    def _advance(self, K):
        """Dispatch K steps (one, or a block of K) and keep the host's
        bookkeeping; returns the StepOut.  A block solves QEq every step
        (the schedule forms blocks only at qstep 1, as rxmd_tpu's
        multi_block); a single step where the step count says."""
        do_qeq = K > 1 or self.step_count % self.cfg.qstep == 0
        carry = (self.sstate, self.force, self._astr, torch.full(
            (), self.step_count, dtype=torch.int64, device=self.device))
        out = self._dispatch(
            "_graphs", (K, do_qeq),
            functools.partial(self._block_fn, K, do_qeq),
            Window(self._block, self._frac_ref), carry, self._window_id)
        self.sstate, self.force, self.comps, self.nqeq = (
            out.state, out.force, out.comps, out.nq)
        self._astr = out.astr
        self.cg_iters = self.cg_iters + out.nq_sum
        self._over = _max_or(self._over, out.stats[2:] if
                             out.stats.shape[0] > 2 else None)
        self._maxdr2 = out.stats[0] if K == 1 else None
        self._astr_steps += K
        self._steps_since_rebuild += K
        self.step_count += K
        return out

    def step(self):
        """One velocity-Verlet step of every domain (after `prepare`)."""
        self._advance(1)

    def _drifted(self):
        """md.Engine.run's drift test on the mesh-wide displacement of the
        last single step; every rank reads the same maximum."""
        ssr = self._steps_since_rebuild
        return (self._maxdr2 is not None and ssr >= self.drift_check_from
                and ssr % self.drift_check_every == 0
                and float(self._maxdr2) ** 0.5 > 0.8 * self.drift_trigger)

    def run(self, nsteps=None, log=print, writer=None):
        """Host loop of every rank, rxmd_tpu's sharded schedule (rxmd_tpu
        engine.py:840-900; md.Engine.run's): redraws (mdmodes 0, 6), PRINTE
        every pstep, `writer(engine)` every fstep, a rebuild on the cadence
        or the drift trigger, then a block of `block_steps` steps where
        the boundaries and the drift budget allow it, else one step; blocks
        end on pstep only when logging, and qstep > 1 runs single steps.
        Steps and blocks are programs (`_block_fn`), CUDA graphs where
        `uses_graphs()`; a block's end reads its drift, max v^2, residents
        and list counts in one transfer.  The atom-count check at every
        PRINTE, block end and the run's end.  Every rank must call it alike
        (it runs collectives); pass the same `log` on every rank (a rank
        whose output is not wanted may print to a null stream).  Returns
        the loop's wall seconds."""
        cfg, tm = self.cfg, self.timers
        nsteps = nsteps if nsteps is not None else cfg.ntime_step
        if not hasattr(self, "force"):
            if cfg.mdmode in (0, 6):
                self.init_velocity()
            with tm("first force"):
                self.prepare()
        t0 = time.perf_counter()
        trig = 0.8 * self.drift_trigger
        k = 0
        while k < nsteps:
            stepno = self.step_count
            if cfg.mdmode in (0, 6) and stepno % cfg.sstep == 0 and k > 0:
                # periodic Maxwell-Boltzmann redraw (ref: main.F90:53-54)
                self.init_velocity(seed=stepno)
                self._vmax = None
            if stepno % cfg.pstep == 0:
                # one read: this step's CG iterations and their sum
                with trace.span("QEq count read"):
                    _, total = torch.stack([torch.as_tensor(
                        self.nqeq, device=self.device).to(torch.int64),
                        self.cg_iters]).tolist()
                tm.counters["QEq iterations"] = total
                if log:
                    with tm("PRINTE"):
                        log(self.printe_line())
            if writer is not None and stepno % cfg.fstep == 0:
                with tm("trajectory output"):
                    writer(self)
            drifted = self._drifted()
            if self._last_maxdr is not None and self._last_maxdr > trig:
                drifted = True
            if self._steps_since_rebuild >= self.rebuild_every or drifted:
                if drifted:
                    tm.count("drift-triggered rebuilds", 1)
                with tm("neighbor rebuild"):
                    self.rebuild()
                self._last_maxdr = None

            nb = nsteps - k
            if log:
                nb = min(nb, cfg.pstep - stepno % cfg.pstep)
            if writer is not None:
                nb = min(nb, cfg.fstep - stepno % cfg.fstep)
            if cfg.mdmode in (0, 6):
                nb = min(nb, cfg.sstep - stepno % cfg.sstep)
            nb = min(nb, self.rebuild_every - self._steps_since_rebuild)
            if cfg.qstep > 1:
                nb = 1
            if self._vmax is None and nb >= self.block_steps > 1:
                s = self.sstate
                self._vmax = float(self.comm.pmax(torch.max(torch.where(
                    s.valid, torch.sum(s.vel * s.vel, 1), 0.0)))) ** 0.5
            if self._vmax is not None and self._vmax > 0.0:
                room = trig - (self._last_maxdr or 0.0)
                budget = int(room / (1.25 * self._vmax * self.dt))
                nb = min(nb, max(budget, 1))

            if nb >= self.block_steps > 1:
                with tm("MD block (dispatch)"):
                    out = self._advance(self.block_steps)
                with tm("MD block (end read)"):
                    # one read: the drift, max v^2, residents, list counts
                    pend = [] if self._over is None else [self._over]
                    mdr, vmax2, nat, *over = torch.cat(
                        [out.stats[:2], out.natoms.reshape(1).double()]
                        + pend).tolist()
                    trace.drain()
                    if int(nat) != self.n:
                        raise RuntimeError(
                            f"atom count changed: {int(nat)} != {self.n}")
                    self._check_lists(over)
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
        self.check_atom_count()
        if log:
            log(self.printe_line())
            log(f"total (sec): {wall:.4f}  atom-steps/s: "
                f"{self.n * nsteps / max(wall, 1e-30):.3e}")
        return wall

    def check_atom_count(self):
        """Raise on every rank if the mesh lost or gained atoms (ref:
        main.F90:402-407 analog)."""
        nat = self.n_atoms
        if nat != self.n:
            raise RuntimeError(f"atom count changed: {nat} != {self.n}")

    # ------------------------------------------------------------------
    # Structural-optimization surface (mdmode 10; ref: cg.F90), driven by
    # opt.conjugate_gradient through its sharded adapter: positions are
    # this domain's (ncap, 3) block (rxmd_tpu engine.py:945-1017).
    def cg_positions(self):
        """Block absolute positions (dead rows zero)."""
        s = self.sstate
        return torch.where(s.valid[:, None], s.frac @ self.Hg.T, 0.0)

    def _probe_fn(self, carry: ProbeIn, loop=None):
        """One optimizer probe as a program (rxmd_tpu's eval_block,
        engine.py:950-971): the positions to fractions, no migration (the
        rows stay aligned with the caller's vectors), a fresh halo plan,
        the ghost rows compacted to `carry.rows` (live first), the
        neighbor lists with exact gates over the cell grid of depth
        `carry.ccap`, bonded rows for up to `carry.brows` rows, the
        uncached terms at the engine's capacities, a full solve as
        rxmd_tpu's probe makes it (`_compute(prep=(isQEq == 2))`: none at
        isQEq=0) and the forces.  Every count a capacity bounds leaves in
        `counts`, maximal over the mesh, for the host to check
        (`cg_evaluate`)."""
        s, pos, rows, brows, ccap = carry
        s = dataclasses.replace(s, frac=torch.where(
            s.valid[:, None], pos @ self.Hi.T, 0.0))
        with trace.phase("rebuild"):
            block, _, ghost, near, occ = self._window_rows(s, rows, brows,
                                                           ccap)
        counts = {}
        q, _, _, _, f, comps, _, nq = self._compute(
            s, block, True, prep=self.cfg.isQEq == 2, loop=loop,
            counts=counts)
        over = _over_vector(counts)
        nbrs = block.nbrs
        vec = torch.stack([t.to(torch.int64) for t in (
            block.plan.cnt_send.max(), nbrs.cntb.max(), nbrs.cntnb.max(), occ,
            ghost.sum(), near.sum())])
        return ProbeOut(comps[0], f, q, nq, self.comm.pmax(torch.cat(
            [vec, vec.new_zeros(len(CAP_NAMES)) if over is None else over])))

    @torch.no_grad()
    def cg_evaluate(self, pos_blk):
        """(total PE as a float, forces, charges) at block positions, as
        the single-device probe (ref: EvaluateEnergyWithStep
        cg.F90:358-387): the probe program (`_probe_fn`) as a CUDA graph
        where `uses_graphs()` (a cache of its own, keyed by its row and
        cell sizes), else eagerly, then one host read of its PE and
        counts, the same on every rank.  The first probe keeps every ghost
        row and gives every row a bonded list; its counts size the rows'
        buckets (`_size`), and a probe that outgrows them, or the cell
        grid, grows them and runs again.  A count past a capacity raises,
        naming it."""
        while True:
            sz = self._sizes
            carry = ProbeIn(self.sstate, pos_blk,
                            sz.get("probe ghost rows", self.ghost_cap),
                            sz.get("probe bond rows", self.bond_cap),
                            self.grid.ccap)
            self.timers.count("probes", 1)
            with trace.span("dispatch"):
                out = self._dispatch(
                    "_probe_graphs", "probe",
                    lambda _, c, loop: self._probe_fn(c, loop), (), carry,
                    0)
            self.cg_iters = self.cg_iters + out.nq
            with trace.span("read"):
                pe, *vals = torch.cat([out.pe[None].double(),
                                       out.counts.double()]).tolist()
            trace.drain()
            got = dict(zip(PROBE_COUNTS, (int(v) for v in vals)))
            self._check_diag([0, 0, got["halo"], got["kb"], got["knb"]])
            self._check_over(got)
            grown = got["cells"] > carry.ccap
            if grown:
                self.grid = self.grid._replace(
                    ccap=int(got["cells"] * 1.25) + 2)
            for name, n, attr, have in (
                    ("probe ghost rows", got["ghosts"], "ghost_cap",
                     carry.rows),
                    ("probe bond rows", got["bonded"], "bond_cap",
                     carry.brows)):
                self._rows(name, n, attr)
                grown |= n > have
            if not grown:
                return pe, out.force, out.q
            self.timers.count("probe regrowths", 1)

    def _resync_fn(self, carry):
        """The optimizer's resync as a program (rxmd_tpu's _cg_resync,
        engine.py:976-988): carry = (state, block positions, g, p); the
        positions committed and wrapped, the atoms migrated with `g` and
        `p` riding along, and the mesh-wide largest send and atoms
        without a free slot.  It reads nothing on the host."""
        s, pos, g, p = carry
        frac = torch.where(s.valid[:, None],
                           torch.remainder(pos @ self.Hi.T, 1.0), 0.0)
        s, ex, mig, lost = self._migrate(dataclasses.replace(s, frac=frac),
                                         {"g": g, "p": p})
        return s, ex["g"], ex["p"], self.comm.pmax(torch.stack([mig, lost]))

    @torch.no_grad()
    def cg_resync(self, pos_blk, g, p):
        """Commit positions and migrate atoms with the CG vectors `g` and
        `p` riding along (MigrateVec3D, ref: cg.F90:292-314): the resync
        program (`_resync_fn`) as a CUDA graph where `uses_graphs()` (in
        the rebuild's cache), else eagerly, then one host read of its
        mesh-wide counts, raising on an overflow."""
        s, g, p, diag = self._dispatch(
            "_rebuild_graphs", "resync",
            lambda _, c, loop: self._resync_fn(c), (),
            (self.sstate, pos_blk, g, p), 0)
        mig, lost = (int(x) for x in diag.tolist())
        if mig > self.mcap or lost:
            raise RuntimeError(f"migration overflow: {mig} sent (mcap="
                               f"{self.mcap}), {lost} without a free slot")
        self.sstate = s
        return self.cg_positions(), g, p

    def cg_commit(self, pos_blk, q_blk):
        """Write optimized positions and charges into the engine state."""
        s = self.sstate
        frac = torch.where(s.valid[:, None],
                           torch.remainder(pos_blk @ self.Hi.T, 1.0), 0.0)
        self.sstate = dataclasses.replace(
            s, frac=frac, q=torch.where(s.valid, q_blk, 0.0))

    # ------------------------------------------------------------------
    def init_velocity(self, seed=0):
        """Gaussian velocities scaled to treq with zero net momentum
        (ref: INITVELOCITY init.F90:292-360), drawn in global-id order with
        md.Engine.init_velocity's generator, so sharded and single-device
        trajectories start alike."""
        s = self.sstate
        gid, types, valid = (self._gather(x).cpu().numpy()
                             for x in (s.gid, s.types, s.valid))
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(self.n, 3))
        types_g = np.zeros(self.n, np.int64)
        types_g[gid[valid]] = types[valid]
        m = (2.0 * self.hmas).cpu().numpy()[types_g]
        v -= (m[:, None] * v).sum(0) / m.sum()
        ke = 0.5 * (m * (v * v).sum(1)).sum() / self.n
        v *= np.sqrt(1.5 * self.treq_red / ke)
        mine = s.valid.cpu().numpy()
        vblk = np.zeros((self.ncap, 3))
        vblk[mine] = v[s.gid.cpu().numpy()[mine]]
        self.sstate = dataclasses.replace(s, vel=torch.as_tensor(
            vblk, dtype=self.dtype, device=self.device))

    def _gather(self, x):
        """Every domain's block of one field, (ndev*ncap, ...) in block
        order (rare: redraws and gathered output)."""
        if x.dtype == torch.bool:
            return self._gather(x.to(torch.uint8)).bool()
        return self.comm.all_gather(x).reshape((-1,) + tuple(x.shape[1:]))

    def to_state(self) -> State:
        """The gathered state in global-id order, on the host, on every rank
        (a collective: every rank calls it alike)."""
        ss = {k: self._gather(getattr(self.sstate, k)).cpu().numpy()
              for k in FIELDS}
        sel = np.where(ss["valid"])[0]
        order = sel[np.argsort(ss["gid"][sel], kind="stable")]
        H = self.Hg.cpu().numpy()
        return make_state(
            pos=host_positions(ss["frac"][order], H), types=ss["types"][order],
            H=H, vel=ss["vel"][order], q=ss["q"][order],
            qsfp=ss["qsfp"][order], qsfv=ss["qsfv"][order],
            gid=ss["gid"][order], spos=ss["spos"][order],
            step=self.step_count, dtype=self.dtype)

    @property
    def n_atoms(self):
        """Atoms on the whole mesh (a collective)."""
        return int(self.comm.psum(self.sstate.valid.sum()))

    def pressure_gpa(self, reset=True):
        """Pressure [GPa] from the per-step accumulated stress, as
        md.Engine.pressure_gpa (ref: main.F90:252-253)."""
        astr = self._astr.cpu().numpy()
        vol = abs(float(torch.linalg.det(self.Hg)))
        nst = self._astr_steps or max(self.cfg.pstep, 1)
        ss = astr[:3].sum() / 3.0 / vol * units.USTRS / nst
        if reset:
            self._astr = torch.zeros_like(self._astr)
            self._astr_steps = 0
        return float(ss)

    def printe_line(self):
        """PRINTE-format observables, column for column md.Engine's (ref:
        main.F90:210-263); a collective (kinetic energy, total charge and
        the atom count in one reduction), raising if atoms were lost."""
        s = self.sstate
        red = self.comm.psum(torch.stack([
            self._ke_sum(s, s.vel), torch.sum(torch.where(s.valid, s.q, 0.0)),
            s.valid.sum().to(self.dtype)])).cpu().numpy()
        if int(round(float(red[2]))) != self.n:
            raise RuntimeError(f"atom count changed: {red[2]} != {self.n}")
        n = self.n
        ke = float(red[0]) / n
        pe = self.comps.cpu().numpy() / n
        te = ke + pe[0]
        tt = ke * units.UTEMP
        ss = self.pressure_gpa()
        qq = float(red[1])
        return (f"MDstep: {self.step_count:9d} {te: .5E} {pe[0]: .5E} "
                f"{ke: .5E} "
                f"{pe[1]: .3E} {pe[2:5].sum(): .3E} {pe[5:8].sum(): .3E} "
                f"{pe[8:10].sum(): .3E} {pe[10]: .3E} {pe[11:14].sum(): .3E} "
                f"{tt:8.2f} {ss:8.2f} {qq:8.2f} {int(self.nqeq):4d}")

    def describe(self):
        cfg = self.cfg
        charges = ("off" if cfg.isQEq == 0 else
                   ("PQEq" if self.pq is not None else "QEq")
                   + (" full CG" if cfg.isQEq == 1 else " ext. Lagrangian"))
        return (f"engine: sharded, mesh {self.mesh_shape} ({self.ndev} "
                f"process(es)), pair list, "
                f"{'closed form' if self.closed_form else 'tables'}, "
                f"{str(self.dtype)[6:]} on {self.device}; charges {charges}"
                f"{'; LG dispersion' if self.ff.is_lg else ''}; taper "
                f"{self.rctap} A; ncap {self.ncap} bcap {self.bcap} mcap "
                f"{self.mcap}; blocks of {self.block_steps} steps, "
                f"{'as CUDA graphs' if self.uses_graphs() else 'eager'}")

    def summary(self):
        """md.Engine.summary's report: "QEq iterations" the sum over every
        solve (`cg_iters`, one read), the last profiler session's table."""
        self.timers.counters["QEq iterations"] = int(self.cg_iters)
        return ([self.describe()]
                + self.timers.summary_lines(device=self.device)
                + trace.session_lines())

    # ------------------------------------------------------------------
    def bond_table(self, st: State, bo_cutoff=0.3):
        """(partner gids, bond orders, counts) of a gathered state for .bnd
        output (ref: WriteBND fileio.F90:27-148), over periodic images on
        this rank's device."""
        from .. import md
        st = st.to(self.device)
        nimg = neighbors.nimg_for_cutoff(st.H.cpu().numpy(),
                                         self.rctap + self.skin_nb)
        img = neighbors.make_image_table(st.n, nimg, self.dtype, self.device)
        grid = md._cell_grid(self.ff, st, img, self.skin_nb, self.rctap)
        nbrs = md._build(st, img, grid, self.rc2b_ext, self.rctap2_ext,
                         self.kb, self.knb)
        bo = reax.bond_order(st.pos, st.H, st.types, img, nbrs, self.ffd)
        return md._bond_table_from(bo, nbrs, st.gid, img, bo_cutoff)

    def write_frame(self, base_path: str, st: State = None):
        """The configured trajectory formats from the gathered state, on
        the calling rank (ref: OUTPUT fileio.F90:5-20).  Pass `st` when the
        caller gathered it already (`to_state` is a collective)."""
        from ..io import refbin, traj
        cfg = self.cfg
        st = self.to_state() if st is None else st
        names = self.ff.atom_names
        if cfg.is_xyz:
            traj.write_xyz(base_path + ".xyz", st, names)
        if cfg.is_pdb:
            traj.write_pdb(base_path + ".pdb", st, names)
        if cfg.is_bondfile:
            g, b, c = self.bond_table(st)
            traj.write_bnd(base_path + ".bnd", st, g, b, c)
        if cfg.is_binary:
            refbin.write_rxff_bin(base_path + ".bin", st)

    def write_frame_slab(self, base_path: str):
        """Every rank writes only its own residents (the MPI-IO analog,
        ref: fileio.F90:81-95): .xyz records at gid offsets and the
        reference rxff.bin with one slab per domain (io/slab.py)."""
        from ..io import slab
        if self.cfg.is_xyz:
            slab.write_xyz_slab(base_path + ".xyz", self)
        if self.cfg.is_binary:
            slab.write_bin_slab(base_path + ".bin", self)


def host_positions(frac, H):
    """Absolute positions in the box, in float64 numpy, of fractional
    coordinates (numpy): the one expression the gathered state and the
    slab writers share, so both write the same bytes."""
    return (frac % 1.0) @ H.T
