"""Multi-process runs of the sharded engine: the launcher and the rank entry
points (counterpart of rxmd_tpu.parallel.dryrun).

`launch(n, fn, *args)` starts n processes (spawn), joins them into one
torch.distributed group (gloo on the CPU, NCCL on cards, one card each)
and returns what `fn(*args)` returned on each rank, in rank order.  It
waits at most `timeout` seconds, then ends every rank still running, so a
collective that never completes fails the caller instead of hanging it.
Every rank checks that neither `jax` nor `rxmd_tpu` was imported.

`run(n, device)` is the dry run: prepare and a step of the sharded engine
on the in-repo CHON deck over factor_mesh(n), each PE component held to
the single-device md.Engine; on cards three steps, run as CUDA graphs
(the first eagerly, the second captured with its sends, receives and
all-reduces, the third replayed).  rxmd_tpu's dry run reads a deck outside
the repository (rxmd_tpu/parallel/dryrun.py:49-50); this one does not.

`HostGraphs` is graphs.GraphCache's dispatch on the CPU, without captures
(`install_host_graphs` puts three into an engine), and `HostReadGuard`
makes every host read raise, or counts them: the rank entries
`guarded_programs`, `probe_case`, `rebuild_case`, `capacity_case` and
`window_case` hold the sharded engine's programs to what a capture
needs.

    python -m rxmd_tpu_torch.parallel.dryrun N [cpu|cuda]
"""
from __future__ import annotations

import os
import queue
import socket
import sys
import time
import traceback

import numpy as np

from ..graphs import GraphCache

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(REPO, "tests", "data")
FFIELD = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
PQEQ_PAR = os.path.join(DATA, "pqeq_chon.par")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, n, port, device, threads, fn, args, out):
    try:
        import torch
        import torch.distributed as dist
        if threads:
            torch.set_num_threads(threads)
        from .comm import init_process_group
        init_process_group(rank, n, f"127.0.0.1:{port}", device)
        try:
            res = fn(*args)
            bad = [m for m in ("jax", "rxmd_tpu") if m in sys.modules]
            if bad:
                raise RuntimeError(f"rank {rank} imported {bad}")
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def launch(n, fn, *args, device="cpu", timeout=300.0, threads=1):
    """Run fn(*args) on n ranks of one process group; returns the results
    in rank order.  Raises with the failing ranks' tracebacks, or when the
    ranks have not all finished within `timeout` seconds."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, n, port, device, threads, fn, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and \
                        not errors:
                    # a rank died without reporting (killed): the others
                    # wait on it in a collective
                    errors[-1] = "a rank exited with " + str(
                        [p.exitcode for p in procs])
                    break
                continue
            (results if ok else errors)[rank] = res
            if not ok:
                break
    finally:
        for p in procs:
            p.join(timeout=5.0 if errors or len(results) < n else 30.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("sharded ranks failed:\n" + "\n".join(
            f"[rank {r}] {e}" for r, e in sorted(errors.items())))
    if len(results) < n:
        raise TimeoutError(f"{n - len(results)} of {n} ranks did not finish "
                           f"within {timeout} s")
    return [results[r] for r in range(n)]


# ----------------------------------------------------------------------
# rank entry points (import the port only)

def load_deck(mc=(2, 2, 2), dtype="float64", device="cpu"):
    """(ForceField, State) of the in-repo CHON cell replicated mc."""
    import torch
    from .. import ffield, system
    ff = ffield.parse_ffield(FFIELD)
    st = system.from_cellfile(CELL, ff.name_to_type, mc=tuple(mc),
                              dtype=getattr(torch, dtype), device=device)
    return ff, st


def by_gid(engine, x):
    """A per-resident tensor of every domain, gathered and in gid order
    (numpy float64)."""
    g = engine._gather(engine.sstate.gid).cpu().numpy()
    v = engine._gather(engine.sstate.valid).cpu().numpy()
    a = engine._gather(x).double().cpu().numpy()
    order = np.argsort(g[v], kind="stable")
    return a[v][order]


def trajectory(mc, cfg_kw, nsteps=1, seed=1, mesh=None, device="cpu",
               engine_kw=None):
    """Rank entry: ShardedEngine on the CHON deck, init_velocity(seed)
    (none for seed None), prepare and `nsteps` steps.  Returns, per step (prepare first), the PE
    components, the forces on the residents and the charges in gid order,
    the PRINTE pressure and line; then the final state (gid order), the CG
    iterations and the engine's sizes."""
    import torch
    from ..config import RunConfig
    from .engine import ShardedEngine
    cfg = RunConfig(**cfg_kw)
    ff, st = load_deck(mc, "float64")
    e = ShardedEngine(ff, st, cfg, mesh_shape=mesh, device=device,
                      **(engine_kw or {}))
    if seed is not None:
        e.init_velocity(seed=seed)
    e.prepare()
    comps, forces, charges, press, lines = [], [], [], [], []

    def record():
        comps.append(e.comps.double().cpu().numpy())
        forces.append(by_gid(e, e.force))
        charges.append(by_gid(e, e.sstate.q))
        press.append(e.pressure_gpa(reset=False))
        lines.append(e.printe_line())
    record()
    for _ in range(nsteps):
        e.run(1, log=None)
        record()
    fin = e.to_state()
    tm = e.timers.counters
    return dict(comps=np.array(comps), forces=np.array(forces),
                q=np.array(charges), press=np.array(press), lines=lines,
                n_atoms=e.n_atoms, pos=fin.pos.double().numpy(),
                spos=fin.spos.double().numpy(), cg_iters=int(e.cg_iters),
                ff_chi=ff.chi.copy(), ff_eta=ff.eta.copy(),
                mesh=e.mesh_shape, captures=tm.get("graph captures", 0),
                replays=tm.get("graph replays", 0))


def halo_case(frac_blocks, valid_blocks, w_blocks, mesh, skin_frac, ncap,
              bcap, seed=0):
    """Rank entry: this rank's block of the given global layout through
    `halo.build_plan`, then the gradient of sum(w * apply_plan(frac)) with
    the copy-back; also an integer field through the plan, and psum of a
    per-rank vector (every rank must hold the same bits)."""
    import torch
    from . import halo
    from .comm import Comm
    comm = Comm(mesh)
    r = comm.rank
    blk = lambda a: torch.as_tensor(a[r * ncap:(r + 1) * ncap])
    spec = halo.HaloSpec(tuple(mesh), tuple(skin_frac), ncap, bcap)
    plan, frac_ext, valid_ext = halo.build_plan(
        blk(frac_blocks), blk(valid_blocks), spec, comm)
    x = blk(frac_blocks).clone().requires_grad_(True)
    y = halo.apply_plan(plan, x, spec, comm, is_frac=True)
    w = torch.as_tensor(w_blocks[r * y.shape[0]:(r + 1) * y.shape[0]])
    (g,) = torch.autograd.grad(torch.sum(w * y), (x,))
    ids = halo.apply_plan(plan, torch.arange(ncap) + 1000 * r, spec, comm)
    v = torch.as_tensor(np.random.default_rng(seed + r).normal(size=7))
    return dict(sel=plan.sel.numpy(), shift=plan.shift.numpy(),
                cnt_send=plan.cnt_send.numpy(),
                cnt_recv=plan.cnt_recv.numpy(), frac_ext=frac_ext.numpy(),
                valid_ext=valid_ext.numpy(), y=y.detach().numpy(),
                grad=g.numpy(), ids=ids.numpy(), psum=comm.psum(v).numpy(),
                pmax=comm.pmax(v).numpy())


def reduced_step(mesh, nsteps=1):
    """Rank entry: rxmd_tpu's reduced-knob step (rctap 5 A, one bonded
    ghost layer, tests/test_parallel.py:53-70) on the 168-atom cell in
    float32 from zero force; returns the atom count and whether the PE,
    the kinetic energy and the forces are finite."""
    import torch
    from ..config import RunConfig
    from .engine import ShardedEngine
    ff, st = load_deck((1, 1, 1), "float32")
    cfg = RunConfig(mdmode=1, dt_fs=0.25, isQEq=2, qstep=1, dtype="float32",
                    nbr_skin=0.1)
    e = ShardedEngine(ff, st, cfg, mesh_shape=mesh, device="cpu",
                      rctap=5.0, skin_layers=1.0)
    e.rebuild()
    e.force = torch.zeros((e.ncap, 3), dtype=e.dtype)
    e._astr = torch.zeros((6,), dtype=e.dtype)
    e._astr_steps = 0
    e.comps = torch.zeros(14, dtype=e.dtype)
    e.nqeq = 0
    e.run(nsteps, log=None)
    ke = float(e.comm.psum(e._ke_sum(e.sstate, e.sstate.vel)))
    return dict(n_atoms=e.n_atoms, pe=float(e.comps[0]), ke=ke,
                finite=bool(torch.isfinite(e.force).all()),
                ncap=e.ncap, bcap=e.bcap)


def migration(mesh, mcap, shift):
    """Rank entry: the 168-atom cell at the reduced knobs, every atom moved
    `shift` along x (fractional), then a rebuild, which migrates them.
    Returns the error every rank raised (None without one), and after a
    migration the atom count, whether every atom lies in its own domain,
    and the gathered (gid, position) pairs against the shifted input."""
    import dataclasses
    import torch
    from ..config import RunConfig
    from .engine import ShardedEngine
    ff, st = load_deck((1, 1, 1), "float64")
    cfg = RunConfig(isQEq=0, nbr_skin=0.1)
    e = ShardedEngine(ff, st, cfg, mesh_shape=mesh, device="cpu",
                      rctap=5.0, skin_layers=1.0, mcap=mcap)
    e.rebuild()
    s = e.sstate
    e.sstate = dataclasses.replace(s, frac=torch.where(
        s.valid[:, None], s.frac + torch.tensor([shift, 0.0, 0.0],
                                                dtype=s.frac.dtype), 0.0))
    try:
        e.rebuild()
    except RuntimeError as err:
        return dict(err=str(err))
    s = e.sstate
    lo = e.mylo
    hi = lo + 1.0 / torch.tensor(e.mesh_shape, dtype=lo.dtype)
    inside = bool(((s.frac >= lo) & (s.frac < hi))[s.valid].all())
    frac0 = (st.pos.numpy() @ np.linalg.inv(st.H.numpy()).T
             + [shift, 0.0, 0.0]) % 1.0
    return dict(err=None, n_atoms=e.n_atoms, inside=inside,
                gid=by_gid(e, e.sstate.gid)[:, None],
                frac=by_gid(e, e.sstate.frac), frac0=frac0)


def optimize(mc, cfg_kw, mesh, max_iter=2, device="cpu"):
    """Rank entry: opt.conjugate_gradient on the sharded engine; returns
    the PE sequence (start, then each iteration) and the final positions
    and charges in gid order."""
    from .. import opt
    from ..config import RunConfig
    from .engine import ShardedEngine
    ff, st = load_deck(mc, "float64")
    e = ShardedEngine(ff, st, RunConfig(**cfg_kw), mesh_shape=mesh,
                      device=device)
    pes, lines = [], []
    pe = opt.conjugate_gradient(e, max_iter=max_iter, log=lines.append,
                                writer=lambda it, pos, p: pes.append(p))
    fin = e.to_state()
    return dict(pe0=float(lines[0].split("PE0=")[1]), pes=pes, pe=pe,
                pos=fin.pos.numpy(), q=fin.q.numpy(), lines=lines)


def slab_case(mc, cfg_kw, mesh, outdir, nsteps=2):
    """Rank entry: a few steps, then the slab writers and, on rank 0, the
    gathered writers of the same state (traj.write_xyz and
    refbin.write_rxff_bin with vprocs = the mesh) into `outdir`."""
    from ..config import RunConfig
    from ..io import refbin, slab, traj
    from .engine import ShardedEngine
    ff, st = load_deck(mc, "float64")
    e = ShardedEngine(ff, st, RunConfig(**cfg_kw), mesh_shape=mesh,
                      device="cpu")
    e.init_velocity(seed=3)
    e.prepare()
    e.run(nsteps, log=None)
    e.rebuild()                 # every atom back in its own domain
    slab.write_xyz_slab(os.path.join(outdir, "slab.xyz"), e)
    slab.write_bin_slab(os.path.join(outdir, "slab.bin"), e)
    stg = e.to_state()
    if e.comm.rank == 0:
        traj.write_xyz(os.path.join(outdir, "ref.xyz"), stg, ff.atom_names)
        refbin.write_rxff_bin(os.path.join(outdir, "ref.bin"), stg,
                              vprocs=e.mesh_shape)
    return e.comm.rank


def scheduled_run(mc, cfg_kw, nsteps, seed=1, mesh=None, host_graphs=False):
    """Rank entry: ShardedEngine on the CHON deck, init_velocity(seed),
    prepare, then `run(nsteps)` on its own schedule; with `host_graphs`
    its programs dispatched through `install_host_graphs`' caches.  Returns the PE
    components at each PRINTE (step, comps), the timers' dispatch,
    rebuild, capture and replay counts and the final positions in gid
    order."""
    from ..config import RunConfig
    from .engine import ShardedEngine
    ff, st = load_deck(mc, "float64")
    e = ShardedEngine(ff, st, RunConfig(**cfg_kw), mesh_shape=mesh,
                      device="cpu")
    if host_graphs:
        install_host_graphs(e)
    e.init_velocity(seed=seed)
    e.prepare()
    printed = []
    e.run(nsteps, log=lambda line: printed.append(
        (e.step_count, e.comps.double().cpu().numpy())))
    tm = e.timers
    return dict(printed=printed, pos=e.to_state().pos.double().numpy(),
                blocks=tm.ncalls.get("MD block (dispatch)", 0),
                steps=tm.ncalls.get("MD step (dispatch)", 0),
                rebuilds=tm.ncalls.get("neighbor rebuild", 0),
                in_blocks=tm.counters.get("MD steps in blocks", 0),
                captures=tm.counters.get("graph captures", 0),
                replays=tm.counters.get("graph replays", 0))


# ----------------------------------------------------------------------
# the programs on the CPU: a stand-in graph cache and a host-read guard

class HostGraphs(GraphCache):
    """graphs.GraphCache's dispatch where no graph can be captured (the
    CPU): its keys, first uses, static window and carry copies, window
    drops and counts, with a "capture" that keeps the function and its
    static inputs and a "replay" that runs it over them."""

    def __init__(self, device=None):
        self.programs, self.seen, self.carries = {}, set(), {}
        self.window = (None, None, None)
        self.captures = self.replays = 0
        self.capture_s = 0.0
        self.last_chunks = (0, 0.0)

    run = GraphCache._run             # no stream to order against

    def _capture(self, fn, window, carry):
        return _Rerun(fn, window, carry)


class _Rerun:
    """A HostGraphs program: `replay` runs the function over the cache's
    static inputs (refreshed before each replay) into `out`."""

    def __init__(self, fn, window, carry):
        self.fn, self.window, self.carry, self.out = fn, window, carry, None

    def replay(self, after=None):
        self.out = self.fn(self.window, self.carry, None)


def install_host_graphs(engine):
    """Dispatch the engine's steps, blocks, prepare, probes, rebuilds and
    resyncs through three HostGraphs caches, as a card dispatches them
    through its GraphCaches."""
    engine._graphs, engine._probe_graphs, engine._rebuild_graphs = (
        HostGraphs(), HostGraphs(), HostGraphs())
    engine.uses_graphs = lambda: True


class HostReadGuard:
    """While entered, every way a tensor reaches the host raises
    (`Tensor.item`, `__bool__`, `__int__`, `__float__`, `__index__`,
    `tolist`, `numpy`, `cpu`, `nonzero`, `masked_select`; torch's
    `nonzero`, `masked_select`, `argwhere`, `unique`, one-argument
    `torch.where`; indexing with a boolean mask), and so does a tensor
    made from host data (`torch.tensor`, `torch.as_tensor`,
    `Tensor.new_tensor`: on a card a copy that a capture cannot make).
    `loop` is the CG's chunk hook with the guard lifted for the finished
    flag's read, the one read a program makes; `reads` counts them.

    With `count` the guard refuses nothing: it lists in `seen` each host
    read made while active (a tensor made from host data is no read), as
    a run on a card counts the reads between two points."""

    def __init__(self, count=False):
        self.active = False
        self.count = count
        self.reads = 0
        self.seen = []
        self._saved = []

    def _read(self, what):
        """A host read while active: listed with `count`, else refused."""
        if self.count:
            self.seen.append(what)
        else:
            raise AssertionError(f"host read in a program: {what}")

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        import torch
        T = torch.Tensor

        def blocked(what):
            def make(orig):
                def f(*a, **k):
                    if self.active:
                        self._read(what)
                    return orig(*a, **k)
                return f
            return make

        def host_data(what):
            def make(orig):
                def f(*a, **k):
                    data = a[1] if what == "Tensor.new_tensor" else a[0]
                    if (self.active and not self.count
                            and not isinstance(data, torch.Tensor)):
                        raise AssertionError(
                            f"host data in a program: {what}")
                    return orig(*a, **k)
                return f
            return make

        def masked(what):
            def make(orig):
                def f(t, idx, *v):
                    if self.active and any(
                            isinstance(i, torch.Tensor)
                            and i.dtype == torch.bool for i in
                            (idx if isinstance(idx, tuple) else (idx,))):
                        self._read(f"boolean-mask {what}")
                    return orig(t, idx, *v)
                return f
            return make

        def where1(orig):
            def f(*a, **k):
                if self.active and len(a) + len(k) == 1:
                    self._read("torch.where(condition)")
                return orig(*a, **k)
            return f

        for name in ("item", "__bool__", "__int__", "__float__",
                     "__index__", "tolist", "numpy", "cpu", "nonzero",
                     "masked_select"):
            self._patch(T, name, blocked("Tensor." + name))
        for name in ("nonzero", "masked_select", "argwhere", "unique"):
            self._patch(torch, name, blocked("torch." + name))
        for name in ("tensor", "as_tensor"):
            self._patch(torch, name, host_data("torch." + name))
        self._patch(T, "new_tensor", host_data("Tensor.new_tensor"))
        self._patch(T, "__getitem__", masked("indexing"))
        self._patch(T, "__setitem__", masked("assignment"))
        self._patch(torch, "where", where1)
        self.active = True
        return self

    def __exit__(self, *exc):
        self.active = False
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []

    def loop(self, chunk, carry, nchunks):
        carry = chunk(carry)
        for _ in range(nchunks - 1):
            self.active = False
            fin = bool(carry.fin)
            self.reads += 1
            self.active = True
            if fin:
                break
            carry = chunk(carry)
        return carry


def _engine(mc, cfg_kw, mesh, seed=1, **kw):
    """A prepared ShardedEngine on the CHON deck in float64 on the CPU."""
    from ..config import RunConfig
    from .engine import ShardedEngine
    ff, st = load_deck(mc, "float64")
    e = ShardedEngine(ff, st, RunConfig(**cfg_kw), mesh_shape=mesh,
                      device="cpu", **kw)
    e.init_velocity(seed=seed)
    e.prepare()
    return e


def _moved(e, seed=5, amp=0.02):
    """The engine's block positions moved by a seeded random `amp` [A]."""
    import torch
    pos = e.cg_positions()
    d = np.random.default_rng(seed + e.comm.rank).uniform(
        -amp, amp, tuple(pos.shape))
    return torch.where(e.sstate.valid[:, None],
                       pos + torch.as_tensor(d, dtype=pos.dtype), 0.0)


def guarded_programs(mc, cases, mesh, engine_kw=None):
    """Rank entry: for each (name, cfg_kw) of `cases`, the sharded
    programs under a HostReadGuard after prepare and two steps: one step
    and a block of 3 (`_block_fn`) and a probe (`_probe_fn`) at moved
    positions.  Returns name -> (error or None, the chunk flags read,
    whether every output is finite)."""
    import torch
    from .. import graphs
    from .engine import ProbeIn, Window
    out = {}
    for name, cfg_kw in cases:
        e = _engine(mc, cfg_kw, mesh, **(engine_kw or {}))
        e.run(2, log=None)
        window = Window(e._block, e._frac_ref)
        carry = (e.sstate, e.force, e._astr,
                 torch.full((), e.step_count, dtype=torch.int64))
        probe = ProbeIn(e.sstate, _moved(e), e.ghost_cap, e.bond_cap,
                        e.grid.ccap)
        guard = HostReadGuard()
        res = []
        try:
            with guard:
                for K in (1, 3):
                    res.append(e._block_fn(K, True, window, carry,
                                           guard.loop))
                res.append(e._probe_fn(probe, guard.loop))
            err = None
        except AssertionError as x:
            err = str(x)
        finite = all(bool(torch.isfinite(t.double()).all())
                     for t in graphs.leaves(res))
        out[name] = (err, guard.reads, finite)
    return out


def probe_case(mc, cfg_kw, mesh, host_graphs=False):
    """Rank entry: `cg_evaluate` four times at moved positions of a
    prepared engine (with `host_graphs` through `install_host_graphs`:
    the sizing probe and the sized key's first use eagerly, then its
    capture and a replay).  Returns the probes' PE, forces and charges in
    gid order, the positions in gid order and the capture and replay
    counts."""
    e = _engine(mc, cfg_kw, mesh)
    if host_graphs:
        install_host_graphs(e)
    pos = _moved(e)
    probes = [e.cg_evaluate(pos) for _ in range(4)]
    tm = e.timers.counters
    return dict(pe=[p[0] for p in probes],
                f=[by_gid(e, p[1]) for p in probes],
                q=[by_gid(e, p[2]) for p in probes], pos=by_gid(e, pos),
                captures=tm.get("graph captures", 0),
                replays=tm.get("graph replays", 0))


def rebuild_case(mc, cfg_kw, mesh, engine_kw=None):
    """Rank entry: the rebuild and the optimizer's resync as programs, on
    an engine prepared and run two steps through `install_host_graphs`:
    `_rebuild_fn` and `_resync_fn` (at moved positions, with seeded g and
    p) under a HostReadGuard against the same programs unguarded; the
    host reads of `rebuild` and of `cg_resync` (HostReadGuard counting);
    then from the same state a rebuild whose ghost-row bucket and cell
    depth are cut below its counts, which grows both and runs again, and
    a rebuild within the grown bucket, whose window must equal it."""
    import torch
    from .. import graphs
    from .engine import RebuildIn
    e = _engine(mc, cfg_kw, mesh, **(engine_kw or {}))
    install_host_graphs(e)
    e.run(2, log=None)
    s0 = e.sstate
    rng = np.random.default_rng(11 + e.comm.rank)
    g, p = (torch.as_tensor(rng.normal(size=(e.ncap, 3)), dtype=e.dtype)
            for _ in range(2))
    carry = RebuildIn(s0, e._sizes["ghost rows"], e.grid.ccap)
    rcarry = (s0, _moved(e), g, p)
    out = {}
    with torch.no_grad():
        ref = (e._rebuild_fn(carry), e._resync_fn(rcarry))
        try:
            with HostReadGuard():
                got = (e._rebuild_fn(carry), e._resync_fn(rcarry))
            out["guard"] = None
            out["same"] = all(torch.equal(a, b) for a, b in zip(
                graphs.leaves(got), graphs.leaves(ref)))
        except AssertionError as err:
            out["guard"], out["same"] = str(err), False

    def reads(fn):
        with HostReadGuard(count=True) as guard:
            fn()
        return guard.seen

    out["rebuild_reads"] = reads(e.rebuild)
    e.sstate = s0
    out["resync_reads"] = reads(lambda: e.cg_resync(*rcarry[1:]))
    e.sstate = s0
    e._sizes["ghost rows"] = 8
    e.grid = e.grid._replace(ccap=2)
    out["regrow_reads"] = reads(e.rebuild)
    out["regrowths"] = e.timers.counters.get("rebuild regrowths", 0)
    grown = (e.sstate, e._block)
    e.sstate = s0
    out["after_reads"] = reads(e.rebuild)
    again = (e.sstate, e._block)
    la, lb = graphs.leaves(grown), graphs.leaves(again)
    out["same_window"] = len(la) == len(lb) and all(
        a.shape == b.shape and torch.equal(a, b) for a, b in zip(la, lb))
    out["rows"] = e._block.keep.shape[0]
    return out


def resync_case(mc, cfg_kw, mesh, amp=2.0):
    """Rank entry: `cg_resync` of a prepared engine at positions moved by
    a seeded `amp` [A] (some leave the box) with seeded g and p.  Returns
    the positions, g and p given and those it returned, in gid order."""
    import torch
    e = _engine(mc, cfg_kw, mesh)
    pos = _moved(e, amp=amp)
    rng = np.random.default_rng(13 + e.comm.rank)
    g, p = (torch.where(e.sstate.valid[:, None], torch.as_tensor(
        rng.normal(size=(e.ncap, 3)), dtype=e.dtype), 0.0) for _ in range(2))
    given = [by_gid(e, x) for x in (pos, g, p)]
    pos2, g2, p2 = e.cg_resync(pos, g, p)
    return dict(given=given, got=[by_gid(e, x) for x in (pos2, g2, p2)])


def capacity_case(mc, cfg_kw, mesh, cases, engine_kw=None):
    """Rank entry: for each (where, attr, value) of `cases`, a prepared
    engine whose capacity `attr` (an engine attribute, or "caps.<name>")
    is set to `value`, then a rebuild (`where` "rebuild") or a probe at
    moved positions ("probe").  Returns the errors this rank raised (None
    for none), in order."""
    errors = []
    for where, attr, value in cases:
        e = _engine(mc, cfg_kw, mesh, **(engine_kw or {}))
        if attr.startswith("caps."):
            e.caps[attr[5:]] = value
        else:
            setattr(e, attr, value)
        try:
            e.rebuild() if where == "rebuild" else e.cg_evaluate(_moved(e))
            errors.append(None)
        except RuntimeError as err:
            errors.append(str(err))
    return errors


def window_case(mc, cfg_kw, mesh, nsteps=4, engine_kw=None):
    """Rank entry: with `install_host_graphs`, `run(nsteps)`, then two
    rebuilds: one at the same positions and one after `nsteps` more
    steps.  Returns, per rebuild, whether the window's buckets (`_sizes`)
    and the signature of the window the programs are keyed by stayed as
    they were, and the captures and replays from the rebuild through the
    two steps that follow it."""
    from .. import graphs
    from .engine import Window
    e = _engine(mc, cfg_kw, mesh, **(engine_kw or {}))
    install_host_graphs(e)
    e.run(nsteps, log=None)
    out = []
    for more in (0, nsteps):
        e.run(more, log=None)
        before = (dict(e._sizes), graphs.signature(
            Window(e._block, e._frac_ref)))
        caps = e._graphs.captures
        e.rebuild()
        after = (dict(e._sizes), graphs.signature(
            Window(e._block, e._frac_ref)))
        reps = e._graphs.replays
        e.run(2, log=None)
        out.append(dict(sizes=before[0] == after[0],
                        shapes=before[1] == after[1],
                        captures=e._graphs.captures - caps,
                        replays=e._graphs.replays - reps))
    return out


def md_trajectory(mc, cfg_kw, nsteps=1, seed=1, device="cpu"):
    """The single-device md.Engine (pair list) over the same steps as
    `trajectory`, in the same record."""
    from .. import md
    from ..config import RunConfig
    # the pair list with its CG matvec, the sharded engine's path
    cfg = RunConfig(**dict(cfg_kw, pair_kernel=False, dense_direct_max=0,
                           qeq_dense_max=0))
    ff, st = load_deck(mc, "float64")
    e = md.Engine(ff, st, cfg, device=device)
    if seed is not None:
        e.init_velocity(seed=seed)
    e.prepare()
    comps, forces, charges, press, lines = [], [], [], [], []

    def record():
        comps.append(e.comps.double().cpu().numpy())
        forces.append(e.force.double().cpu().numpy())
        charges.append(e.state.q.double().cpu().numpy())
        press.append(e.pressure_gpa(reset=False))
        lines.append(e.printe_line())
    record()
    for _ in range(nsteps):
        e.run(1, log=None)
        record()
    return dict(comps=np.array(comps), forces=np.array(forces),
                q=np.array(charges), press=np.array(press), lines=lines,
                pos=e.state.pos.double().cpu().numpy(),
                spos=e.state.spos.double().cpu().numpy(),
                cg_iters=int(e.cg_iters))


def pe_rel(a, b):
    """Largest PE component difference over |PE|, per step."""
    return float((np.abs(a - b) / np.abs(b[:, :1])).max())


def run(n, device="cpu", mc=(2, 2, 2), dtype="float64", timeout=600.0,
        tol=None):
    """The dry run: prepare + a step (on cards three: a program's first
    use, its capture, a replay) at isQEq=2 on n ranks over factor_mesh(n)
    against md.Engine on one device; returns (the largest PE difference
    over |PE|: every component in float64, the total in float32; the
    sharded record; the reference record) and raises beyond `tol` (1e-8
    in float64, 1e-4 in float32), or on cards where a rank's steps were
    not captured and replayed as CUDA graphs."""
    from .engine import factor_mesh
    mesh = factor_mesh(n)
    steps, isQEq = (1 if device == "cpu" else 3), 2
    cfg = dict(dtype=dtype, isQEq=isQEq, rebuild_every=1000)
    if dtype == "float64":
        # the full CG capped so both engines take the same iterations; in
        # float32 it runs to its stop, since short of it the PE moves with
        # the unconverged charges at first order
        cfg.update(NMAXQEq=8, QEq_tol=1e-14)
    t0 = time.perf_counter()
    recs = launch(n, trajectory, mc, cfg, steps, 1, mesh, device,
                  device=device, timeout=timeout,
                  threads=1 if device == "cpu" else 0)
    t_sh = time.perf_counter() - t0
    ref = md_trajectory(mc, cfg, steps, 1, device)
    # float64: every component; float32: the total, which a CG stop in
    # another summation order leaves in place while it moves ~5e-4 of |PE|
    # between Eclmb and Echarge
    cols = slice(None) if dtype == "float64" else slice(0, 1)
    err = pe_rel(recs[0]["comps"][:, cols], ref["comps"][:, cols])
    tol = tol if tol is not None else (1e-8 if dtype == "float64" else 1e-4)
    print(f"dryrun: {n} ranks, mesh {mesh}, {device}, mc {tuple(mc)} "
          f"({ref['pos'].shape[0]} atoms), {dtype}, isQEq={isQEq}, "
          f"{steps} step(s): PE components against md.Engine {err:.3e} of "
          f"|PE| (bound {tol}); ranks took {t_sh:.1f} s", flush=True)
    if not (np.isfinite(recs[0]["comps"]).all() and err <= tol
            and recs[0]["n_atoms"] == ref["pos"].shape[0]):
        raise RuntimeError(f"dryrun: PE {err:.3e} of |PE| > {tol} or atoms "
                           f"lost ({recs[0]['n_atoms']})")
    if device != "cpu" and not all(r["captures"] and r["replays"]
                                   for r in recs):
        raise RuntimeError("dryrun: the steps did not run as CUDA graphs "
                           f"({[(r['captures'], r['replays']) for r in recs]}"
                           " captures and replays)")
    return err, recs[0], ref


if __name__ == "__main__":
    run(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "cpu")
