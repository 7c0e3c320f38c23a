"""The MD step as a device program: CUDA graphs of single steps and K-step
blocks (counterpart of rxmd_tpu's jitted step and its `lax.scan` blocks,
rxmd_tpu/md.py:298-299, 545-604, 717-738, and of its sharded engine's
shard_map'd programs, rxmd_tpu/parallel/engine.py:622-741, 949-988).

rxmd_tpu compiles a step, or K steps, into one XLA program that the host
dispatches with one call, whatever its configuration, and so the
optimizer's evaluation and the rebuild.  Here a program is a Python
function of tensors (`md.Engine._block_fn`, for every pair engine, box,
term cache, QEq or PQEq mode and force field; `md.Engine._probe_fn` and
`_rebuild_fn`, whose windows are empty and whose caches are their own,
so a rebuild's new shapes never drop them; the sharded engine's
`_block_fn`, `_prep_fn`, `_probe_fn`, `_rebuild_fn` and `_resync_fn`,
whose NCCL collectives are captured with them, parallel/comm.py)
recorded into
CUDA graphs over static input tensors and replayed after `copy_`-ing the
current inputs into them.  A graph holds the addresses of its inputs
(the sweep's kernels take raw pointers, ops/pairsweep.py; every captured
op reads its tensors so): every input is copied, never rebound, and
nothing inside the function reads a tensor on the host (the lists a step
builds have fixed capacities; their counts come out with the step).

A program's inputs come in two parts: the rebuild window's (neighbor and
term lists, slot map, reference positions), copied once after each
rebuild, and the step's carry (state, forces, stress), copied at every
replay.  Its outputs are cloned out of the graph's memory after each
replay.  Programs are cached under their step pattern and the shapes of
both parts; the window's list lengths are padded to sizes that only grow
(md.Engine._size), so after a few rebuilds every window has the same
shapes and reuses the same programs.

The CG of a full QEq or PQEq solve (isQEq=1; qeq._cg, pqeq.solve) ends
on a host read of its finished flag between chunks of iterations
(qeq.eager_loop): PyTorch exposes no conditional `while` node to Python
(2.13 has `if` nodes, CUDAGraph.begin_capture_to_if_node; 2.11 has
none).  So a program is a list of parts: plain graph segments, and
between them the CG's chunk graph, which updates the CG's carry in place
and is replayed until the flag is set.  A program with no such loop (the
extended Lagrangian's one iteration, or no QEq) is one graph.

The first call of a key runs the function eagerly on the cache's stream
(the warm-up: lazy initialization, cached tables, autograd's streams,
NCCL's communicators), the second captures and replays it, with Python's
garbage collector held off (a CUDA graph freed during a capture
invalidates it).  A failed capture raises; nothing falls back to eager
mode.  Each part records the kernel launches it holds
(ops/pairsweep.launches counts them at capture) and adds them to the
counts at every replay.

Tracing (utils/timers.py): each part begins and ends with a device mark,
keyed by the program's kind (`timers.program`) and the part's index, the
CG chunk's under "<kind>.chunk"; every replay logs its launch and its
cause, and host spans time the carry copy, each part's replay and each
flag read.  The captures' seconds are kept per program kind, and the
chunk parts' own.
"""
from __future__ import annotations

import dataclasses
import gc
import time
import weakref

import torch

from .ops import pairsweep
from .utils import timers as trace

def leaves(x):
    """The tensors of a nest of tuples, NamedTuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for e in x for t in leaves(e)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in leaves(getattr(x, f.name))]
    return []


def signature(x):
    """A hashable key of a nest: shape and dtype of each tensor, the value
    of every other leaf."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, tuple):
        return tuple(signature(e) for e in x)
    if dataclasses.is_dataclass(x):
        return tuple(signature(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    return x


def fill(x, tensors):
    """The nest `x` with its tensors replaced, in order, from the iterator
    `tensors`."""
    if isinstance(x, torch.Tensor):
        return next(tensors)
    if isinstance(x, tuple):
        vals = [fill(e, tensors) for e in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: fill(getattr(x, f.name), tensors)
            for f in dataclasses.fields(x)})
    return x


@dataclasses.dataclass
class Part:
    """One captured graph and the launches it holds, named `label`
    ("<program kind>.<index>"); with `fin` a CG loop: replayed up to
    `extra` times while the flag `fin` is unset."""
    graph: torch.cuda.CUDAGraph
    launches: dict
    label: str
    fin: torch.Tensor = None
    extra: int = 0


class Program:
    """A captured program: its parts and its static outputs."""

    def __init__(self):
        self.parts = []
        self.out = None

    def replay(self, after=None):
        """Replay the parts; `after` names the host span before the
        dispatch (the first launch's cause, trace.launch)."""
        counts = pairsweep.launches
        for p in self.parts:
            for _ in range(max(p.extra, 1)):
                if p.fin is not None:
                    with trace.span("CG flag read"):     # one read a chunk
                        done = bool(p.fin)
                    if done:
                        break
                trace.launch(p.label, after)
                after = None
                with trace.span("replay " + p.label):
                    p.graph.replay()
                for k, v in p.launches.items():
                    counts[k] += v


class _Recorder:
    """Captures a function into a Program's parts, ending a segment at each
    CG loop (`loop`, qeq.solve's hook); each part between its marks."""

    def __init__(self, prog, cache):
        self.prog, self.cache = prog, cache

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.held = dict(pairsweep.launches)
        self.graph.capture_begin(pool=self.cache.memory.handle)
        self.name = f"part {len(self.prog.parts)}"
        trace.mark(self.name, 0)

    def end(self, **loop):
        trace.mark(self.name, 1)
        self.graph.capture_end()
        counts = pairsweep.launches
        label = f"{trace.program_kind()}.{len(self.prog.parts)}"
        self.prog.parts.append(Part(self.graph, {
            k: counts[k] - self.held[k] for k in counts}, label, **loop))
        counts.update(self.held)          # a capture launches nothing

    def loop(self, chunk, carry, nchunks):
        carry = chunk(carry)              # the first chunk, in this segment
        if nchunks == 1:
            return carry
        self.end()
        t0 = time.perf_counter()
        kind, device = trace.program_kind(), self.cache.device
        with trace.program(f"{kind}.chunk", device):
            self.begin()
            for a, b in zip(carry, chunk(carry)):
                a.copy_(b)
            self.end(fin=carry.fin, extra=nchunks - 1)
        n, secs = self.cache.last_chunks
        self.cache.last_chunks = (n + 1, secs + time.perf_counter() - t0)
        self.begin()
        return carry


class Memory:
    """The side stream and the memory pool that every graph cache of a
    device shares (`of`): their replays never overlap (one stream), so
    every program captures into one pool, and the blocks that one
    capture frees, or a dropped program leaves, serve the next (a block
    serves its own stream only).  The pool is renewed only where no
    program captured into it is left (a pool whose graphs are all gone
    takes no capture): `held` counts the live ones."""

    _of = {}

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.handle = None
        self.held = 0

    @classmethod
    def of(cls, device):
        if device not in cls._of:
            cls._of[device] = cls(device)
        return cls._of[device]

    def pool(self):
        """The pool's handle, renewed where no program holds it."""
        if not self.held:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle

    def hold(self, prog):
        """Count `prog`, captured into the pool, until it is freed."""
        self.held += 1
        weakref.finalize(prog, self._release)

    def _release(self):
        self.held -= 1

    def gib(self):
        """GiB of the device's memory that the pool holds."""
        if self.handle is None:
            return 0.0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == self.handle
                   ) / 2**30


class GraphCache:
    """An engine's programs on its device's side stream, in its memory
    pool (`Memory`), keyed as the module docstring says."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.memory = Memory.of(self.device)
        self.stream = self.memory.stream
        self.programs = {}     # key -> Program
        self.seen = set()      # keys run once (eagerly)
        self.window = (None, None, None)   # signature, buffers, window id
        self.carries = {}      # carry signature -> buffers
        self.captures = self.replays = 0
        self.capture_s = 0.0
        # the CG chunk parts of the last capture, and their seconds
        # (within capture_s)
        self.last_chunks = (0, 0.0)
        trace.ring(self.device)        # the marks' ring, before any capture

    def run(self, key, fn, window, carry, window_id):
        """fn(window, carry, loop) through the program of `key` (see the
        module docstring); `window_id` changes when the window's tensors
        do."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self._run(key, fn, window, carry, window_id)
        cur.wait_stream(self.stream)
        return out

    def _run(self, key, fn, window, carry, window_id):
        after = trace.last_closed()
        wkey, ckey = signature(window), signature(carry)
        key = (key, wkey, ckey)
        prog = self.programs.get(key)
        if prog is None and key not in self.seen:
            self.seen.add(key)
            return fn(window, carry, None)
        wbuf = self._window(wkey, window, window_id)
        with trace.span("carry copy"):
            cbuf = self.carries.get(ckey)
            if cbuf is None:
                cbuf = self.carries[ckey] = [t.clone()
                                             for t in leaves(carry)]
            for b, t in zip(cbuf, leaves(carry)):
                b.copy_(t)
        if prog is None:
            t0 = time.perf_counter()
            with trace.span("capture"):
                prog = self._capture(fn, fill(window, iter(wbuf)),
                                     fill(carry, iter(cbuf)))
            self.programs[key] = prog
            self.captures += 1
            self.capture_s += time.perf_counter() - t0
        prog.replay(after)
        self.replays += 1
        return fill(prog.out, (t.clone() for t in leaves(prog.out)))

    def _capture(self, fn, window, carry):
        """fn over the static inputs, captured into a Program.  The
        blocks that eager runs left cached go back to the device first:
        a capture allocates only from its pool and the device."""
        torch.cuda.empty_cache()
        self.memory.pool()
        prog = Program()
        rec = _Recorder(prog, self)
        self.last_chunks = (0, 0.0)
        # no garbage collection while capturing: a graph that the
        # collector frees during a capture (an engine dropped in a
        # reference cycle) invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with trace.capturing():
                rec.begin()
                prog.out = fn(window, carry, rec.loop)
                rec.end()
        finally:
            if collecting:
                gc.enable()
        self.memory.hold(prog)
        return prog

    def _window(self, wkey, window, window_id):
        """The static copy of the window's tensors, refreshed once per
        window.  A window of other shapes replaces it, and the programs
        captured over it go, their blocks left to the pool's later
        captures: the window's sizes only grow (md.Engine._size), so
        those shapes do not come back."""
        key, buf, wid = self.window
        if key != wkey:
            self.programs = {}
            buf = [t.clone() for t in leaves(window)]
        elif wid != window_id:
            for b, t in zip(buf, leaves(window)):
                b.copy_(t)
        self.window = (wkey, buf, window_id)
        return buf
