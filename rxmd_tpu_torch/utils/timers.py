"""Timing and tracing of the port: host spans, device marks, and the record
of a profiler session (counterpart of rxmd_tpu.utils.timers).

The reference accumulates `system_clock` ticks into a 30-slot array
`it_timer` around every significant subroutine (ref: module.F90:215-217)
and prints a per-phase max/min seconds table plus peak array occupancies
and memory at exit (`FinalizeMD`, ref: main.F90:128-186): `Timers` keeps
that table.

Host spans.  `Timers.__call__(name)` and `span(name)` time a block on the
host clock (`time.perf_counter`) and open a profiler range named
`rxmd/<path>`, the path being the names of the open spans, outermost
first, so that a torch.profiler trace shows each span on the kernels'
clock.  The range is torch's `_RecordFunctionFast`, a plain CPU operation
in a trace; a Python `record_function` is a user annotation, which a CUDA
trace also shows as a device event spanning the kernels launched inside
it, the device's idle gaps included.  CUDA work is asynchronous: a span
that ends without a read times its enqueue, and the read after it pays
for the wait.

Device marks.  `phase(name)` marks its start and end on the device: a
one-thread kernel (csrc/marks.cu) takes the next slot of a fixed ring in
device memory by atomicAdd and writes there the mark's id and the device's
clock (%globaltimer, ns).  Inside a CUDA graph capture the kernel is
always captured, so each replay of a graph appends its own marks; outside
a capture it runs only while a session records.  On the CPU the ops are
synchronous and a mark is the host's clock, taken while a session records.
A mark's id names the program it ran in (`program(kind, device)`, set by
the engine around a dispatch: "step", "block", "probe", "rebuild", ...,
and "<kind>.chunk" inside a CG chunk graph) and its phase; outside a
program nothing is marked.  graphs.py marks the start and end of every
captured part and logs each part's launch with its cause (`launch`), so
the device time between one part's end and the next one's start is filed
by what the host was doing.

Sessions.  While a torch.profiler session is open
(`torch.autograd.profiler._is_profiler_enabled`) the spans, counts, marks
and launches go into a record, started afresh when the session opens.
The ring is read into it only then, after reads the program makes anyway
(`drain`): with no session the port adds no read and no synchronize.  The
record stays after the session closes: `last_session()`.
"""
from __future__ import annotations

import ctypes
import functools
import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler

from .. import native

try:
    _Range = torch._C._profiler._RecordFunctionFast
except AttributeError:             # a torch without it: spans, no ranges
    _Range = None

_MARKS_SRC = native.source("marks.cu")
RING_SLOTS = 1 << 16               # marks the ring holds between reads

_stack = []           # the open spans, innermost last
_closed = None        # the path of the span closed last
_session = None       # the open session's Record, or None
_last = None          # the last session's Record
_ids = {}             # (program, phase, edge) -> mark id
_keys = []            # mark id -> (program, phase, edge)
_program = None       # (kind, device) being dispatched, or None
_capturing = False    # a CUDA graph capture is running
_rings = {}           # device -> _Ring
_levels = {}          # level name -> the value set last (Timers.level)


def _poll():
    """The open session's Record: started when a profiler session is
    found open, dropped when it is found closed."""
    global _session, _last
    if _profiler._is_profiler_enabled:
        if _session is None:
            _session = _last = Record()
            for ring in _rings.values():
                ring.reset()
    elif _session is not None:
        _session = None
    return _session


class _Span:
    """A host span (see the module docstring); `sink` a Timers that adds
    it to its table."""

    __slots__ = ("name", "sink", "path", "child", "rng", "t0")

    def __init__(self, name, sink=None):
        self.name, self.sink = name, sink

    def __enter__(self):
        _poll()
        self.path = f"{_stack[-1].path}/{self.name}" if _stack else self.name
        self.child = 0.0
        self.rng = None
        if _Range is not None:
            self.rng = _Range("rxmd/" + self.path)
            self.rng.__enter__()
        _stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _closed
        dt = time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(*exc)
        _stack.pop()
        if _stack:
            _stack[-1].child += dt
        _closed = self.path
        if self.sink is not None:
            self.sink.add(self.name, dt)
        if _session is not None:
            _session.span(self.path, dt, dt - self.child)
        return False


def span(name):
    """A host span `name` kept by no Timers (see the module docstring)."""
    return _Span(name)


def last_closed():
    """The path of the host span closed last."""
    return _closed


class Timers:
    """Named wall-clock accumulators + scalar counters.

    Usage::

        t = Timers()
        with t("neighbor rebuild"):          # a span, see `span`
            ...
        t.count("MD steps", 10)
        print("\n".join(t.summary_lines()))
    """

    def __init__(self):
        self.acc: dict[str, float] = {}
        self.ncalls: dict[str, int] = {}
        self.counters: dict[str, float] = {}
        self.peaks: dict[str, tuple[float, float]] = {}  # name -> (used, cap)
        self._t0 = time.perf_counter()

    def __call__(self, name: str):
        return _Span(name, self)

    def add(self, name: str, seconds: float, calls: int = 1):
        self.acc[name] = self.acc.get(name, 0.0) + seconds
        self.ncalls[name] = self.ncalls.get(name, 0) + calls

    def count(self, name: str, inc: float = 1):
        """Add `inc` to the counter `name`, and to the open session's."""
        self.counters[name] = self.counters.get(name, 0) + inc
        if _poll() is not None:
            _session.counts[name] = _session.counts.get(name, 0) + inc

    def level(self, name: str, value: float):
        """Set the counter `name` to `value`, a level that holds until it
        is set again; a session keeps the largest level it saw, from the
        one that held when it opened."""
        self.counters[name] = value
        _levels[name] = value
        if _poll() is not None:
            _session.levels[name] = max(_session.levels.get(name, value),
                                        value)

    def peak(self, name: str, used: float, cap: float):
        """Track max occupancy of a fixed-capacity array (the analog of the
        reference's `maxas` statistics, ref: main.F90:128-146)."""
        old = self.peaks.get(name, (0.0, cap))[0]
        self.peaks[name] = (max(old, used), cap)

    # ------------------------------------------------------------------
    def summary_lines(self, device=None) -> list[str]:
        """FinalizeMD-style report (ref: main.F90:128-186).  For a CUDA
        `device` the last line is its allocated and peak allocated memory."""
        out = ["-" * 60, f"{'phase':>28s} {'seconds':>10s} {'calls':>8s}"]
        total = time.perf_counter() - self._t0
        for name, sec in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            out.append(f"{name:>28s} {sec:10.3f} {self.ncalls[name]:8d}")
        out.append(f"{'total wall':>28s} {total:10.3f}")
        for name, val in self.counters.items():
            out.append(f"{name:>28s} {val:10.0f}" if float(val).is_integer()
                       else f"{name:>28s} {val:10.3f}")
        if self.peaks:
            out.append(f"{'-- peak occupancy --':>28s}")
            for name, (used, cap) in self.peaks.items():
                pct = 100.0 * used / cap if cap else 0.0
                out.append(f"{name:>28s} {int(used):6d} /{int(cap):6d} "
                           f"({pct:5.1f}%)")
        if device is not None and torch.device(device).type == "cuda":
            mb = torch.cuda.memory_allocated(device) / 2**20
            pk = torch.cuda.max_memory_allocated(device) / 2**20
            out.append(f"{'device memory [MB]':>28s} {mb:10.1f} "
                       f"(peak {pk:.1f})")
        out.append("-" * 60)
        return out


# ---------------------------------------------------------------------------
# device marks
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    return native.load(_MARKS_SRC, "rxmd_mark_error_string",
                       rxmd_mark=[vp, ll, ll, vp])


class _Ring:
    """A device's ring of marks (csrc/marks.cu's layout): row 0 the count
    of marks ever taken, row 1 + (i mod RING_SLOTS) mark i as (id, ns)."""

    def __init__(self, device):
        self.buf = torch.zeros((RING_SLOTS + 1, 2), dtype=torch.int64,
                               device=device)
        self.lib = _library()
        self.read = 0          # marks read so far

    def mark(self, mid):
        self.lib.rxmd_mark(self.buf.data_ptr(), RING_SLOTS - 1, mid,
                           native.stream(self.buf.device))

    def reset(self):
        """Restart the count, in stream order (no host read)."""
        self.buf[0, 0].zero_()
        self.read = 0

    def drain(self, rec):
        """Append the marks taken since the last drain to `rec` (two host
        reads); marks overwritten before it count as lost."""
        n = int(self.buf[0, 0])
        a = max(self.read, n - RING_SLOTS)
        rec.lost += a - self.read
        if n > a:
            i, j = a % RING_SLOTS, (n - 1) % RING_SLOTS + 1
            rows = self.buf[1 + i:1 + j] if i < j else torch.cat(
                [self.buf[1 + i:], self.buf[1:1 + j]])
            rec.marks.extend(map(tuple, rows.cpu().tolist()))
        self.read = n


def ring(device):
    """The ring of `device` (a CUDA device), made at its first use: a graph
    cache makes it before its first capture, whose marks address it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _rings:
        _rings[device] = _Ring(device)
    return _rings[device]


def mark(name, edge):
    """Mark the start (`edge` 0) or end (1) of `name` in the program being
    dispatched (see the module docstring)."""
    if _program is None or not (_capturing or _poll() is not None):
        return
    kind, device = _program
    key = (kind, name, edge)
    mid = _ids.get(key)
    if mid is None:
        mid = _ids[key] = len(_keys)
        _keys.append(key)
    if device.type == "cuda":
        ring(device).mark(mid)
    else:
        _session.marks.append((mid, time.perf_counter_ns()))


class phase:
    """Device marks at the start and end of a block (see `mark`)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        mark(self.name, 0)
        return self

    def __exit__(self, *exc):
        mark(self.name, 1)
        return False


@contextmanager
def program(kind, device):
    """The program of kind `kind` being dispatched on `device`: the key of
    the marks made inside."""
    global _program
    saved = _program
    _program = (kind, torch.device(device))
    try:
        yield
    finally:
        _program = saved


def program_kind():
    """The kind of the program being dispatched, or None."""
    return None if _program is None else _program[0]


@contextmanager
def capturing():
    """A CUDA graph capture is running: its marks are always made."""
    global _capturing
    saved = _capturing
    _capturing = True
    try:
        yield
    finally:
        _capturing = saved


def launch(label, after=None):
    """Log the launch of the captured part `label` with its cause, "<span
    closed last, or `after`> -> <label>" (in an open session only)."""
    if _session is not None:
        _session.launches.append(f"{after or _closed} -> {label}")


def drain():
    """Read the device rings into the open session; nothing without one.
    Called after reads the program makes anyway."""
    if _poll() is not None:
        for r in _rings.values():
            r.drain(_session)


# ---------------------------------------------------------------------------
# the session record
# ---------------------------------------------------------------------------

class Record:
    """What one profiler session saw, as it came: spans, counts, marks
    (id, ns) in the order they were taken, part launches' causes."""

    def __init__(self):
        self.spans = {}        # path -> [total s, self s, calls]
        self.counts = {}
        self.levels = dict(_levels)
        self.marks = []
        self.launches = []
        self.lost = 0

    def span(self, path, dt, own):
        s = self.spans.setdefault(path, [0.0, 0.0, 0])
        s[0] += dt
        s[1] += own
        s[2] += 1

    def summary(self):
        """dict(spans {path: (total s, self s, calls)}, phases {(program,
        phase): (ns, count)}, parts {(program, "part k"): (ns, count)},
        gaps {cause: (ns, count)}: the device time from a part's end to
        the next part's start, filed under the next launch's cause,
        counts, levels: each level's largest (Timers.level), lost: marks
        overwritten before a read, unmatched: part starts without a launch
        logged or launches without a start)."""
        opened, phases, parts, gaps = {}, {}, {}, {}
        end, k = None, 0
        for mid, t in self.marks:
            kind, name, edge = _keys[mid]
            key = (kind, name)
            is_part = name.startswith("part ")
            if edge == 0:
                opened.setdefault(key, []).append(t)
                if is_part:
                    if end is not None and k < len(self.launches):
                        _add(gaps, self.launches[k], t - end)
                    k += 1
            elif opened.get(key):
                _add(parts if is_part else phases, key,
                     t - opened[key].pop())
                if is_part:
                    end = t
        return dict(spans={p: tuple(v) for p, v in self.spans.items()},
                    phases=phases, parts=parts, gaps=gaps,
                    counts=dict(self.counts), levels=dict(self.levels),
                    lost=self.lost,
                    unmatched=abs(len(self.launches) - k))


def _add(d, key, ns):
    ns0, n0 = d.get(key, (0, 0))
    d[key] = (ns0 + ns, n0 + 1)


def last_session():
    """The summary (`Record.summary`) of the last profiler session, or
    None if none was seen.  A session is seen to open and close at a span,
    a count or this call."""
    _poll()
    return None if _last is None else _last.summary()


def session_lines():
    """The last session's table, 12 rows of each: spans by self time,
    device time by program and phase, launch gaps by cause ([] without a
    session)."""
    top = 12
    s = last_session()
    if s is None:
        return []
    out = ["-" * 60, "last profiler session: host spans (s: total, self; "
           "calls)"]
    for path, (tot, own, n) in sorted(s["spans"].items(),
                                      key=lambda kv: -kv[1][1])[:top]:
        out.append(f"  {path[-48:]:>48s} {tot:9.4f} {own:9.4f} {n:7d}")
    out.append("device marks (ms: total; count) by program / phase")
    for (kind, name), (ns, n) in sorted(s["phases"].items(),
                                        key=lambda kv: -kv[1][0])[:top]:
        out.append(f"  {kind + ' / ' + name:>48s} {ns * 1e-6:9.3f} {n:7d}")
    out.append("launch gaps (ms: total; count) by cause")
    for cause, (ns, n) in sorted(s["gaps"].items(),
                                 key=lambda kv: -kv[1][0])[:top]:
        out.append(f"  {cause[-48:]:>48s} {ns * 1e-6:9.3f} {n:7d}")
    out.append(f"  counts {s['counts']}; levels {s['levels']}; marks lost "
               f"{s['lost']}")
    out.append("-" * 60)
    return out


class RunProfile:
    """Per-print-interval profile file writer.

    The reference declares `saveRunProfile` / `RunProfilePath`
    (ref: module.F90:271-273; file closed at main.F90:126) for a per-run
    performance summary.  Lines: step, wall seconds since start, current
    atom-steps/s, QEq iterations at this step.
    """

    def __init__(self, path: str, natoms: int):
        self._fh = open(path, "w")
        self._fh.write("# step  wall_s  atom_steps_per_s  nqeq\n")
        self._t0 = time.time()
        self._last = (0, self._t0)
        self._n = natoms

    def record(self, step: int, nqeq: int):
        now = time.time()
        s0, t0 = self._last
        rate = self._n * (step - s0) / (now - t0) if step > s0 else 0.0
        self._fh.write(f"{step:9d} {now - self._t0:12.4f} {rate:14.4e} "
                       f"{nqeq:5d}\n")
        self._fh.flush()
        self._last = (step, now)

    def close(self):
        self._fh.close()
