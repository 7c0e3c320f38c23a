"""The port's trace (rxmd_tpu_torch/utils/timers.py) on the CPU.

* Host spans: nesting paths, total and self time and calls on a fake
  clock, in the session record and in the Timers table.
* A session opens and closes with a torch.profiler session: a fresh record
  each time, kept after the close (`last_session`).
* The eager CPU path's marks (host stamps stand in for the device's) keyed
  by program: steps and blocks, the rebuild program, the probe, whose own
  neighbor build is not a rebuild; nothing marked outside a session or a
  program.
* Launch gaps filed by cause: graphs.Program.replay over fake parts whose
  replays mark their ends on a fake clock, a CG chunk loop among them.
* "QEq iterations" is the sum over every solve (`cg_iters`), in both
  engines.
* Under a CPU torch.profiler no `rxmd/` event is a user annotation.
"""
import os
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rxmd_tpu_torch import config as tcfg, ffield as tff, graphs, \
    md as tmd, system as tsys
from rxmd_tpu_torch.utils import timers as trace

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
CFG = dict(dtype="float64", NMAXQEq=8, QEq_tol=1e-12, isQEq=1, pstep=5,
           nonbond_closed_form=True, pair_kernel=False, dense_direct_max=0,
           block_steps=3)


def _deck():
    ff = tff.parse_ffield(FF)
    frac, typ, cell = tsys.read_geninit_xyz(CELL, ff.name_to_type)
    H = tsys.box_matrix(*cell)
    return ff, tsys.make_state(frac @ H.T, typ, H)


@pytest.fixture(scope="module")
def engine():
    ff, st = _deck()
    e = tmd.Engine(ff, st, tcfg.RunConfig(**CFG), device="cpu")
    e.init_velocity(seed=1)
    e.prepare()
    return e


def _session():
    return profile(activities=[ProfilerActivity.CPU])


class Clock:
    """A fake `time` for the tracing module: perf_counter in seconds and
    perf_counter_ns, advanced by `tick`."""

    def __init__(self):
        self.ns = 0

    def tick(self, ns):
        self.ns += ns

    def perf_counter(self):
        return self.ns * 1e-9

    def perf_counter_ns(self):
        return self.ns


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(trace, "time", c)
    return c


def test_span_nesting_and_self_time(clock):
    tm = trace.Timers()
    with _session():
        with tm("outer"):
            clock.tick(1000)
            for _ in range(2):
                with trace.span("inner"):
                    clock.tick(300)
                    with tm("leaf"):
                        clock.tick(200)
            clock.tick(100)
    s = trace.last_session()["spans"]
    assert set(s) == {"outer", "outer/inner", "outer/inner/leaf"}
    tot, own, n = s["outer"]
    assert n == 1 and tot == pytest.approx(2100e-9)
    assert own == pytest.approx(1100e-9)
    tot, own, n = s["outer/inner"]
    assert n == 2 and tot == pytest.approx(1000e-9)
    assert own == pytest.approx(600e-9)
    assert s["outer/inner/leaf"] == pytest.approx((400e-9, 400e-9, 2))
    # the Timers table keeps its own spans by name; `span` stays out of it
    assert tm.ncalls == {"outer": 1, "leaf": 2}
    assert tm.acc["leaf"] == pytest.approx(400e-9)
    assert trace.last_closed() == "outer"


def test_session_opens_and_closes_with_the_profiler():
    tm = trace.Timers()
    with _session():
        with tm("first"):
            pass
        tm.count("probes", 2)
    first = trace.last_session()
    assert set(first["spans"]) == {"first"}
    assert first["counts"] == {"probes": 2}
    # closed: later spans and counts stay out of the record, which stays
    with tm("after"):
        pass
    tm.count("probes", 1)
    assert trace.last_session() == first
    with _session():
        with tm("second"):
            pass
    second = trace.last_session()
    assert set(second["spans"]) == {"second"} and second["counts"] == {}
    assert tm.counters["probes"] == 3


def test_levels_hold_and_a_session_keeps_their_largest(monkeypatch):
    monkeypatch.setattr(trace, "_levels", {})
    tm = trace.Timers()
    tm.level("graph pool GiB", 4.5)
    tm.level("reserved free GiB", 3.0)
    with _session():
        tm.level("reserved free GiB", 5.0)
        tm.level("reserved free GiB", 1.25)
    s = trace.last_session()
    # the largest in the session, from the level that held when it opened
    assert s["levels"] == {"graph pool GiB": 4.5, "reserved free GiB": 5.0}
    assert s["counts"] == {}
    assert tm.counters["reserved free GiB"] == 1.25    # the level set last
    tm.level("graph pool GiB", 9.0)                    # after the close
    assert trace.last_session()["levels"]["graph pool GiB"] == 4.5
    with _session():
        tm.count("probes", 1)          # a count: the session is seen
    assert trace.last_session()["levels"] == {"graph pool GiB": 9.0,
                                              "reserved free GiB": 1.25}
    assert "reserved free GiB      1.250" in "\n".join(tm.summary_lines())


def test_marks_need_a_session_and_a_program():
    with _session():
        trace.mark("outside", 0)           # no program
        with trace.program("step", "cpu"), trace.phase("inside"):
            pass
    assert set(trace.last_session()["phases"]) == {("step", "inside")}
    with trace.program("step", "cpu"), trace.phase("no session"):
        pass
    assert set(trace.last_session()["phases"]) == {("step", "inside")}
    assert trace.program_kind() is None


def test_eager_cpu_marks_keyed_by_program(engine):
    e = engine
    with _session():
        e.run(6, log=None)                 # steps and one block
        e._rebuild(e.state)
        e.probe(e.state.pos)
    s = trace.last_session()
    ph = s["phases"]
    steps = sum(ph[(k, "bonded")][1] for k in ("step", "block")
                if (k, "bonded") in ph)
    assert steps == s["counts"]["MD steps"] == 6
    assert ph[("block", "bonded")][1] == 3       # one block of 3 steps
    for kind in ("step", "block", "probe"):
        for name in ("pairs", "qeq", "nonbond", "bonded", "forward",
                     "backward", "E:bond order", "E:hbond"):
            ns, n = ph[(kind, name)]
            assert ns > 0 and n >= 1, (kind, name)
        # the forward and the backward lie inside "bonded"
        assert ph[(kind, "forward")][0] + ph[(kind, "backward")][0] \
            <= ph[(kind, "bonded")][0]
    # the rebuild program's marks are the rebuilds'; the probe's own
    # neighbor build is its program's
    assert ph[("rebuild", "rebuild")][1] == s["counts"]["rebuilds"] >= 1
    assert ph[("probe", "rebuild")][1] == s["counts"]["probes"] == 1
    assert s["gaps"] == {} and s["lost"] == 0     # no captured parts
    assert {"MD step (dispatch)", "MD block (dispatch)",
            "MD block (end read)", "probe", "probe/dispatch", "probe/read",
            "probe/checks", "dispatch", "read", "checks"} <= set(s["spans"])
    lines = e.summary()
    assert any("step / bonded" in ln for ln in lines)


class _FakeGraph:
    """A captured part's stand-in: a replay marks the part's start after
    `idle` ns and its end after `busy` more, as its device marks would,
    and sets `fin` at every `finish`-th replay."""

    def __init__(self, clock, kind, k, idle, busy, fin=None, finish=0):
        self.clock, self.kind, self.k = clock, kind, k
        self.idle, self.busy, self.fin, self.finish = idle, busy, fin, finish
        self.n = 0

    def replay(self):
        with trace.program(self.kind, "cpu"):
            self.clock.tick(self.idle)
            trace.mark(f"part {self.k}", 0)
            self.clock.tick(self.busy)
            trace.mark(f"part {self.k}", 1)
        self.n += 1
        if self.fin is not None and self.n % self.finish == 0:
            self.fin.fill_(True)


def test_launch_gaps_filed_by_cause(clock):
    fin = torch.zeros((), dtype=torch.bool)
    prog = graphs.Program()
    parts = [("probe", 0, 100, 5000, None, 0),
             ("probe.chunk", 1, 40, 2000, fin, 2),
             ("probe", 2, 70, 3000, None, 0)]
    for kind, k, idle, busy, f, finish in parts:
        prog.parts.append(graphs.Part(
            _FakeGraph(clock, kind, k, idle, busy, f, finish), {},
            f"{kind}.{k}", fin=f, extra=5 if f is not None else 0))
    with _session():
        with trace.span("probe read"):
            pass
        clock.tick(900)                 # the host after the read
        prog.replay(after="probe read")  # nothing before it: no gap
        clock.tick(500)
        fin.fill_(False)
        prog.replay(after="probe read")
    s = trace.last_session()
    gaps = s["gaps"]
    # per replay: 2 chunk replays (the flag set by the second), each after
    # a flag read, then the last segment after the flag read that ends
    # the loop
    assert gaps["probe read -> probe.0"] == (500 + 100, 1)
    assert gaps["CG flag read -> probe.chunk.1"] == (2 * 40 * 2, 4)
    assert gaps["CG flag read -> probe.2"] == (2 * 70, 2)
    assert s["unmatched"] == 0
    assert s["parts"][("probe.chunk", "part 1")] == (4 * 2000, 4)
    assert s["spans"]["CG flag read"][2] == 6
    assert s["spans"]["replay probe.chunk.1"][2] == 4


def test_qeq_iterations_is_the_sum_over_every_solve():
    ff, st = _deck()
    e = tmd.Engine(ff, st, tcfg.RunConfig(**CFG), device="cpu")
    e.init_velocity(seed=2)
    e.run(5, log=None)
    done = int(e.cg_iters)
    e.run(1, log=None)          # its PRINTE's read: the sum until then
    assert e.timers.counters["QEq iterations"] == done > 5
    e.summary()
    assert e.timers.counters["QEq iterations"] == int(e.cg_iters) > done


def test_sharded_qeq_iterations_is_the_sum_over_every_solve():
    from rxmd_tpu_torch.parallel.engine import ShardedEngine
    ff, st = _deck()
    e = ShardedEngine(ff, st, tcfg.RunConfig(**CFG), device="cpu")
    e.init_velocity(seed=2)
    e.run(5, log=None)
    done = int(e.cg_iters)
    e.run(1, log=None)
    assert e.timers.counters["QEq iterations"] == done > 5
    e.summary()
    assert e.timers.counters["QEq iterations"] == int(e.cg_iters) > done


def test_no_rxmd_event_is_a_user_annotation(engine):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run(2, log=None)
    ours = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith("rxmd/")]
    assert {ev.name() for ev in ours} >= {"rxmd/MD step (dispatch)",
                                          "rxmd/schedule"}
    assert not [ev.name() for ev in ours if ev.is_user_annotation()]


def test_drain_reads_nothing_without_a_session(monkeypatch):
    ring = types.SimpleNamespace(drained=0, reset=lambda: None)
    ring.drain = lambda rec: setattr(ring, "drained", ring.drained + 1)
    monkeypatch.setitem(trace._rings, torch.device("cpu"), ring)
    trace.drain()
    assert ring.drained == 0
    with _session():
        with trace.span("read"):
            pass
        trace.drain()
    assert ring.drained == 1
