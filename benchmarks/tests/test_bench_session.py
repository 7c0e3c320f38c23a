"""The readers of the port's session record (harness/session.py and the
six metrics on it) on a made-up record, and on none: a port without the
record, or an untraced run, gives no value."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import session, spec  # noqa: E402

MS = 1_000_000           # ns
RECORD = dict(
    phases={("step", "bonded"): (30 * MS, 3), ("block", "bonded"): (90 * MS, 7),
            ("step", "forward"): (20 * MS, 3), ("block", "E:hbond"): (50 * MS, 7),
            ("step", "qeq"): (12 * MS, 3), ("block", "qeq"): (28 * MS, 7),
            ("rebuild", "rebuild"): (18 * MS, 2),
            ("probe", "rebuild"): (99 * MS, 4),
            ("probe", "bonded"): (200 * MS, 4)},
    gaps={"schedule -> step.0": (3 * MS, 3),
          "CG flag read -> block.chunk.1": (7 * MS, 9)},
    counts={"MD steps": 10, "rebuilds": 2, "probes": 4}, spans={}, parts={},
    lost=0, unmatched=0)
MD = dict(trace={}, steps=100)
RELAX = dict(trace={}, iterations=1)


@pytest.mark.parametrize("name, art, want", [
    ("bonded_ms_per_step", MD, 12.0),
    ("qeq_ms_per_step", MD, 4.0),
    ("rebuild_device_ms", MD, 9.0),
    ("launch_gap_ms_per_step", MD, 1.0),
    ("bonded_ms_per_probe", RELAX, 50.0),
    ("launch_gap_ms_per_probe", RELAX, 2.5),
])
def test_readers(name, art, want, monkeypatch):
    read = spec.reader(name)
    monkeypatch.setattr(session, "last", lambda: RECORD)
    got = read(art)
    value, extra = got if isinstance(got, tuple) else (got, {})
    assert value == pytest.approx(want)
    if name.startswith("launch_gap"):
        assert extra == {"n": 12}
    if name == "bonded_ms_per_step":
        assert extra["forward"] == pytest.approx(2.0)
        assert extra["term_hbond"] == pytest.approx(5.0)
    # the other kind of run, an untraced run, no record: nothing
    other = RELAX if art is MD else MD
    assert read(other) is None
    assert read({k: v for k, v in art.items() if k != "trace"}) is None
    monkeypatch.setattr(session, "last", lambda: None)
    assert read(art) is None


def test_no_record_from_a_port_without_it(monkeypatch):
    from rxmd_tpu_torch.utils import timers
    monkeypatch.delattr(timers, "last_session")    # the parent's port
    assert session.last() is None
    monkeypatch.setitem(sys.modules, "rxmd_tpu_torch.utils", None)
    assert session.last() is None
