"""metrics/nonbond_ms_per_step.py on a made-up session record, and on
none: an untraced run, a relax run or a port without the record gives no
value."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import session, spec  # noqa: E402

MS = 1_000_000           # ns
RECORD = dict(
    phases={("step", "nonbond"): (3 * MS, 3),
            ("block", "nonbond"): (7 * MS, 7),
            ("step", "pairs"): (2 * MS, 3), ("block", "pairs"): (4 * MS, 7),
            ("probe", "nonbond"): (50 * MS, 4),
            ("step", "bonded"): (30 * MS, 3)},
    gaps={}, counts={"MD steps": 10, "probes": 4}, spans={}, parts={},
    lost=0, unmatched=0)
MD = dict(trace={}, steps=100)
RELAX = dict(trace={}, iterations=1)


def test_reader(monkeypatch):
    read = spec.reader("nonbond_ms_per_step")
    monkeypatch.setattr(session, "last", lambda: RECORD)
    value, extra = read(MD)
    assert value == pytest.approx(1.0)
    assert extra == {"pairs": pytest.approx(0.6)}
    assert read(RELAX) is None
    assert read({"steps": 100}) is None
    no_pairs = dict(RECORD, phases={k: v for k, v in RECORD["phases"].items()
                                    if k[1] != "pairs"})
    monkeypatch.setattr(session, "last", lambda: no_pairs)
    assert read(MD)[1] == {"pairs": 0.0}
    monkeypatch.setattr(session, "last", lambda: None)
    assert read(MD) is None
