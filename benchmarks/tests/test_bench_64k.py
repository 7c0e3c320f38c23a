"""rdx_qeq_64k.md_exl on the CPU at a deck that a test run holds, and the
readers of the two memory levels that its cell added.

The configuration's own file, replicated (2, 2, 2), through the `md` kind:
a sound run passes the cell's limits and the control (the reference in
bfloat16 put in the program's place) fails them.  On a card: a capture
after the eager warm-up leaves no more reserved-but-free memory than the
graphs' pool holds, plus a small share of the peak."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_small  # noqa: E402

from harness import judge, session, spec  # noqa: E402

CELL = "rdx_qeq_64k.md_exl"
LEVELS = {"graph_pool_gib": "graph pool GiB",
          "reserved_free_gib": "reserved free GiB"}
# reserved but free memory outside the graphs' pool after set-up, as a
# share of the peak allocated memory at most
OUTSIDE_POOL_SHARE = 0.1


def test_config_is_the_8k_pair_list_config_at_one_ranks_domain():
    cell = spec.cell(CELL)
    base = spec.cell("rdx_qeq_8k_ell.md_exl")
    assert cell.config["deck"]["replicate"] == [8, 8, 6]
    assert cell.traffic == base.traffic
    for key in ("run_config", "engine", "guarantees"):
        assert cell.config[key] == base.config[key]
    assert {k: v for k, v in cell.config["deck"].items()
            if k != "replicate"} == {k: v for k, v in
                                     base.config["deck"].items()
                                     if k != "replicate"}
    assert cell.config["reduced"] == []


def test_sound_run_passes_and_control_fails():
    cell = bench_small.small_cell(CELL, (2, 2, 2))
    ok, nums, ctl = bench_small.run(cell, 5000000021, control=True)
    assert ok, nums
    assert not judge.verdict(ctl, cell.limits)[0], ctl


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_level_readers(name, monkeypatch):
    read = spec.reader(name)
    record = dict(levels={LEVELS[name]: 2.5}, counts={})
    monkeypatch.setattr(session, "last", lambda: record)
    md = dict(trace={}, steps=100)
    assert read(md) == 2.5
    assert read(dict(steps=100)) is None              # untraced
    assert read(dict(trace={}, iterations=1)) is None  # a relaxation
    record.pop("levels")                              # a parent's port
    assert read(md) is None
    monkeypatch.setattr(session, "last", lambda: None)
    assert read(md) is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_capture_after_warmup_leaves_no_cached_blocks(card):
    import torch
    from harness import deck, drive, port
    cell = spec.cell("rdx_qeq_8k_ell.md_exl")
    dev = torch.device("cuda", 0)
    inputs = deck.make(cell.config, cell.traffic, 6000000031)
    eng = port.engine(cell.config, cell.traffic, inputs, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    log, _ = drive.md_setup(eng, cell.traffic)
    eng.run(cell.traffic["chunk_steps"], log=log)     # rebuilds set levels
    c = eng.timers.counters
    assert c["graph captures"] > 0 and c["graph pool GiB"] > 0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    assert c["reserved free GiB"] - c["graph pool GiB"] \
        < OUTSIDE_POOL_SHARE * peak, (c, peak)
