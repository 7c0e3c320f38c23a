"""The sharded engine's programs (`ShardedEngine._block_fn` for its steps
and blocks, `_prep_fn`, `_probe_fn` for the optimizer's probes), on the
CPU over gloo: what lets them run as CUDA graphs with their collectives
inside, as rxmd_tpu runs its shard_map'd programs compiled.

Ranks come from the port's launcher (`dryrun.launch`: spawned processes,
one torch thread a rank, each checking it imported neither jax nor
rxmd_tpu); the rank entries live in `parallel/dryrun.py`.

* A host-read guard (`dryrun.HostReadGuard`, installed inside each rank:
  the ranks are processes) over `_block_fn` for one step and a block of 3
  and over `_probe_fn`, on meshes (1, 1, 1) and (2, 1, 1), at isQEq 1
  and 2 and PQEq: every host read and every tensor made from host data
  raises, but the CG's chunk flags, which every rank reads alike.
  (2, 1, 1) runs the 168-atom cell at rxmd_tpu's reduced knobs (rctap 5
  A, one bonded layer), as test_torch_parallel.py's 8-rank step does.
* The program form of `ShardedEngine.run` (its dispatches through
  `dryrun.HostGraphs`, the CPU's stand-in for graphs.GraphCache) at
  block_steps 3 against the eager path and against rxmd_tpu's
  `ShardedEngine.run` on (1, 1, 1), and on (2, 1, 1) against md.Engine:
  the same block, step and rebuild counts, PRINTE PE components within
  1e-8 of |PE|, positions within 1e-8 A (float64, the CG capped as in
  the other parity tests).
* The probe (`cg_evaluate` over `_probe_fn`: the sizing probe and the
  sized key's first use eagerly, its capture, a replay) against
  rxmd_tpu's `ShardedEngine.cg_evaluate` at the same positions at isQEq
  0, 1 and 2 (mdmode 10, float64, CG capped at 8): PE within 1e-8
  relative, forces within 1e-8 of max|f|, charges within 1e-8 e.  At
  isQEq=0 rxmd_tpu's sharded probe solves no charges
  (rxmd_tpu/parallel/engine.py:967-968, 500-501), so neither does the
  port's.
* A capacity below the live ghosts (`ghost_cap`, at a rebuild and at a
  probe), the bonded rows of a probe (`bond_cap`) or a probe's count
  (the bonded neighbor rows, the uncached angle list) raises on every
  rank, naming it.
* Rebuilds within a bucket keep the window's shapes, so the programs
  captured over it serve the next window without a capture.
* The rebuild (`_rebuild_fn`) and the optimizer's resync (`_resync_fn`)
  under the guard on (1, 1, 1) and (2, 1, 1), equal to the same programs
  unguarded; `rebuild` and `cg_resync` reading the host once each
  (the guard counting); a rebuild whose ghost-row bucket and cell depth
  fall short growing both and running again (two reads), into the window
  a rebuild within the grown bucket leaves; and `cg_resync` on (1, 1, 1)
  against rxmd_tpu's `_cg_resync` per gid.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, system as jsys
from rxmd_tpu.parallel.engine import ShardedEngine as JShardedEngine
from rxmd_tpu_torch import config as tcfg, md as tmd
from rxmd_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
TIMEOUT = 280.0
CELL1 = (1, 1, 1)
REDUCED = dict(rctap=5.0, skin_layers=1.0)
F64 = dict(dtype="float64", QEq_tol=1e-14, NMAXQEq=8)
# the guard's CG runs three chunks (qeq.CG_CHUNK 8) to read its flags
GUARD_CASES = {
    "qeq1": dict(F64, NMAXQEq=24, isQEq=1),
    "qeq2": dict(F64, NMAXQEq=24, isQEq=2),
    "pqeq": dict(F64, NMAXQEq=24, isQEq=1, isPQEq=True,
                 pqeq_parm_path=PAR),
}
MESHES = {"mesh111": (1, 1, 1), "mesh211": (2, 1, 1)}


def _ranks(fn, mesh, *args):
    return dryrun.launch(int(np.prod(mesh)), fn, *args, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def guarded():
    got = {}

    def get(mesh):
        if mesh not in got:
            m = MESHES[mesh]
            got[mesh] = _ranks(dryrun.guarded_programs, m, CELL1,
                               list(GUARD_CASES.items()), m,
                               None if m == (1, 1, 1) else REDUCED)
        return got[mesh]
    return get


@pytest.mark.parametrize("name", list(GUARD_CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_host_read_inside_the_sharded_programs(guarded, mesh, name):
    recs = [r[name] for r in guarded(mesh)]
    for err, _, finite in recs:
        assert err is None, err
        assert finite
    reads = [r[1] for r in recs]
    # every rank reads the same chunk flags (all-reduced scalars), and a
    # full CG of 24 iterations reads them between its chunks
    assert len(set(reads)) == 1, reads
    assert reads[0] >= (1 if name == "qeq2" else 2), reads


# ----------------------------------------------------------------------
# the rebuild and the optimizer's resync

@pytest.fixture(scope="module")
def rebuilt():
    got = {}

    def get(mesh):
        if mesh not in got:
            m = MESHES[mesh]
            got[mesh] = _ranks(dryrun.rebuild_case, m, CELL1,
                               dict(F64, isQEq=1), m,
                               None if m == (1, 1, 1) else REDUCED)
        return got[mesh]
    return get


@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_host_read_inside_the_rebuild_and_resync(rebuilt, mesh):
    for rec in rebuilt(mesh):
        assert rec["guard"] is None, rec["guard"]
        assert rec["same"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_one_host_read_per_rebuild_and_resync(rebuilt, mesh):
    for rec in rebuilt(mesh):
        assert len(rec["rebuild_reads"]) == 1, rec["rebuild_reads"]
        assert len(rec["resync_reads"]) == 1, rec["resync_reads"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rebuild_reruns_when_its_bucket_is_outgrown(rebuilt, mesh):
    """A ghost-row bucket and a cell depth below the rebuild's counts: both
    grow after its read and it runs again (two reads, one regrowth); a
    rebuild from the same state within the grown bucket reads once and
    leaves the same state and window."""
    recs = rebuilt(mesh)
    for rec in recs:
        assert len(rec["regrow_reads"]) == 2, rec["regrow_reads"]
        assert rec["regrowths"] == 1
        assert len(rec["after_reads"]) == 1
        assert rec["same_window"] and rec["rows"] > 8
    assert len({rec["rows"] for rec in recs}) == 1


def test_resync_against_rxmd_tpu():
    """cg_resync on (1, 1, 1) against rxmd_tpu's _cg_resync at the same
    moved positions, per gid: the wrapped positions within 1e-12 A, g and
    p as given."""
    kw = dict(F64, mdmode=10, isQEq=1)
    rec = _ranks(dryrun.resync_case, CELL1, CELL1, kw, CELL1)[0]
    ff = jff.parse_ffield(FF)
    je = JShardedEngine(ff, jsys.from_cellfile(CELL, ff.name_to_type,
                                               mc=CELL1),
                        jcfg.RunConfig(**kw), mesh_shape=CELL1)
    je.init_velocity(seed=1)
    je.prepare()
    s = je.sstate
    gid, valid = np.asarray(s.gid), np.asarray(s.valid)
    order = np.argsort(gid[valid], kind="stable")

    def blk(a):
        out = np.zeros((gid.shape[0], 3))
        out[valid] = a[gid[valid]]
        return jnp.asarray(out)
    got = je.cg_resync(*(blk(a) for a in rec["given"]))
    ref = [np.asarray(x)[valid][order] for x in got]
    pos0 = rec["given"][0]
    assert np.abs(ref[0] - pos0).max() > 1.0       # some atoms wrapped
    assert np.abs(rec["got"][0] - ref[0]).max() <= 1e-12
    for a, b in zip(rec["got"][1:], ref[1:]):
        assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# the run: program form, eager path, rxmd_tpu, md.Engine

RUN_KW = dict(F64, NMAXQEq=12, isQEq=1, block_steps=3, pstep=4)
RUN_STEPS = 12


def _printed_close(got, ref):
    ref = dict(ref)
    common = [(s, c) for s, c in got if s in ref]
    assert len(common) >= 2
    for s, c in common:
        assert np.abs(c - ref[s]).max() <= 1e-8 * abs(ref[s][0]), s


def _counts(rec):
    return {k: rec[k] for k in ("blocks", "steps", "rebuilds")}


def test_program_run_against_eager_and_rxmd_tpu():
    prog = _ranks(dryrun.scheduled_run, CELL1, CELL1, RUN_KW, RUN_STEPS, 1,
                  CELL1, True)[0]
    eager = _ranks(dryrun.scheduled_run, CELL1, CELL1, RUN_KW, RUN_STEPS, 1,
                   CELL1, False)[0]
    assert prog["captures"] >= 1 and prog["replays"] >= 2, prog
    assert eager["captures"] == eager["replays"] == 0
    assert _counts(prog) == _counts(eager) and prog["blocks"] >= 2
    _printed_close(prog["printed"], eager["printed"])
    assert np.abs(prog["pos"] - eager["pos"]).max() <= 1e-8

    ff = jff.parse_ffield(FF)
    je = JShardedEngine(ff, jsys.from_cellfile(CELL, ff.name_to_type,
                                               mc=CELL1),
                        jcfg.RunConfig(**RUN_KW), mesh_shape=CELL1)
    je.init_velocity(seed=1)
    je.prepare()
    printed = []
    je.run(RUN_STEPS, log=lambda line: printed.append(
        (je.step_count, np.asarray(je.comps))))
    _printed_close(prog["printed"], printed)
    assert np.abs(prog["pos"] - np.asarray(je.to_state().pos)).max() \
        <= 1e-8


def test_program_run_two_ranks_against_md_engine():
    mc, mesh = (2, 2, 2), (2, 1, 1)
    kw = dict(RUN_KW, isQEq=2, rebuild_every=4)
    nsteps = 8
    rec = _ranks(dryrun.scheduled_run, mesh, mc, kw, nsteps, 1, mesh,
                 True)[0]
    assert rec["captures"] >= 1 and rec["replays"] >= 1, rec
    assert rec["blocks"] >= 2 and rec["rebuilds"] >= 1, rec
    ff, st = dryrun.load_deck(mc, "float64")
    e = tmd.Engine(ff, st, tcfg.RunConfig(**dict(
        kw, pair_kernel=False, dense_direct_max=0, qeq_dense_max=0)),
        device="cpu")
    e.init_velocity(seed=1)
    e.prepare()
    printed = []
    e.run(nsteps, log=lambda line: printed.append(
        (e.state.step, e.comps.double().numpy())))
    tm = e.timers.ncalls
    assert (rec["blocks"], rec["steps"], rec["rebuilds"]) == (
        tm.get("MD block (dispatch)", 0), tm.get("MD step (dispatch)", 0),
        tm.get("neighbor rebuild", 0))
    _printed_close(rec["printed"], printed)
    assert np.abs(rec["pos"] - e.state.pos.numpy()).max() <= 1e-8


# ----------------------------------------------------------------------
# the probe

@pytest.mark.parametrize("isq", [0, 1, 2])
def test_probe_against_rxmd_tpu(isq):
    kw = dict(F64, mdmode=10, isQEq=isq)
    rec = _ranks(dryrun.probe_case, CELL1, CELL1, kw, CELL1, True)[0]
    assert rec["captures"] == 1 and rec["replays"] == 2, rec
    ff = jff.parse_ffield(FF)
    je = JShardedEngine(ff, jsys.from_cellfile(CELL, ff.name_to_type,
                                               mc=CELL1),
                        jcfg.RunConfig(**kw), mesh_shape=CELL1)
    je.init_velocity(seed=1)
    je.prepare()
    s = je.sstate
    gid, valid = np.asarray(s.gid), np.asarray(s.valid)
    pos = np.zeros((gid.shape[0], 3))
    pos[valid] = rec["pos"][gid[valid]]
    pe, f, q = je.cg_evaluate(jnp.asarray(pos))
    order = np.argsort(gid[valid], kind="stable")
    f = np.asarray(f)[valid][order]
    q = np.asarray(q)[valid][order]
    for k in range(4):
        assert abs(rec["pe"][k] - float(pe)) <= 1e-8 * abs(float(pe))
        assert np.abs(rec["f"][k] - f).max() <= 1e-8 * np.abs(f).max()
        assert np.abs(rec["q"][k] - q).max() <= 1e-8
    if isq == 0:
        # no solve: the charges the state holds (prepare solves none)
        assert np.abs(q).max() == 0.0


# ----------------------------------------------------------------------
# capacities and the window's buckets

CAPACITIES = {
    "ghost_rows_rebuild": (("rebuild", "ghost_cap", 1),
                           r"ghost rows: \d+ > capacity 1 \(ghost_cap\)"),
    "ghost_rows_probe": (("probe", "ghost_cap", 1),
                         r"probe ghost rows: \d+ > capacity 1 "
                         r"\(ghost_cap\)"),
    "bond_rows_probe": (("probe", "bond_cap", 1),
                        r"probe bond rows: \d+ > capacity 1 "
                        r"\(bond_cap\)"),
    "kb_probe": (("probe", "kb", 2), r"neighbor-list overflow: bonded"),
    "angles_probe": (("probe", "caps.ang", 1),
                     r"interaction-list overflow: .*ang \d+/1"),
}


@pytest.fixture(scope="module")
def capacity_errors():
    mesh = (2, 1, 1)
    return _ranks(dryrun.capacity_case, mesh, CELL1, dict(F64, isQEq=1),
                  mesh, [c for c, _ in CAPACITIES.values()], REDUCED)


@pytest.mark.parametrize("name", list(CAPACITIES))
def test_capacity_below_a_count_raises_on_every_rank(capacity_errors,
                                                     name):
    k = list(CAPACITIES).index(name)
    errs = [r[k] for r in capacity_errors]
    assert len(errs) == 2
    for err in errs:
        assert err is not None
        assert re.search(CAPACITIES[name][1], err), err
    assert errs[0] == errs[1]


def test_rebuilds_within_a_bucket_keep_the_programs():
    mesh = (2, 1, 1)
    recs = _ranks(dryrun.window_case, mesh, CELL1,
                  dict(F64, isQEq=2, block_steps=2), mesh, 4, REDUCED)
    for rank in recs:
        same, later = rank
        # at the same positions every count is the same: one window
        assert same["sizes"] and same["shapes"]
        assert same["captures"] == 0 and same["replays"] >= 1
        # after steps: the same buckets give the same shapes, and the
        # programs serve the new window without a capture
        if later["sizes"]:
            assert later["shapes"] and later["captures"] == 0
    assert recs[0] == recs[1]
