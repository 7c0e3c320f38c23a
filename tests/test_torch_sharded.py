"""rxmd_tpu_torch's ShardedEngine and the slab writers against the port's
single-device md.Engine (and one case against rxmd_tpu's), on the CPU
over gloo.

Deck: the CHON cell replicated (2, 2, 2), 1,344 atoms, float64, the CG
capped at NMAXQEq = 8 with QEq_tol 1e-14 so both engines take the same
iterations (the CG amplifies summation-order rounding, see
test_torch_pairpath.py; the Est weights of the stop test also differ by
design between a domain's residents and ghosts, rxmd_tpu
tests/test_sharded_product.py:32-38), rebuild_every = 2 so the wrap,
migration and plan rebuilds run.  md.Engine runs the pair list with its
CG matvec (pair_kernel=False, dense_direct_max=0, qeq_dense_max=0).

Ranks come from the port's launcher (`dryrun.launch`: one torch thread a
rank, a join timeout, each rank checking it imported neither jax nor
rxmd_tpu).  Bars, every step from prepare on: PE components within 1e-8
of |PE|, forces on the residents (gathered by gid) within 1e-8 of
max|f|, charges within 1e-8 of max|q|, the PRINTE pressure within 1e-8
relative (or 1e-8 GPa), and the PRINTE lines equal to their printed digits.  Cases: isQEq 1 on
mesh (1,1,1), isQEq 2 on (2,1,1) (also against rxmd_tpu.md.Engine),
mdmode 5 on (1,2,1), PQEq on (2,1,1) (local x 13.18 A >= its skin of
13.0 A).  Then the slab writers byte for byte against the gathered
writers.  The optimizer and the program run in test_torch_parallel.py.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    system as jsys
from rxmd_tpu_torch import ffield as tff
from rxmd_tpu_torch.parallel import dryrun
from test_torch_parallel import same_printe

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
MC = (2, 2, 2)
NSTEPS = 3
TIMEOUT = 280.0
BASE = dict(dtype="float64", QEq_tol=1e-14, NMAXQEq=8, rebuild_every=2,
            pstep=1, block_steps=1)
CASES = {
    "qeq1_mesh111": ((1, 1, 1), dict(isQEq=1)),
    "qeq2_mesh211": ((2, 1, 1), dict(isQEq=2)),
    "mdmode5_mesh121": ((1, 2, 1), dict(isQEq=1, mdmode=5, sstep=1,
                                        treq=500.0)),
    "pqeq_mesh211": ((2, 1, 1), dict(isQEq=2, isPQEq=True,
                                     pqeq_parm_path=PAR)),
}


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def runs():
    return {}


def _case(runs, name):
    """The sharded ranks' and md.Engine's records of a case, computed once
    per module."""
    if name not in runs:
        mesh, over = CASES[name]
        cfg = dict(BASE, **over)
        recs = dryrun.launch(int(np.prod(mesh)), dryrun.trajectory, MC, cfg,
                             NSTEPS, 1, mesh, timeout=TIMEOUT)
        ref = dryrun.md_trajectory(MC, cfg, NSTEPS, 1)
        runs[name] = dict(name=name, mesh=mesh, cfg=cfg, recs=recs, ref=ref)
    return runs[name]


@pytest.fixture(params=list(CASES))
def case(request, runs):
    return _case(runs, request.param)


def test_engine_per_step(case):
    a, b = case["recs"][0], case["ref"]
    assert a["mesh"] == case["mesh"] and a["n_atoms"] == 1344
    assert np.isfinite(a["comps"]).all()
    assert dryrun.pe_rel(a["comps"], b["comps"]) <= 1e-8
    for k in range(NSTEPS + 1):
        assert rel(a["forces"][k], b["forces"][k]) <= 1e-8, k
        assert rel(a["q"][k], b["q"][k]) <= 1e-8, k
    assert np.abs(a["press"] - b["press"]).max() <= \
        1e-8 * max(np.abs(b["press"]).max(), 1.0)
    for la, lb in zip(a["lines"], b["lines"]):
        same_printe(la, lb)
    assert a["cg_iters"] == b["cg_iters"]
    # every rank computed the same global values
    for r in case["recs"][1:]:
        assert np.array_equal(r["comps"], a["comps"])
        assert r["lines"] == a["lines"]
    if case["cfg"].get("isPQEq"):
        d = np.abs(a["spos"] - b["spos"]).max()
        assert d <= 1e-10 and np.abs(b["spos"]).max() > 0
        # the caller's ForceField kept its chi and eta (ROADMAP §3)
        f = tff.parse_ffield(FF)
        assert np.array_equal(a["ff_chi"], f.chi)
        assert np.array_equal(a["ff_eta"], f.eta)


def test_engine_against_rxmd_tpu(runs):
    """The isQEq 2 case on two ranks against rxmd_tpu's single-device
    engine on the same input."""
    case = _case(runs, "qeq2_mesh211")
    ff = jff.parse_ffield(FF)
    js = jsys.from_cellfile(CELL, ff.name_to_type, mc=MC)
    je = jmd.Engine(ff, js, jcfg.RunConfig(
        pair_kernel=False, dense_direct_max=0, qeq_dense_max=0,
        **case["cfg"]))          # block_steps=1 from BASE
    je.init_velocity(seed=1)
    comps = [np.asarray(je.prepare())]
    for _ in range(NSTEPS):
        je.run(1, log=None)
        comps.append(np.asarray(je.comps))
    assert dryrun.pe_rel(case["recs"][0]["comps"], np.array(comps)) <= 1e-8


def test_slab_writers_byte_identical(tmp_path):
    """Each rank writes its residents (io/slab.py); the files equal
    traj.write_xyz and refbin.write_rxff_bin(vprocs=mesh) of the gathered
    state byte for byte."""
    cfg = dict(dtype="float64", isQEq=2, NMAXQEq=8)
    dryrun.launch(2, dryrun.slab_case, MC, cfg, (2, 1, 1), str(tmp_path),
                  timeout=TIMEOUT)
    for ext in ("xyz", "bin"):
        a = (tmp_path / f"slab.{ext}").read_bytes()
        b = (tmp_path / f"ref.{ext}").read_bytes()
        assert len(a) > 1000 and a == b, ext
