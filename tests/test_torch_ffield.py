"""rxmd_tpu_torch parameters, package boundary and engine guards.

The port's copy of the force-field parser must give rxmd_tpu's arrays
exactly, and its FFDev built from the ForceField must equal the one built
from rxmd_tpu's FFDev arrays (`ffdev_from_numpy`), which is how the other
parity tests hand the same weights to both packages.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rxmd_tpu import ffield as jff, reax as jrx
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    reax as trx, system as tsys
from rxmd_tpu_torch.ops import pairsweep as tps

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ffs():
    return jff.parse_ffield(FF), tff.parse_ffield(FF)


def test_parse_ffield_matches(ffs):
    jf, tf = ffs
    assert (jf.nso, jf.nboty, jf.nvaty, jf.ntoty, jf.nhbty) == (4, 10, 33, 10, 4)
    for f in dataclasses.fields(jf):
        a, b = getattr(jf, f.name), getattr(tf, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ffdev_from_matches_jax_ffdev(ffs, dtype):
    jf, tf = ffs
    jffd = jrx.ffdev_from(jf, dtype=getattr(jnp, dtype))
    a = trx.ffdev_from_numpy({k: np.asarray(v) for k, v in
                              jffd._asdict().items()},
                             dtype=getattr(torch, dtype))
    b = trx.ffdev_from(tf, dtype=getattr(torch, dtype))
    for f in dataclasses.fields(trx.FFDev):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, int):
            assert x == y, f.name
        else:
            # exact: the same numpy values cast once to the same dtype
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


def test_import_leaves_jax_out():
    code = ("import sys, rxmd_tpu_torch, rxmd_tpu_torch.md, "
            "rxmd_tpu_torch.ops.pairsweep, rxmd_tpu_torch.__main__, "
            "rxmd_tpu_torch.opt, rxmd_tpu_torch.io.traj, "
            "rxmd_tpu_torch.io.refbin, rxmd_tpu_torch.io.checkpoint, "
            "rxmd_tpu_torch.tools.geninit, rxmd_tpu_torch.utils.timers, "
            "rxmd_tpu_torch.pqeq, rxmd_tpu_torch.tools.stat, "
            "rxmd_tpu_torch.tools.plot, rxmd_tpu_torch.tools.bondlifetime; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "import torch; "
            "assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            "assert torch.get_float32_matmul_precision() == 'highest'")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _state():
    tf = tff.parse_ffield(FF)
    return tf, tsys.from_cellfile(CELL, tf.name_to_type)


def test_engine_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tf, st = _state()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmd.Engine(tf, st, tcfg.RunConfig(dtype="float32"), device="cuda")


def test_float64_on_cuda_raises_at_construction(monkeypatch):
    """The CUDA sweep kernels are float32: a float64 engine that asks for
    the sweep (the closed form; float64's default is the table pair-list
    engine) on a card must fail in the constructor, naming the fix, not
    deep in the first sweep.  The card is mocked; the check runs before
    anything touches it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tf, st = _state()
    with pytest.raises(ValueError, match="--dtype float32"):
        tmd.Engine(tf, st, tcfg.RunConfig(dtype="float64",
                                          nonbond_closed_form=True),
                   device="cuda")


def _short_pqeq_file(tmp_path):
    """tests/data/pqeq_chon.par cut to its first two types (C, H): the
    deck's O and N have no rows."""
    lines = open(os.path.join(DATA, "pqeq_chon.par")).readlines()
    rows = [ln for ln in lines if ln[:1] in "CHON" and
            not ln.startswith("NPARMS")]
    path = tmp_path / "short.par"
    path.write_text("NPARMS 2\n" + "".join(rows[:2]))
    return str(path)


# mdmodes 0, 1, 4-8 and 10 are ported; 2, 3 and 9 are not reference modes,
# and isQEq takes 0, 1 and 2; PQEq parameters match the ffield's types by
# row order, so a file short of the deck's types is refused
@pytest.mark.parametrize("kw,exc,what", [
    (dict(mdmode=3), NotImplementedError, "mdmode=3"),
    (dict(isQEq=3), NotImplementedError, "isQEq=3"),
    (dict(isPQEq=True), ValueError, "atom type 3 has no PQEq parameters"),
])
def test_engine_names_missing_paths(kw, exc, what, tmp_path):
    tf, st = _state()
    if kw.get("isPQEq"):
        kw = dict(kw, pqeq_parm_path=_short_pqeq_file(tmp_path))
    with pytest.raises(exc, match=what):
        tmd.Engine(tf, st, tcfg.RunConfig(**kw), device="cpu")


def test_sweep_refuses_other_devices():
    """The sweep's kernel wrappers take CUDA and CPU tensors alone: any
    other device raises before the walk is read."""
    grid = tps.make_pair_grid(np.diag([13.182, 11.574, 10.709]), 10.0,
                              skin=0.4)
    tf, _ = _state()
    fn = tps.make_qeq_pair_fn(trx.ffdev_from(tf, dtype=torch.float32),
                              tf.nso, 100.0)
    planes = torch.zeros((5, grid.nslots), device="meta")
    X = torch.zeros((4, 2), device="meta")
    for what, call in (
            ("nonbond", lambda: tps.nonbond(grid, None, planes, fn)),
            ("qeq_build", lambda: tps.qeq_build(grid, None, planes, fn,
                                                None, 4)),
            ("qeq_apply", lambda: tps.qeq_apply(None, None, X))):
        with pytest.raises(ValueError, match=f"no {what} kernel for device "
                                             "meta"):
            call()
