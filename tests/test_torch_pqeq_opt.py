"""One iteration of the CG optimizer (mdmode 10) under PQEq:
rxmd_tpu_torch against rxmd_tpu in float64 on the CPU, probe by probe.

The 168-atom CHON cell with tests/data/pqeq_chon.par; every probe is a
fresh list, a PQEq solve capped at NMAXQEq (the CG amplifies summation-
order rounding, see test_torch_pairpath.py) and its shell step from the
engine's shells, then the forces.  Bar: every probe's PE, and the final
PE, within 1e-8 relative.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    opt as jopt, system as jsys
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    opt as topt, system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")


def _engines():
    kw = dict(dtype="float64", QEq_tol=1e-12, NMAXQEq=4, mdmode=10,
              isPQEq=True, pqeq_parm_path=PAR)
    jf, tf = jff.parse_ffield(FF), tff.parse_ffield(FF)
    js = jsys.from_cellfile(CELL, jf.name_to_type)
    ts = tsys.from_cellfile(CELL, tf.name_to_type)
    return (lambda: jmd.Engine(jf, js, jcfg.RunConfig(block_steps=1, **kw)),
            lambda: tmd.Engine(tf, ts, tcfg.RunConfig(block_steps=1, **kw),
                               device="cpu"))


@pytest.fixture(scope="module")
def optimizer_runs():
    """One optimizer iteration under PQEq, every probe's PE recorded."""
    mkj, mkt = _engines()
    probes = {"jax": [], "port": []}

    def recording(cls, store):
        evaluate = cls.evaluate

        def wrapped(self, pos):
            out = evaluate(self, pos)
            store.append(float(out[0]))
            return out
        return wrapped
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt._MDAdapter, "evaluate",
                   recording(jopt._MDAdapter, probes["jax"]))
        mp.setattr(topt._MDAdapter, "evaluate",
                   recording(topt._MDAdapter, probes["port"]))
        jpe = jopt.conjugate_gradient(mkj(), max_iter=1, log=None)
        te = mkt()
        tpe = topt.conjugate_gradient(te, max_iter=1, log=None)
    return te, probes, jpe, tpe


def test_optimizer_probe_by_probe(optimizer_runs):
    te, probes, jpe, tpe = optimizer_runs
    assert te.pq is not None and te.pair_engine == "ell"
    pj, pt = np.array(probes["jax"]), np.array(probes["port"])
    assert len(pj) == len(pt) > 2
    assert np.abs(pt - pj).max() <= 1e-8 * np.abs(pj).max()
    assert tpe < pt[0] and abs(tpe - jpe) <= 1e-8 * abs(jpe)
