"""rxmd_tpu_torch QEq (CG over the plain QEq sweep) against rxmd_tpu's
qeq.solve, both in float64 on the 168-atom deck.

CG amplifies rounding: two summation orders of the same matvec agree to
~1e-11 after 10 iterations and drift to ~1e-5 by 30, so at the default
stop test (relative Est change < 1e-7) the two solvers may stop at
different iterates.  The full-CG check therefore converges to the
solution (tol 1e-12) and holds charges within 1e-7; the extended-
Lagrangian solve (one iteration) is deterministic and held within 1e-12.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rxmd_tpu import ffield as jff, neighbors as jnb, qeq as jqeq, \
    reax as jrx
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    qeq as tqeq, system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")


@pytest.fixture(scope="module")
def setup():
    tf = tff.parse_ffield(FF)
    te = tmd.Engine(tf, tsys.from_cellfile(CELL, tf.name_to_type),
                    tcfg.RunConfig(dtype="float64", nonbond_closed_form=True),
                    device="cpu")
    te._rebuild(te.state)
    s = te.state
    # the sweep's pair kernels over the rebuild's slot map, with a QEq list
    # of exactly its entries
    ops = te.pairs.data(s.pos, s, None, te._layout._replace(qcap=None))
    ff = jff.parse_ffield(FF)
    jffd = jrx.ffdev_from(ff, dtype=jnp.float64)
    pos, H = jnp.asarray(s.pos.numpy()), jnp.asarray(s.H.numpy())
    types = jnp.asarray(s.types.numpy().astype(np.int32))
    img = jnb.make_image_table(s.n, te.img.nimg, jnp.float64)
    rc2b = np.asarray(jffd.rc2b)
    rc2b = (np.sqrt(rc2b) + 0.4) ** 2 * (rc2b > 0)
    nbrs = jnb.build_neighbors_brute(pos, H, types, img, jnp.asarray(rc2b),
                                     10.4 ** 2, 24, 1024)
    rng = np.random.default_rng(5)
    qsfp = rng.normal(scale=0.2, size=s.n)
    qsfp -= qsfp.mean()

    def jsolve(**kw):
        return jqeq.solve(pos, jnp.zeros(s.n), jnp.asarray(qsfp), H, types,
                          img, nbrs, jffd, closed_form=True, **kw)

    def tsolve(**kw):
        z = torch.zeros(s.n, dtype=torch.float64)
        return tqeq.solve(z, torch.tensor(qsfp), s.types, te.ffd, ops.hessian,
                          **kw)

    return jsolve, tsolve


def test_full_cg_converged(setup):
    jsolve, tsolve = setup
    j = jsolve(isqeq=1, nmax=500, tol=1e-12)
    t = tsolve(isqeq=1, nmax=500, tol=1e-12)
    print(f"full CG tol 1e-12: rxmd_tpu {int(j.iters)} iterations, Est "
          f"{float(j.est):.12e}; port {t.iters} iterations, Est "
          f"{float(t.est):.12e}")
    assert 0 < t.iters < 500
    assert np.abs(np.asarray(j.q) - t.q.numpy()).max() < 1e-7
    assert abs(float(j.est) - float(t.est)) < 1e-9 * abs(float(j.est))
    assert abs(float(t.q.sum())) < 1e-9                 # charge neutrality


def test_extended_lagrangian_one_iteration(setup):
    jsolve, tsolve = setup
    j = jsolve(isqeq=2)
    t = tsolve(isqeq=2)
    assert int(j.iters) == t.iters == 1
    assert np.abs(np.asarray(j.q) - t.q.numpy()).max() < 1e-12
    assert np.abs(np.asarray(j.qs) - t.qs.numpy()).max() < 1e-12
    assert np.abs(np.asarray(j.qt) - t.qt.numpy()).max() < 1e-12


def test_stop_keeps_previous_iterate(setup):
    """At the default tolerance the stop test fires after k updates and
    the solve returns the k-th iterate — the same charges as a solve
    capped at nmax=k, which never evaluates the stop test's iterate."""
    jsolve, tsolve = setup
    t = tsolve(isqeq=1, nmax=500, tol=1e-7)
    j = jsolve(isqeq=1, nmax=500, tol=1e-7)
    print(f"default tol: rxmd_tpu {int(j.iters)} iterations, port "
          f"{t.iters}")
    capped = tsolve(isqeq=1, nmax=t.iters, tol=1e-7)
    assert capped.iters == t.iters
    assert torch.equal(capped.q, t.q)
    assert 0 < t.iters < 500
