"""PQEq's CG as rxmd_tpu's on-device loop: the port's masked, chunked CG
(`pqeq.solve`, chunks of `qeq.CG_CHUNK` iterations through the `loop`
hook) against rxmd_tpu.pqeq.solve's `lax.while_loop`, in float64 on the
CPU.

Deck: the 168-atom CHON cell with tests/data/pqeq_chon.par, the 12.5 A
PQEq taper, the port's skinned neighbor list handed to both packages,
charges and shell displacements drawn from a seed.  The CG amplifies
the packages' summation-order rounding from update to update (see
test_torch_pairpath.py), so the stop tolerance is chosen to stop both
after 7 updates, well clear of it: the relative change of Est at the
stop sits below half the tolerance, the one before above twice it.  The chunk size places the stop inside a chunk, on a
chunk boundary, or past NMAXQEq.  Bars: the same iteration count, charges and shells within
1e-12 (e, A), Est within 1e-12 relative, and one host read of the
finished flag per chunk but the last, the chunks counted.
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxmd_tpu import ffield as jff, neighbors as jnb, pqeq as jpq, \
    reax as jrx
from rxmd_tpu_torch import ffield as tff, md as tmd, neighbors as tnb, \
    pqeq as tpq, qeq as tqeq, reax as trx, system as tsys, units

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
RCTAP = units.RCTAP0_PQEQ
SKIN = 0.4
TOL = 1.6e-3
ARGS = ("pos", "spos", "q", "q", "H", "types", "img", "nbrs", "ffd", "pq",
        "amask")


def t2j(x):
    x = x.numpy()
    return jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)


@pytest.fixture(scope="module")
def deck():
    """Both packages' solve arguments on the same geometry, list, charges
    and shells, and rxmd_tpu's uncapped stop iteration."""
    par = jpq.parse_pqeq_par(PAR)
    jf = jpq.apply_to_ff(jff.parse_ffield(FF), par)
    tf = tpq.apply_to_ff(tff.parse_ffield(FF), tpq.parse_pqeq_par(PAR))
    jffd = jrx.ffdev_from(jf, dtype=jnp.float64, rctap=RCTAP)
    tffd = trx.ffdev_from_numpy({k: np.asarray(v)
                                 for k, v in jffd._asdict().items()})
    jp = jpq.make_pqeq(par, dtype=jnp.float64, rctap=RCTAP)
    tp = tpq.pqeq_from_numpy({k: np.asarray(v) for k, v in
                              jp._asdict().items()})
    ts = tsys.from_cellfile(CELL, tf.name_to_type)
    n = ts.n
    nimg = tnb.nimg_for_cutoff(ts.H.numpy(), RCTAP + SKIN)
    timg = tnb.make_image_table(n, nimg)
    kb, knb, _ = tmd.probe_capacities(tf, ts, tffd, RCTAP, skin=SKIN)
    rc2b, rctap2 = tmd._skinned_cutoffs(tffd, RCTAP, SKIN)
    tn = tmd._build(ts, timg, None, rc2b, rctap2, kb, knb)
    rng = np.random.default_rng(1)
    q = rng.normal(scale=0.05, size=n)
    q -= q.mean()
    spos = rng.normal(scale=0.01, size=(n, 3))
    t = dict(pos=ts.pos, spos=torch.tensor(spos), q=torch.tensor(q), H=ts.H,
             types=ts.types, img=timg, nbrs=tn, ffd=tffd, pq=tp,
             amask=torch.ones(n, dtype=torch.bool))
    j = dict(pos=t2j(ts.pos), spos=jnp.asarray(spos), q=jnp.asarray(q),
             H=t2j(ts.H), types=t2j(ts.types),
             img=jnb.make_image_table(n, nimg, jnp.float64),
             nbrs=jnb.Neighbors(*(t2j(x) for x in tn)), ffd=jffd, pq=jp,
             amask=jnp.ones(n, bool))
    k = int(jpq.solve(*[j[a] for a in ARGS], isqeq=1, nmax=500, tol=TOL)[2])
    return dict(t=t, j=j, k=k)


def _solve_jax(deck, nmax):
    return jpq.solve(*[deck["j"][a] for a in ARGS], isqeq=1, nmax=nmax,
                     tol=TOL)


def _solve_port(deck, nmax, chunk, monkeypatch):
    """The port's solve with CG_CHUNK = chunk, and its chunks and host
    reads of the finished flag, counted."""
    monkeypatch.setattr(tqeq, "CG_CHUNK", chunk)
    box = dict(chunks=0, reads=0)

    def loop(run_chunk, carry, nchunks):
        carry = run_chunk(carry)
        box["chunks"] += 1
        for _ in range(nchunks - 1):
            box["reads"] += 1
            if bool(carry.fin):
                break
            carry = run_chunk(carry)
            box["chunks"] += 1
        return carry
    out = tpq.solve(*[deck["t"][a] for a in ARGS], isqeq=1, nmax=nmax,
                    tol=TOL, loop=loop)
    return out, box


def _case(k, where):
    """(nmax, chunk) placing the stop test that ends the loop (body call
    k + 1, or the NMAXQEq-th update) inside a chunk, on a chunk
    boundary, or at NMAXQEq before the stop fires."""
    calls = k + 1
    if where == "inside":
        return 500, [c for c in range(3, calls) if calls % c][0]
    if where == "boundary":
        return 500, [c for c in range(2, calls) if calls % c == 0][-1]
    return k - 2, 2


def test_stop_clear_of_the_tolerance(deck):
    """The deck's stop fires well clear of TOL, so both packages' rounding
    stops them at one iteration."""
    k = deck["k"]
    assert k == 7
    ests = [float(_solve_jax(deck, m)[3]) for m in (k - 1, k, k + 1)]
    before = abs(ests[1] / ests[0] - 1.0)
    at = abs(ests[2] / ests[1] - 1.0)
    assert before > 2 * TOL and at < TOL / 2, (before, at)


@pytest.mark.parametrize("where", ["inside", "boundary", "nmax"])
def test_chunked_cg_against_the_while_loop(deck, where, monkeypatch):
    k = deck["k"]
    nmax, chunk = _case(k, where)
    jq, js, jit, je = _solve_jax(deck, nmax)
    (tq, ts_, tit, te), box = _solve_port(deck, nmax, chunk, monkeypatch)
    assert int(tit) == int(jit) == min(k, nmax)
    assert float(np.abs(tq.numpy() - np.asarray(jq)).max()) <= 1e-12
    assert float(np.abs(ts_.numpy() - np.asarray(js)).max()) <= 1e-12
    assert abs(float(te) - float(je)) <= 1e-12 * abs(float(je))
    calls = min(k + 1, nmax)
    assert box["chunks"] == math.ceil(calls / chunk) >= 2
    assert (calls % chunk == 0) == (where == "boundary")
    # one read a chunk but the last (none after the last chunk of the cap)
    last = box["chunks"] == math.ceil(nmax / chunk)
    assert box["reads"] == box["chunks"] - last


def test_extended_lagrangian_reads_nothing(deck, monkeypatch):
    """isQEq=2's one iteration is one chunk: no host read."""
    kw = dict(isqeq=2, nmax=500, tol=TOL, lex_fqs=0.7)
    jq, js, jit, je = jpq.solve(*[deck["j"][a] for a in ARGS], **kw)

    def loop(run_chunk, carry, nchunks):
        assert nchunks == 1
        return run_chunk(carry)
    tq, ts_, tit, te = tpq.solve(*[deck["t"][a] for a in ARGS], loop=loop,
                                 **kw)
    assert int(tit) == int(jit) == 1
    assert float(np.abs(tq.numpy() - np.asarray(jq)).max()) <= 1e-12
    assert float(np.abs(ts_.numpy() - np.asarray(js)).max()) <= 1e-12
