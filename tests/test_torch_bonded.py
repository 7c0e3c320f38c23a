"""rxmd_tpu_torch bond order, cached term lists and bonded terms against
rxmd_tpu in float64, on both in-repo decks (168 and 1,344 atoms).

Bars: each energy term within 1e-10 relative, forces (autograd vs
jax.grad) within 1e-9 of max|f|, strain virial within 1e-9 of max|W| —
the same f64 expressions summed in another order differ by ~1e-14.  The
angle, torsion and hbond lists are built by the same integer algorithm
and must be identical.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rxmd_tpu import ffield as jff, system as jsys, neighbors as jnb, \
    reax as jrx
from rxmd_tpu_torch import md as tmd, neighbors as tnb, reax as trx, \
    system as tsys, ffield as tff

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4
SLACK = dict(slack=0.1, margin=0.0)


@pytest.fixture(scope="module", params=[1, 2], ids=["x1", "x2"])
def deck(request):
    mc = (request.param,) * 3
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type, mc=mc)
    jffd = jrx.ffdev_from(ff, dtype=jnp.float64)
    tffd = trx.ffdev_from_numpy({k: np.asarray(v)
                                 for k, v in jffd._asdict().items()})
    ts = tsys.state_from_numpy({k: np.asarray(v) for k, v in vars(st).items()})
    nimg = jnb.nimg_for_cutoff(np.asarray(st.H), 10.0 + SKIN)
    jimg = jnb.make_image_table(st.n, nimg, jnp.float64)
    timg = tnb.make_image_table(st.n, nimg, torch.float64)
    # the port's capacity probe sizes both packages' lists
    kb, knb, caps = tmd.probe_capacities(tff.parse_ffield(FF), ts, tffd,
                                         10.0, skin=SKIN, term_slack=0.1)
    grid = tmd._cell_grid(ff, ts, timg, SKIN, 10.0)
    rc2b, rctap2 = tmd._skinned_cutoffs(tffd, 10.0, SKIN)
    tn = tmd._build(ts, timg, grid, rc2b, rctap2, kb, knb)
    # identical sets, so hand the port's lists to both packages
    jn = jnb.Neighbors(*(jnp.asarray(x.numpy().astype(np.int32)) for x in tn))
    return dict(st=st, ts=ts, jffd=jffd, tffd=tffd, jimg=jimg, timg=timg,
                jn=jn, tn=tn, caps=caps)


@pytest.fixture(scope="module")
def built(deck):
    d = deck
    st, ts, caps = d["st"], d["ts"], d["caps"]
    jbo = jrx.bond_order(st.pos, st.H, st.types, d["jimg"], d["jn"], d["jffd"])
    tbo = trx.bond_order(ts.pos, ts.H, ts.types, d["timg"], d["tn"], d["tffd"])
    ja, ta = jnp.ones(st.n, bool), torch.ones(st.n, dtype=torch.bool)
    jl = (jrx.build_angle_list(st.types, d["jimg"], d["jn"], jbo, ja,
                               d["jffd"], cap=caps["ang"], ks=caps["ks"],
                               rowcap=caps["ang_row"], **SLACK),
          jrx.build_torsion_list(st.types, st.gid, d["jimg"], d["jn"], jbo,
                                 ja, d["jffd"], cap=caps["tor"],
                                 ks=caps["ks"], rowcap=caps["tor_row"],
                                 **SLACK),
          jrx.build_hbond_list(st.pos, st.H, st.types, d["jimg"], d["jn"],
                               jbo, ja, d["jffd"], cap=caps["hbf"],
                               kh=caps["kh"], rowcap=caps["hb_row"], **SLACK))
    tl = (trx.build_angle_list(ts.types, d["timg"], d["tn"], tbo, ta,
                               d["tffd"], cap=caps["ang"], ks=caps["ks"],
                               rowcap=caps["ang_row"], **SLACK),
          trx.build_torsion_list(ts.types, ts.gid, d["timg"], d["tn"], tbo,
                                 ta, d["tffd"], cap=caps["tor"],
                                 ks=caps["ks"], rowcap=caps["tor_row"],
                                 **SLACK),
          trx.build_hbond_list(ts.pos, ts.H, ts.types, d["timg"], d["tn"],
                               tbo, ta, d["tffd"], cap=caps["hbf"],
                               kh=caps["kh"], rowcap=caps["hb_row"], **SLACK))
    return jbo, tbo, jl, tl


def test_bond_order(deck, built):
    jbo, tbo, _, _ = built
    assert np.array_equal(np.asarray(jbo.mask), tbo.mask.numpy())
    for f in ("bo", "delta", "deltap1", "drb"):
        a, b = np.asarray(getattr(jbo, f)), getattr(tbo, f).numpy()
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(a).max(), 1.0), f


def test_strong_slots(deck, built):
    """Per-row strong-slot compaction, lowest slot first as lax.top_k."""
    jbo, tbo, _, _ = built
    ks = deck["caps"]["ks"]
    for x, y in zip(jrx.strong_slots(jbo, ks), trx.strong_slots(tbo, ks)):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_term_counts(deck):
    d = deck
    st, ts = d["st"], d["ts"]
    a = jrx.term_counts(st.pos, st.H, st.types, st.gid, d["jimg"], d["jn"],
                        d["jffd"], **SLACK)
    b = trx.term_counts(ts.pos, ts.H, ts.types, ts.gid, d["timg"], d["tn"],
                        d["tffd"], **SLACK)
    assert a == b
    assert a["ang"] > 0 and a["tor"] > 0 and a["hbf"] > 0


@pytest.mark.parametrize("k", [0, 1, 2], ids=["angle", "torsion", "hbond"])
def test_lists_identical(built, k):
    _, _, jl, tl = built
    a, b = jl[k], tl[k]
    assert 0 < int(a.cnt) <= a.valid.shape[0]
    assert int(a.cnt) == int(b.cnt)
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert np.array_equal(x, y), f


def test_energy_forces_virial(deck, built):
    d = deck
    st, ts = d["st"], d["ts"]
    jbo, tbo, jl, tl = built
    zero = (0.0, 0.0, 0.0, jnp.zeros((st.n, 3)), jnp.zeros((3, 3)))
    cj, fj, wj = jrx.energy_and_forces(
        st.pos, st.q, st.H, st.types, st.gid, d["jimg"], d["jn"], d["jffd"],
        lists=jl, with_virial=True, external_nonbond=zero)
    z = torch.zeros((), dtype=torch.float64)
    ct, ft, wt = trx.energy_and_forces(
        ts.pos, ts.q, ts.H, ts.types, ts.gid, d["timg"], d["tn"], d["tffd"],
        tl, with_virial=True,
        external_nonbond=(z, z, z, torch.zeros((st.n, 3),
                                               dtype=torch.float64),
                          torch.zeros((3, 3), dtype=torch.float64)))
    cj, fj, wj = np.asarray(cj), np.asarray(fj), np.asarray(wj)
    ct, ft, wt = ct.numpy(), ft.numpy(), wt.numpy()
    for k in range(11):
        assert abs(cj[k] - ct[k]) <= 1e-10 * max(abs(cj[k]), 1e-3), k
    assert np.abs(fj - ft).max() <= 1e-9 * np.abs(fj).max()
    assert np.abs(wj - wt).max() <= 1e-9 * np.abs(wj).max()
    # the terms are live on this deck
    assert all(abs(cj[k]) > 0 for k in (1, 2, 3, 4, 5, 7, 8, 9, 10))


def test_rowcap_required(deck, built):
    d = deck
    ts = d["ts"]
    _, tbo, _, _ = built
    ta = torch.ones(ts.n, dtype=torch.bool)
    with pytest.raises(ValueError, match="rowcap"):
        trx.build_torsion_list(ts.types, ts.gid, d["timg"], d["tn"], tbo, ta,
                               d["tffd"], cap=64, ks=d["caps"]["ks"],
                               rowcap=0, **SLACK)
    with pytest.raises(ValueError, match="rowcap"):
        trx.build_hbond_list(ts.pos, ts.H, ts.types, d["timg"], d["tn"], tbo,
                             ta, d["tffd"], cap=64, kh=d["caps"]["kh"],
                             rowcap=0, **SLACK)


def test_row_overflow_sentinel(deck, built):
    """A row over its rowcap reports ROW_OVERFLOW, not a silent pack."""
    d = deck
    ts = d["ts"]
    _, tbo, _, tl = built
    ta = torch.ones(ts.n, dtype=torch.bool)
    small = trx.build_angle_list(ts.types, d["timg"], d["tn"], tbo, ta,
                                 d["tffd"], cap=d["caps"]["ang"],
                                 ks=d["caps"]["ks"], rowcap=2, **SLACK)
    assert int(small.cnt) == trx.ROW_OVERFLOW
    assert int(tl[0].cnt) < trx.ROW_OVERFLOW
