"""The hydrogen-bond term in one pass over the donors' rows
(`reax.e_hbond_rows`, ops/hbond.py: on the CPU the plain version of the
kernel, analytic gradients through `HBondEnergy`) against autograd of the
(donor, H slot, acceptor slot) grid of `reax.e_hbond`, in float64.

Decks: the 168-atom cell ("cell"), the same fractional coordinates under
the lattice angles (95, 100, 105) degrees ("tric"), the cell's (2, 1, 1)
replica ("x2"), and the cell with the donors cut to its first 120 rows and
some of them dead ("rows": the sharded engine's layout, center_rows < rows,
whose other rows carry bonded lists alone).

Bars: the energy within 1e-12 relative; the position gradient (through
the bond order), dE/dBO0, dE/dH and energy_and_forces' forces and virial
within 1e-10 of their largest magnitude.  The same float64 expressions,
summed in another order, part by ~1e-16.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu_torch import ffield as tff, md as tmd, neighbors as tnb, \
    reax as trx, system as tsys
from rxmd_tpu_torch.ops import hbond as hb

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4
RCTAP = 10.0
DECKS = ["cell", "tric", "x2", "rows"]


def close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= tol * scale, (what, err, scale)


def _make_deck(kind):
    tf = tff.parse_ffield(FF)
    frac, types, cell = tsys.read_geninit_xyz(CELL, tf.name_to_type)
    if kind == "tric":
        cell = cell[:3] + (95.0, 100.0, 105.0)
    frac, types, cell = tsys.replicate(frac, types, cell,
                                       (2, 1, 1) if kind == "x2" else (1,) * 3)
    H = tsys.box_matrix(*cell)
    st = tsys.make_state(frac @ H.T, types, H)
    n = st.n
    ffd = trx.ffdev_from(tf)
    img = tnb.make_image_table(n, tnb.nimg_for_cutoff(H, RCTAP + SKIN))
    kb, knb, caps = tmd.probe_capacities(tf, st, ffd, RCTAP, skin=SKIN,
                                         term_slack=1.0)
    rc2b, rctap2 = tmd._skinned_cutoffs(ffd, RCTAP, SKIN)
    nbrs = tmd._build(st, img, tmd._cell_grid(tf, st, img, SKIN, RCTAP),
                      rc2b, rctap2, kb, knb)
    amask = torch.ones(n, dtype=torch.bool)
    if kind == "rows":
        nbrs = nbrs._replace(idxnb=nbrs.idxnb[:120], cntnb=nbrs.cntnb[:120])
        amask[[3, 40, 77, 119, 150]] = False
    return dict(st=st, ffd=ffd, img=img, nbrs=nbrs, amask=amask, caps=caps)


@pytest.fixture(scope="module", params=DECKS)
def deck(request):
    return _make_deck(request.param)


def _grid(pos, H, types, img, nbrs, bo, amask, ffd, kh=6, counts=None):
    """e_hbond's grid mode over its own pair context, in e_hbond_rows'
    place."""
    ctx = trx.nb_ctx(pos, None, H, types, img, nbrs, torch.zeros_like(types),
                     amask, ffd)
    return trx.e_hbond(pos, H, types, img, nbrs, bo, amask, ffd, kh=kh,
                       ctx=ctx, counts=counts)


def _energy(d, fn, with_bo=False):
    """(E, dE/dpos, dE/dH, dE/dBO0): pos and H through the bond order, or,
    `with_bo`, the bond orders as a leaf of their own."""
    st = d["st"]
    p = st.pos.clone().requires_grad_(True)
    H = st.H.clone().requires_grad_(True)
    bo = trx.bond_order(p, H, st.types, d["img"], d["nbrs"], d["ffd"])
    leaf = bo.bo.detach().requires_grad_(True)
    if with_bo:
        bo = bo._replace(bo=leaf)
    e = fn(p, H, st.types, d["img"], d["nbrs"], bo, d["amask"], d["ffd"],
           kh=d["caps"]["kh"])
    g = torch.autograd.grad(e, (p, H, leaf) if with_bo else (p, H),
                            allow_unused=True)
    return e.detach(), *g


def test_plain_matches_grid(deck):
    """Energy, dE/dpos and dE/dH through the bond order, and dE/dBO0 with
    the bond orders held: the rows pass against the grid's autograd."""
    e0, gp0, gh0 = _energy(deck, _grid)
    e1, gp1, gh1 = _energy(deck, trx.e_hbond_rows)
    assert abs(float(e0)) > 0
    assert abs(float(e1 - e0)) <= 1e-12 * abs(float(e0))
    close(gp0, gp1, 1e-10, "dE/dpos")
    close(gh0, gh1, 1e-10, "dE/dH")
    _, gp0, _, gb0 = _energy(deck, _grid, with_bo=True)
    _, gp1, _, gb1 = _energy(deck, trx.e_hbond_rows, with_bo=True)
    assert float(gb0.abs().max()) > 0
    close(gb0, gb1, 1e-10, "dE/dBO")
    close(gp0, gp1, 1e-10, "dE/dpos, BO held")


def test_energy_and_forces_virial(deck, monkeypatch):
    """energy_and_forces with uncached terms and the virial (a nonbond of
    zeros spliced in): the same components, forces and virial as with the
    grid in the rows' place."""
    st = deck["st"]
    q = torch.as_tensor(np.random.default_rng(5).normal(scale=0.2,
                                                        size=st.n))
    args = (st.pos, q, st.H, st.types, st.gid, deck["img"], deck["nbrs"],
            deck["ffd"])
    z = torch.zeros((), dtype=st.pos.dtype)
    kw = dict(amask=deck["amask"], with_virial=True, caps=deck["caps"],
              external_nonbond=(z, z, z, torch.zeros_like(st.pos),
                                torch.zeros((3, 3), dtype=st.pos.dtype)))
    c1, f1, w1 = trx.energy_and_forces(*args, **kw)
    monkeypatch.setattr(trx, "e_hbond_rows", _grid)
    c0, f0, w0 = trx.energy_and_forces(*args, **kw)
    assert abs(float(c0[10])) > 0
    close(c0, c1, 1e-10, "components")
    close(f0, f1, 1e-10, "forces")
    close(w0, w1, 1e-10, "virial")


def test_rows_build_no_pair_context(deck, monkeypatch):
    """Uncached terms build no pair context for the hydrogen bonds, and on
    the CPU the wrapper takes the plain version (no launch)."""
    st = deck["st"]

    def refuse(*a, **k):
        raise AssertionError("a pair context for the hydrogen bonds")
    monkeypatch.setattr(trx, "nb_ctx", refuse)
    n0 = dict(hb.launches)
    comps = trx.energy_components(
        st.pos, torch.zeros(st.n, dtype=st.pos.dtype), st.H, st.types,
        st.gid, deck["img"], deck["nbrs"], deck["ffd"], amask=deck["amask"],
        caps=deck["caps"], include_nonbond=False)
    assert abs(float(comps[10])) > 0
    assert hb.launches == n0


def _tables(d):
    st, nbrs, img, ffd = d["st"], d["nbrs"], d["img"], d["ffd"]
    bo = trx.bond_order(st.pos, st.H, st.types, img, nbrs, ffd)
    tab, _ = trx.hbond_tables(st.pos, st.types, img, nbrs, bo, d["amask"],
                              ffd, d["caps"]["kh"])
    return tab, bo.bo[:nbrs.center_rows, :, 0].contiguous()


@pytest.mark.parametrize("want_dh", [False, True])
def test_wrapper_takes_plain_on_cpu(deck, want_dh):
    """`hbond` on CPU tensors is `hbond_plain`, launches nothing, and
    leaves dE/dH out unless asked."""
    st = deck["st"]
    tab, bo0 = _tables(deck)
    n0 = dict(hb.launches)
    got = hb.hbond(st.pos, st.H, bo0, tab, want_dh=want_dh)
    ref = hb.hbond_plain(st.pos, st.H, bo0, tab, want_dh=want_dh)
    assert hb.launches == n0
    assert (got[3] is None) == (not want_dh)
    for a, b in zip(got, ref):
        if b is not None:
            assert torch.equal(a, b)


def test_kh_overflow_raises_or_counts():
    """A donor with more hydrogens than kh raises naming the cap; with
    `counts` the largest count is left there instead."""
    d = _make_deck("cell")
    with pytest.raises(RuntimeError, match="hbond overflow"):
        _energy(d, lambda *a, kh: trx.e_hbond_rows(*a, kh=1))
    counts = {}
    _energy(d, lambda *a, kh: trx.e_hbond_rows(*a, kh=1, counts=counts))
    assert int(counts["kh"]) >= 2
