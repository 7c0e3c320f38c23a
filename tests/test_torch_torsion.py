"""The torsion and 4-body conjugation terms without a cached list
(`reax.e_4body` with `tl` None, ops/torsion.py: on the CPU the plain
version of the kernel, its gradients carried through `TorsionEnergy`)
against autograd of the flat torsion list that `reax.build_torsion_list`
builds from the (center, a, c, e) grid, in float64.

Decks: the 168-atom cell ("cell"), its (2, 2, 2) replica of 1,344 atoms
("x8"), and the cell with the centers cut to its first 120 rows and some
of them dead ("rows": the sharded engine's layout, center_rows < rows,
whose other rows carry bonded lists alone).

Bars: the energies within 1e-10 relative; the gradients with respect to
BO0, the pi bond order, the bond vectors and delta, and
energy_and_forces' components, forces and virial, within 1e-10 of their
largest magnitude.  The same float64 expressions, their gradients summed
in another order, part by ~1e-16.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu_torch import ffield as tff, md as tmd, neighbors as tnb, \
    reax as trx, system as tsys
from rxmd_tpu_torch.ops import torsion as tor

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4
RCTAP = 10.0
DECKS = ["cell", "x8", "rows"]


def close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= tol * scale, (what, err, scale)


def _make_deck(kind):
    tf = tff.parse_ffield(FF)
    frac, types, cell = tsys.read_geninit_xyz(CELL, tf.name_to_type)
    frac, types, cell = tsys.replicate(frac, types, cell,
                                       (2, 2, 2) if kind == "x8" else (1,) * 3)
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


def _leaves(d):
    """The bond order with its BO channels, delta and drb as leaves."""
    st = d["st"]
    bo = trx.bond_order(st.pos, st.H, st.types, d["img"], d["nbrs"],
                        d["ffd"])
    return bo._replace(bo=bo.bo.detach().requires_grad_(True),
                       delta=bo.delta.detach().requires_grad_(True),
                       drb=bo.drb.detach().requires_grad_(True))


def _grid(d, bo, capped, counts=None):
    """The flat list's (E_tors, E_conj), as e_4body computed them before
    the rows took its place: the list built from the grid, exact or of the
    engine's capacities, then the cached path's arithmetic."""
    st, caps = d["st"], d["caps"]
    kw = (dict(cap=caps["tor"], rowcap=caps["tor_row"], counts=counts)
          if capped else dict(cap=None))
    tl = trx.build_torsion_list(st.types, st.gid, d["img"], d["nbrs"], bo,
                                d["amask"], d["ffd"], ks=caps["ks"], **kw)
    if counts is not None:
        counts["tor"] = tl.cnt
    return trx.e_4body(st.pos, st.H, st.types, d["img"], d["nbrs"], bo,
                       d["amask"], st.gid, d["ffd"], tl)


def _rows(d, bo, capped, counts=None):
    st, caps = d["st"], d["caps"]
    kw = (dict(cap=caps["tor"], rowcap=caps["tor_row"], counts=counts)
          if capped else dict(cap=None))
    return trx.e_4body(st.pos, st.H, st.types, d["img"], d["nbrs"], bo,
                       d["amask"], st.gid, d["ffd"], ks=caps["ks"], **kw)


def _grads(e, bo):
    """dE/d(BO0, pi BO, drb, delta) of one energy."""
    g_bo, g_drb, g_delta = torch.autograd.grad(
        e, (bo.bo, bo.drb, bo.delta), retain_graph=True, allow_unused=True)
    g_bo = torch.zeros_like(bo.bo) if g_bo is None else g_bo
    g_delta = torch.zeros_like(bo.delta) if g_delta is None else g_delta
    return g_bo[..., 0], g_bo[..., 2], g_drb, g_delta


@pytest.mark.parametrize("capped", [False, True], ids=["exact", "capped"])
def test_plain_matches_grid(deck, capped):
    """Each energy and its four gradients: the rows against the grid's
    list and autograd, for the exact list and the engine's capped one."""
    bo = _leaves(deck)
    got = _rows(deck, bo, capped, {} if capped else None)
    ref = _grid(deck, bo, capped, {} if capped else None)
    for e1, e0, what in zip(got, ref, ("E_tors", "E_conj")):
        v1, v0 = float(e1.detach()), float(e0.detach())
        assert abs(v0) > 0, what
        assert abs(v1 - v0) <= 1e-10 * abs(v0), what
        for a, b, name in zip(_grads(e1, bo), _grads(e0, bo),
                              ("BO0", "pi BO", "drb", "delta")):
            if what == "E_tors" or name in ("BO0", "drb"):
                assert float(b.abs().max()) > 0, (what, name)
            close(b, a, 1e-10, f"d{what}/d{name}")


def test_counts_match_grid(deck):
    """counts["tor"] and counts["ks"] as the grid's list leaves them, and a
    center over a small `rowcap` reported as reax.ROW_OVERFLOW."""
    bo = _leaves(deck)
    got, ref = {}, {}
    _rows(deck, bo, True, got)
    _grid(deck, bo, True, ref)
    assert set(got) == {"ks", "tor"}
    for k in got:
        assert int(got[k]) == int(ref[k]) > 0, k
    small = dict(deck, caps=dict(deck["caps"], tor_row=2, tor=16))
    got, ref = {}, {}
    _rows(small, bo, True, got)
    _grid(small, bo, True, ref)
    assert int(got["tor"]) == int(ref["tor"]) == trx.ROW_OVERFLOW


def test_ks_overflow_raises_or_counts():
    """A center with more candidate bonds than ks raises at once on the
    exact path; with `counts` the largest count is left there instead."""
    d = _make_deck("cell")
    bo = _leaves(d)
    d = dict(d, caps=dict(d["caps"], ks=2))
    with pytest.raises(RuntimeError, match="many-body candidate overflow"):
        _rows(d, bo, False)
    counts = {}
    _rows(d, bo, True, counts)
    assert int(counts["ks"]) > 2


def test_wrapper_takes_plain_on_cpu(deck):
    """`torsion` on CPU tensors is `torsion_plain` and launches nothing."""
    st, caps = deck["st"], deck["caps"]
    bo = trx.bond_order(st.pos, st.H, st.types, deck["img"], deck["nbrs"],
                        deck["ffd"])
    tab = tor.TorsionTables(
        types=st.types, gid=st.gid, amask=deck["amask"], maskb=bo.mask,
        img=deck["img"], nbrs=deck["nbrs"], ffd=deck["ffd"], ks=caps["ks"],
        cap=caps["tor"], rowcap=caps["tor_row"])
    args = (bo.bo[..., 0].detach(), bo.bo[..., 2].detach(),
            bo.drb.detach(), bo.delta.detach(), tab)
    n0 = dict(tor.launches)
    got = tor.torsion(*args)
    ref = tor.torsion_plain(*args)
    assert tor.launches == n0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_virial", [False, True])
def test_energy_and_forces(deck, with_virial, monkeypatch):
    """energy_and_forces with uncached terms (a nonbond of zeros spliced
    in): the same components, forces and virial as with the grid's list
    in the rows' place."""
    st = deck["st"]
    q = torch.as_tensor(np.random.default_rng(5).normal(scale=0.2,
                                                        size=st.n))
    args = (st.pos, q, st.H, st.types, st.gid, deck["img"], deck["nbrs"],
            deck["ffd"])
    z = torch.zeros((), dtype=st.pos.dtype)
    kw = dict(amask=deck["amask"], with_virial=with_virial,
              caps=deck["caps"],
              external_nonbond=(z, z, z, torch.zeros_like(st.pos),
                                torch.zeros((3, 3), dtype=st.pos.dtype)))
    new = trx.energy_and_forces(*args, **kw)
    e_4body = trx.e_4body

    def grid(pos, H, types, img, nbrs, bo, amask, gid, ffd, tl, ks, cap,
             rowcap, counts):
        assert tl is None
        tl = trx.build_torsion_list(types, gid, img, nbrs, bo, amask, ffd,
                                    cap=cap, ks=ks, rowcap=rowcap)
        return e_4body(pos, H, types, img, nbrs, bo, amask, gid, ffd, tl)
    monkeypatch.setattr(trx, "e_4body", lambda *a, **k: grid(*a, **k))
    old = trx.energy_and_forces(*args, **kw)
    assert abs(float(old[0][8])) > 0 and abs(float(old[0][9])) > 0
    for a, b, what in zip(new, old, ("components", "forces", "virial")):
        close(b, a, 1e-10, what)
