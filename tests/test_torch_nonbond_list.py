"""The closed-form nonbond over the pair list (ops/nonbond_list.py): on
the CPU its plain version against `reax.nonbond_cf_energy_forces` over the
pair context `reax.nb_ctx` builds, in float64, and the dispatch of
`reax.nonbond_ctx_energy_forces` (the kernel for the closed form without
LG on a card, the PyTorch path for the tables, LG and CPU tensors).

Decks: the 168-atom cell ("cell", 27 images of a 10.7 A box) and its
(2, 1, 1) replica ("x2"), each with every center live; and the cell in
the sharded engine's layout ("rows"): the ext atoms as atoms of their own
(the identity image, as `parallel.engine.identity_image` makes it, global
ids shared by an atom's images), the 168 residents the center rows, some
of them dead, the ghosts' charges gathered per slot (`ctx.qj`).  "rows" is
held against the cell with the same dead centers, row by row.

Bars: energies within 1e-12 relative, forces and virial within 1e-12 of
their largest magnitude: the same float64 expressions over the same pairs.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from rxmd_tpu_torch import ffield as tff, md as tmd, neighbors as tnb, \
    reax as trx, system as tsys
from rxmd_tpu_torch.ops import nonbond_list as nbl

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4
RCTAP = 10.0
DEAD = [3, 40, 77, 119, 150]
BAR = 1e-12


def close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-300)
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= tol * scale, (what, err, scale)


def _cell(mc=(1, 1, 1), dead=()):
    tf = tff.parse_ffield(FF)
    frac, types, cell = tsys.read_geninit_xyz(CELL, tf.name_to_type)
    frac, types, cell = tsys.replicate(frac, types, cell, mc)
    H = tsys.box_matrix(*cell)
    st = tsys.make_state(frac @ H.T, types, H)
    ffd = trx.ffdev_from(tf)
    img = tnb.make_image_table(st.n, tnb.nimg_for_cutoff(H, RCTAP + SKIN))
    kb, knb, _ = tmd.probe_capacities(tf, st, ffd, RCTAP, skin=SKIN)
    rc2b, rctap2 = tmd._skinned_cutoffs(ffd, RCTAP, SKIN)
    nbrs = tmd._build(st, img, tmd._cell_grid(tf, st, img, SKIN, RCTAP),
                      rc2b, rctap2, kb, knb)
    amask = torch.ones(st.n, dtype=torch.bool)
    amask[list(dead)] = False
    q = torch.as_tensor(np.random.default_rng(7).normal(scale=0.2,
                                                        size=st.n))
    q = q - q.mean()
    inp = nbl.NonbondInputs(st.pos, st.H, st.types, st.gid, amask, img,
                            nbrs, ffd)
    return dict(inp=inp, q=q, qj=None)


def _rows():
    """The cell with DEAD centers as one domain of the sharded engine: its
    ext atoms are the rows, the residents first."""
    d = _cell(dead=DEAD)
    inp, q = d["inp"], d["q"]
    img = inp.img
    own = img.owner
    M = own.shape[0]
    pos = tnb.ext_positions(inp.pos, inp.H, img)
    ident = tnb.ImageTable(owner=torch.arange(M),
                           shift=torch.zeros((M, 3), dtype=pos.dtype),
                           nimg=(0, 0, 0))
    amask = torch.zeros(M, dtype=torch.bool)
    amask[:inp.pos.shape[0]] = inp.amask
    rows = nbl.NonbondInputs(pos, inp.H, inp.types[own], inp.gid[own], amask,
                             ident, inp.nbrs, inp.ffd)
    qj = q[own][inp.nbrs.idxnb.clamp(min=0)]
    return dict(inp=rows, q=q, qj=qj, cell=d)


@pytest.fixture(scope="module", params=["cell", "x2", "rows"])
def deck(request):
    return {"cell": _cell, "x2": lambda: _cell((2, 1, 1)),
            "rows": _rows}[request.param]()


def _reax(d, with_virial):
    """reax.nonbond_cf_energy_forces over reax.nb_ctx's context, as the
    pair list's engines call it (the sharded engine's ctx.qj per slot)."""
    inp, q, qj = d["inp"], d["q"], d["qj"]
    n = inp.nbrs.center_rows
    ctx = trx.nb_ctx(inp.pos, None if qj is not None else q, inp.H,
                     inp.types, inp.img, inp.nbrs, inp.gid, inp.amask,
                     inp.ffd)
    if qj is not None:
        ctx = ctx._replace(qj=qj)
    return trx.nonbond_cf_energy_forces(ctx, q[:n], inp.types[:n],
                                        inp.amask[:n], inp.ffd,
                                        with_virial=with_virial,
                                        img=inp.img)


def _same(got, ref, with_virial):
    evdw, eclmb, f, w = got
    for a, b, what in ((evdw, ref[0], "evdw"), (eclmb, ref[1], "eclmb")):
        assert abs(float(b)) > 0, what
        assert abs(float(a - b)) <= BAR * abs(float(b)), what
    assert float(ref[3].abs().max()) > 0
    close(f, ref[3], BAR, "forces")
    if with_virial:
        close(w, ref[4], BAR, "virial")
    else:
        assert w is None


@pytest.mark.parametrize("with_virial", [False, True])
def test_plain_matches_pair_context(deck, with_virial):
    """The plain version against the pair context's closed form: the
    energies, row forces and virial."""
    got = nbl.nonbond_list_plain(deck["inp"], deck["q"], deck["qj"],
                                 with_virial)
    _same(got, _reax(deck, with_virial), with_virial)


def test_sharded_layout_matches_images():
    """The sharded layout (identity image, ghosts as atoms, per-slot
    charges) gives the image table's result with the same dead centers."""
    d = _rows()
    got = nbl.nonbond_list_plain(d["inp"], d["q"], d["qj"], True)
    ref = nbl.nonbond_list_plain(d["cell"]["inp"], d["q"], None, True)
    _same(got, (ref[0], ref[1], None, ref[2], ref[3]), True)
    dead = torch.tensor(DEAD)
    assert float(got[2][dead].abs().max()) == 0.0


@pytest.mark.parametrize("with_virial", [False, True])
def test_wrapper_takes_plain_on_cpu(deck, with_virial):
    """`nonbond_list` on CPU tensors is the plain version and launches
    nothing; LG dispersion it refuses."""
    n0 = dict(nbl.launches)
    got = nbl.nonbond_list(deck["inp"], deck["q"], deck["qj"], with_virial)
    ref = nbl.nonbond_list_plain(deck["inp"], deck["q"], deck["qj"],
                                 with_virial)
    assert nbl.launches == n0
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    lg = deck["inp"]._replace(ffd=dataclasses.replace(deck["inp"].ffd,
                                                      is_lg=True))
    with pytest.raises(ValueError, match="LG"):
        nbl.nonbond_list(lg, deck["q"], deck["qj"], with_virial)


def _raise(*a, **k):
    raise AssertionError("called")


@pytest.mark.parametrize("form", ["closed", "tables", "lg"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_dispatch(form, card, monkeypatch):
    """reax.nonbond_ctx_energy_forces: the kernel's wrapper for the closed
    form without LG on a card (`native.device_kind` made to answer "cuda"
    and the wrapper stood in for), which never reaches reax.cf_nonbond;
    the PyTorch path for the tables, LG and CPU tensors."""
    d = _cell()
    inp, q = d["inp"], d["q"]
    ffd = inp.ffd if form != "lg" else dataclasses.replace(inp.ffd,
                                                          is_lg=True)
    inp = inp._replace(ffd=ffd)
    ctx = trx.nb_ctx(inp.pos, None, inp.H, inp.types, inp.img, inp.nbrs,
                     inp.gid, inp.amask, ffd)
    args = (ctx, q, inp.types, inp.amask, ffd, form != "tables")
    kernel = card and form == "closed"
    want = (nbl.nonbond_list_plain(inp, q, None, True) if kernel else
            trx.nonbond_ctx_energy_forces(*args, with_virial=True,
                                          img=inp.img))
    calls = []

    def wrapper(src, q_, qj, with_virial):
        calls.append(src)
        return want
    monkeypatch.setattr(nbl, "nonbond_list", wrapper)
    if card:
        monkeypatch.setattr(trx.native, "device_kind", lambda t, w: "cuda")
    cf_nonbond = trx.cf_nonbond
    cf_calls = []

    def cf(*a, **k):
        cf_calls.append(1)
        return cf_nonbond(*a, **k)
    monkeypatch.setattr(trx, "cf_nonbond", _raise if kernel else cf)
    got = trx.nonbond_ctx_energy_forces(*args, with_virial=True, img=inp.img)
    assert len(calls) == kernel and len(cf_calls) == (form != "tables"
                                                      and not kernel)
    if kernel:
        assert calls[0] is ctx.src
        echarge = trx.charge_energy(q, inp.types, inp.amask, ffd)
        want = (want[0], want[1], echarge, want[2], want[3])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
