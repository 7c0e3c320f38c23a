"""The cell-list build in row passes (`neighbors.LIST_ROWS`) against the
build in one pass and against the brute-force build.

The CHON cell replicated (4, 4, 2) has 5,376 atoms: passes of 1,000 rows
cut it six times, and the lists must be the one-pass lists entry for
entry, and the brute-force masks (build_neighbors_brute's) set for set
at every pass boundary and every 50th row; a pass at or above the row
count is the one-pass build, bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu_torch import ffield, neighbors as nb, reax, system

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
SKIN = 0.4
RC = 10.0 + SKIN
KB, KNB = 24, 1024


@pytest.fixture(scope="module")
def deck():
    ff = ffield.parse_ffield(os.path.join(DATA, "ffield_chon_synth"))
    st = system.from_cellfile(os.path.join(DATA, "chon168.xyz"),
                              ff.name_to_type, mc=(4, 4, 2))
    ffd = reax.ffdev_from(ff)
    H = st.H.numpy()
    nimg = nb.nimg_for_cutoff(H, RC)
    img = nb.make_image_table(st.n, nimg, torch.float64)
    rc2b = torch.sqrt(ffd.rc2b)
    rc2b = (rc2b + SKIN) ** 2 * (ffd.rc2b > 0)
    L = np.diag(H)
    maxrc = ffield.effective_maxrc(ff, st.types.numpy())
    grid = nb.make_cell_grid(-np.asarray(nimg) * L,
                             (1.0 + np.asarray(nimg)) * L,
                             max(maxrc + SKIN, 2.0), RC)
    pose = nb.ext_positions(st.pos, st.H, img)
    valid = torch.ones(pose.shape[0], dtype=torch.bool)
    occ = int(nb._cell_table_packed(pose, valid, st.types[img.owner],
                                    grid)[3])
    grid = grid._replace(ccap=max(grid.ccap, occ))
    return st, img, grid, pose, valid, rc2b


def _cells(deck, rows, monkeypatch, **kw):
    st, img, grid, pose, valid, rc2b = deck
    monkeypatch.setattr(nb, "LIST_ROWS", rows)
    out, occ = nb.build_neighbors_cells(pose, valid, st.types[img.owner],
                                        grid, rc2b, RC * RC, KB, KNB,
                                        nrows=st.n, **kw)
    monkeypatch.undo()
    return out, occ


@pytest.fixture(scope="module")
def one_pass(deck):
    mp = pytest.MonkeyPatch()
    try:
        return _cells(deck, 1 << 30, mp)
    finally:
        mp.undo()


def test_passes_hold_the_one_pass_and_brute_lists(deck, one_pass,
                                                  monkeypatch):
    st, img, _, _, _, rc2b = deck
    assert st.n == 5376 and nb.passes(st.n) == 1
    got, occ = _cells(deck, 1000, monkeypatch)
    ref, occ1 = one_pass
    assert int(occ) == int(occ1)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the brute-force build's rows (`build_neighbors_brute`'s masks) at
    # every pass boundary and every 50th row: all rows take minutes
    rows = sorted({r for k in range(1000, st.n, 1000) for r in (k - 1, k)}
                  | set(range(0, st.n, 50)) | {st.n - 1})
    pose = nb.ext_positions(st.pos, st.H, img)
    d = st.pos[rows][:, None, :] - pose[None, :, :]
    dr2 = torch.sum(d * d, dim=-1)
    other = torch.tensor(rows)[:, None] != torch.arange(pose.shape[0])
    tj = st.types[img.owner]
    masks = dict(b=(dr2 < rc2b[st.types[rows]][:, tj]) & other,
                 nb=(dr2 <= RC * RC) & other)
    for kind, mask in masks.items():
        cnt = getattr(got, "cnt" + kind)[rows]
        idx = getattr(got, "idx" + kind)[rows]
        assert torch.equal(cnt, mask.sum(dim=1))
        for k in range(len(rows)):
            assert torch.equal(idx[k][idx[k] >= 0].sort()[0],
                               torch.nonzero(mask[k])[:, 0])
    assert int(got.cntnb.max()) < KNB and int(got.cntnb.min()) > 0


@pytest.mark.parametrize("rows", [5376, 5377, 8192])
def test_a_pass_over_every_row_is_the_one_pass_build(deck, one_pass, rows,
                                                     monkeypatch):
    got, _ = _cells(deck, rows, monkeypatch)
    for a, b in zip(got, one_pass[0]):
        assert torch.equal(a, b)


def test_bond_rows_in_passes(deck, monkeypatch):
    """The sharded engine's form: bonded rows for a -1-padded selection,
    nonbonded rows for the first `nb_rows`."""
    st = deck[0]
    sel = torch.arange(0, st.n, 3)
    bond_rows = torch.cat([sel, torch.full((50,), -1)])
    kw = dict(nb_rows=st.n - 7, bond_rows=bond_rows)
    ref, _ = _cells(deck, 1 << 30, monkeypatch, **kw)
    got, _ = _cells(deck, 700, monkeypatch, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert ref.idxnb.shape[0] == st.n - 7
    assert int(ref.cntb[1]) == 0 and int(ref.cntb[3]) > 0


def test_passes_count():
    assert [nb.passes(r) for r in (0, 1, 8192, 8193, 64512)] == \
        [1, 1, 1, 2, 8]
