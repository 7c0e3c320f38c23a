"""rxmd_tpu_torch neighbor lists against rxmd_tpu on the in-repo decks.

168 atoms (x1) take the brute-force build, 1,344 (x2) the cell-list build.
Parity is exact: each row's neighbor set (sorted ext indices) is equal.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rxmd_tpu import ffield as jff, system as jsys, neighbors as jnb, \
    reax as jrx
from rxmd_tpu_torch import neighbors as tnb, system as tsys

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4
RC = 10.0 + SKIN


@pytest.fixture(scope="module", params=[1, 2], ids=["x1-brute", "x2-cells"])
def lists(request):
    mc = (request.param,) * 3
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type, mc=mc)
    ffd = jrx.ffdev_from(ff, dtype=jnp.float64)
    H = np.asarray(st.H)
    nimg = jnb.nimg_for_cutoff(H, RC)
    rc2b = np.asarray(ffd.rc2b)
    rc2b = (np.sqrt(rc2b) + SKIN) ** 2 * (rc2b > 0)
    kb, knb = 24, 1024
    jimg = jnb.make_image_table(st.n, nimg, jnp.float64)
    timg = tnb.make_image_table(st.n, nimg, torch.float64)
    ts = tsys.state_from_numpy({k: np.asarray(v) for k, v in vars(st).items()})
    if st.n >= 400:
        L = np.diag(H)
        maxrc = jff.effective_maxrc(ff, np.asarray(st.types))
        grid = jnb.make_cell_grid(-np.asarray(nimg) * L,
                                  (1.0 + np.asarray(nimg)) * L,
                                  max(maxrc + SKIN, 2.0), RC)
        pose = jnb.ext_positions(st.pos, st.H, jimg)
        jn, jov = jnb.build_neighbors_cells(
            pose, jnp.ones(pose.shape[0], bool), st.types[jimg.owner], grid,
            jnp.asarray(rc2b), RC * RC, kb, knb, nrows=st.n)
        tpose = tnb.ext_positions(ts.pos, ts.H, timg)
        tn, tov = tnb.build_neighbors_cells(
            tpose, torch.ones(tpose.shape[0], dtype=torch.bool),
            ts.types[timg.owner], tnb.CellGrid(*grid), torch.tensor(rc2b),
            RC * RC, kb, knb, nrows=st.n)
        assert int(jov) == int(tov)
    else:
        jn = jnb.build_neighbors_brute(st.pos, st.H, st.types, jimg,
                                       jnp.asarray(rc2b), RC * RC, kb, knb)
        tn = tnb.build_neighbors_brute(ts.pos, ts.H, ts.types, timg,
                                       torch.tensor(rc2b), RC * RC, kb, knb)
    return jimg, timg, jn, tn


def test_image_table(lists):
    jimg, timg, _, _ = lists
    assert np.array_equal(np.asarray(jimg.owner), timg.owner.numpy())
    assert np.array_equal(np.asarray(jimg.shift), timg.shift.numpy())
    assert timg.n_own == jimg.n_own and timg.n_images == jimg.n_images


@pytest.mark.parametrize("kind", ["b", "nb"])
def test_neighbor_sets_match(lists, kind):
    _, _, jn, tn = lists
    jidx = np.sort(np.asarray(getattr(jn, "idx" + kind)), axis=1)
    tidx = np.sort(getattr(tn, "idx" + kind).numpy(), axis=1)
    assert np.array_equal(jidx, tidx)
    assert np.array_equal(np.asarray(getattr(jn, "cnt" + kind)),
                          getattr(tn, "cnt" + kind).numpy())
    # the lists are not truncated: every neighbor fits the capacity
    assert int(getattr(tn, "cnt" + kind).max()) <= tidx.shape[1]
    assert (tidx >= 0).sum() == int(getattr(tn, "cnt" + kind).sum())


def test_check_overflow(lists):
    _, _, _, tn = lists
    mb, mnb = tnb.check_overflow(tn)
    assert mb == int(tn.cntb.max()) and mnb == int(tn.cntnb.max())
    small = tn._replace(idxnb=tn.idxnb[:, :mnb - 1])
    with pytest.raises(RuntimeError, match="nonbonded neighbor overflow"):
        tnb.check_overflow(small)
