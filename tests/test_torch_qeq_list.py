"""The QEq hessian list's layout (rxmd_tpu_torch/ops/pairsweep.py
`qeq_starts`, `QeqList`, `qeq_build_plain`, `qeq_apply_plain`), on the
168-atom cell and its (2, 2, 1) replica, on the CPU.

* Each target's offset (`Walk.qstart`, made with the slot map) is the sum
  of the walk candidates of the targets before it, counted here cell by
  cell from the slot map's cell counts; the last offset is
  `walk_candidates`, the capacity the layout asks (`QeqList.need`).
* Target i's records rec[start[i] : start[i] + count[i]] are, in order,
  the pairs of `walk_pairs_plain` for that target that pass the QEq gate,
  each (owner, or ~owner for an image; the bits of its hessian element),
  float32 records as int32 pairs and float64 as int64.
* The apply without q (the CG's gradient) gives the rows of the apply
  with q and an Est row of 0; against rxmd_tpu's Pallas `_sweep` with the
  QEq body in interpret mode at q = 0, float32, 3e-4 of max (the bar of
  tests/test_pairsweep.py).
* A capacity below `need` drops exactly the records at or past it.
* The build's blocks (`Walk.qblocks`) split the targets by column, at most
  BUILD_TARGETS a block, the largest first.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rxmd_tpu import ffield as jff, neighbors as jnb, reax as jrx, \
    system as jsys, units
from rxmd_tpu.ops import pairsweep as jps
from rxmd_tpu_torch import ffield as tff, neighbors as tnb, reax as trx, \
    system as tsys
from rxmd_tpu_torch.ops import pairsweep as tps

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4


def _setup(mc, dtype):
    """The port's slot layout of the deck replicated `mc` in `dtype`, the
    QEq planes, the slots' owners and the QEq pair function."""
    tf = tff.parse_ffield(FF)
    st = tsys.from_cellfile(CELL, tf.name_to_type, mc=mc, dtype=dtype)
    H = st.H.numpy()
    img = tnb.make_image_table(st.n, tnb.nimg_for_cutoff(H, 10.0 + SKIN),
                               dtype, "cpu")
    pose = tnb.ext_positions(st.pos, st.H, img)
    grid = tps.make_pair_grid(H, units.RCTAP0, skin=SKIN, ccap=8)
    sm = tps.bin_slots(pose, torch.ones(pose.shape[0], dtype=torch.bool),
                       grid, st.n)
    own = img.owner.to(torch.int64)
    prim = (torch.arange(pose.shape[0]) < st.n).to(dtype)
    planes = tps.pack_slots(sm.slot_src, [pose[:, 0], pose[:, 1], pose[:, 2],
                                          st.types[own].to(dtype), prim])
    ffd = trx.ffdev_from(tf, dtype=dtype)
    fn = tps.make_qeq_pair_fn(ffd, tf.nso, float(ffd.rctap2))
    slot_owner = torch.where(sm.slot_src >= 0, sm.slot_src % st.n, 0)
    return dict(n=st.n, grid=grid, sm=sm, planes=planes, fn=fn,
                own=slot_owner.to(torch.int32))


@pytest.fixture(scope="module", params=[(1, 1, 1), (2, 2, 1)],
                ids=["cell", "replica221"])
def deck(request):
    return _setup(request.param, torch.float64)


def _walk(d, kind):
    if kind == "atom":
        return tps.atom_walk(d["sm"])
    packed = torch.cat([d["planes"], torch.zeros_like(d["planes"][:3])])
    return tps.slot_walk(d["grid"], packed)


def _candidates(grid, walk):
    """Per target, its walk's filled-slot candidates, counted cell by cell
    (numpy)."""
    ccap, nz = grid.ccap, grid.nc[2]
    count = np.diff(walk.cell_start.numpy())
    coloffs = tps._target_tables(grid)[1]
    reach = tps._reach_table(grid)
    out = []
    for ts in walk.tslot.tolist():
        tz = (ts % (nz * ccap)) // ccap
        base = ts - ts % (nz * ccap)
        n = 0
        for off, r in zip(coloffs.tolist(), reach.tolist()):
            cb = (base + off) // ccap
            n += int(count[cb + max(tz - r, 0): cb + min(tz + r, nz - 1)
                           + 1].sum())
        out.append(n)
    return np.asarray(out)


@pytest.mark.parametrize("kind", ["atom", "slot"])
def test_offsets_are_the_candidates_prefix(deck, kind):
    d = deck
    walk = _walk(d, kind)
    cand = _candidates(d["grid"], walk)
    assert walk.qstart.dtype == torch.int32
    assert walk.qstart.shape == (walk.tslot.shape[0] + 1,)
    assert int(walk.qstart[0]) == 0
    assert np.array_equal(np.diff(walk.qstart.numpy()), cand)
    assert int(walk.qstart[-1]) == int(tps.walk_candidates(d["grid"], walk))
    if kind == "atom":
        # the slot map made them, for every solve over it
        assert walk.qstart is d["sm"].qstart
    lst = tps.qeq_build_plain(d["grid"], walk, d["planes"], d["fn"],
                              d["own"], d["n"])
    assert int(lst.need) == int(cand.sum()) == lst.rec.shape[0]
    assert bool((lst.count <= torch.as_tensor(cand)).all())
    assert torch.equal(lst.start, walk.qstart[:-1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rows_hold_the_walk_pairs_in_order(deck, dtype):
    d = deck if dtype == "float64" else _setup(
        (1, 1, 1) if deck["n"] == 168 else (2, 2, 1), torch.float32)
    grid, walk, planes, fn = d["grid"], _walk(d, "atom"), d["planes"], d["fn"]
    lst = tps.qeq_build_plain(grid, walk, planes, fn, d["own"], d["n"])
    idt = torch.int32 if dtype == "float32" else torch.int64
    assert lst.rec.dtype == idt and lst.h.dtype == planes.dtype
    i, tsl, src = tps.walk_pairs_plain(grid, walk, planes[:3], fn.rc2)
    ok, h = tps._qeq_hessian(fn, planes[:, tsl], planes[:, src])
    own = d["own"].long()
    start, count = lst.start.tolist(), lst.count.tolist()
    seen = 0
    for t in range(walk.tslot.shape[0]):
        sel = (i == t) & ok
        o = own[src[sel]]
        want_code = torch.where(planes[4, src[sel]] > 0.5, o, ~o)
        got = lst.rec[start[t]:start[t] + count[t]]
        assert count[t] == int(sel.sum())
        assert torch.equal(got[:, 0].long(), want_code), t
        assert torch.equal(lst.h[start[t]:start[t] + count[t]], h[sel]), t
        seen += count[t]
    assert seen == int(ok.sum()) > 0
    codes = lst.code[torch.cat([torch.arange(s, s + c) for s, c in
                                zip(start, count)])].long()
    assert bool((codes >= 0).any()) and bool((codes < 0).any())


def test_apply_without_q(deck):
    d = deck
    walk = _walk(d, "atom")
    lst = tps.qeq_build_plain(d["grid"], walk, d["planes"], d["fn"],
                              d["own"], d["n"])
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.normal(size=(d["n"], 2)))
    q = torch.as_tensor(rng.normal(size=d["n"]))
    with_q = tps.qeq_apply(lst, walk, X, q)          # CPU: the plain apply
    without = tps.qeq_apply(lst, walk, X)
    assert torch.equal(without[:2], with_q[:2])
    assert not bool(without[2].any()) and bool(with_q[2].any())


def test_capacity_cut_drops_the_records_past_it(deck):
    d = deck
    walk = _walk(d, "atom")
    args = (d["grid"], walk, d["planes"], d["fn"], d["own"], d["n"])
    full = tps.qeq_build_plain(*args)
    need = int(full.need)
    cap = int(full.start[walk.tslot.shape[0] // 2]) + 3
    cut = tps.qeq_build_plain(*args, cap=cap)
    assert int(cut.need) == need > cut.rec.shape[0] == cap
    assert torch.equal(cut.rec, full.rec[:cap])
    assert torch.equal(cut.count, full.count)
    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.normal(size=(d["n"], 2)))
    q = torch.as_tensor(rng.normal(size=d["n"]))
    # the cut list applies as the full list with those records' h zeroed
    zeroed = full.rec.clone()
    zeroed[cap:, 1] = 0
    want = tps.qeq_apply_plain(full._replace(rec=zeroed), walk, X, q)
    got = tps.qeq_apply_plain(cut, walk, X, q)
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


def test_gradient_rows_match_pallas():
    """The apply without q (the CG's gradient matvec), float32, against
    rxmd_tpu's Pallas sweep with the QEq body in interpret mode at q = 0."""
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type, dtype=jnp.float32)
    jffd = jrx.ffdev_from(ff, dtype=jnp.float32)
    H = np.asarray(st.H)
    img = jnb.make_image_table(st.n, jnb.nimg_for_cutoff(H, 10.0 + SKIN),
                               jnp.float32)
    grid = jps.make_pair_grid(H, units.RCTAP0, skin=SKIN, ccap=8)
    pose = jnb.ext_positions(st.pos, st.H, img)
    sm = jps.bin_slots(pose, jnp.ones(pose.shape[0], bool), grid, st.n)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(st.n, 2)).astype(np.float32)
    own = np.asarray(img.owner)
    m = pose.shape[0]
    ext = [np.asarray(pose[:, 0]), np.asarray(pose[:, 1]),
           np.asarray(pose[:, 2]),
           np.asarray(st.types)[own].astype(np.float32),
           (np.arange(m) < st.n).astype(np.float32), X[own, 0], X[own, 1],
           np.zeros(m, np.float32)]
    jp = jps.pack_slots(sm.slot_src, [jnp.asarray(c) for c in ext])
    pair_fn, out_k, consts = jps.make_qeq_pair_fn(
        jffd, ff.nso, float(jffd.rctap2))
    ref = np.asarray(jps.gather_rows(grid, jps._sweep(
        grid, jp, pair_fn, out_k, consts=consts, interpret=True),
        sm.slot_of_atom))

    d = _setup((1, 1, 1), torch.float32)
    walk = tps.atom_walk(d["sm"])
    lst = tps.qeq_build(d["grid"], walk, d["planes"], d["fn"], d["own"],
                        d["n"])                      # CPU: the plain build
    got = tps.qeq_apply(lst, walk, torch.as_tensor(X)).numpy()
    for k in range(2):
        assert np.abs(got[k] - ref[k]).max() < 3e-4 * max(
            1.0, np.abs(ref[k]).max()), k
    assert not got[2].any() and not ref[2].any()


@pytest.mark.parametrize("kind", ["atom", "slot"])
def test_build_blocks_split_the_targets_by_column(deck, kind):
    """The build's blocks (`Walk.qblocks`, made with the slot map): every
    target in exactly one block, each block at most BUILD_TARGETS
    consecutive targets of one column, cut only at a column's end or after
    BUILD_TARGETS, the largest first, then the empty ones."""
    d = deck
    walk = _walk(d, kind)
    T = walk.tslot.shape[0]
    ccap, nz = d["grid"].ccap, d["grid"].nc[2]
    blocks = walk.qblocks.tolist()
    assert walk.qblocks.dtype == torch.int32
    assert len(blocks) == -(-T // tps.BUILD_TARGETS) + min(
        T, d["grid"].nc[0] * d["grid"].nc[1])
    sizes = [e - s for s, e in blocks]
    assert sizes == sorted(sizes, reverse=True)
    real = sorted((s, e) for s, e in blocks if e > s)
    assert all((s, e) == (T, T) for s, e in blocks if e == s)
    assert real[0][0] == 0 and real[-1][1] == T
    assert all(e1 == s2 for (_, e1), (s2, _) in zip(real, real[1:]))
    col = (walk.tslot // (nz * ccap)).tolist()
    for s, e in real:
        assert e - s <= tps.BUILD_TARGETS
        assert len(set(col[s:e])) == 1
        assert e == T or col[e] != col[s] or e - s == tps.BUILD_TARGETS
    if kind == "atom":
        assert walk.qblocks is d["sm"].qblocks
