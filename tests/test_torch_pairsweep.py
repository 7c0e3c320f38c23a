"""rxmd_tpu_torch pair sweeps (ops/pairsweep) against rxmd_tpu.

* slot binning equals rxmd_tpu's exactly (stable sort by cell id);
* the plain sweeps against rxmd_tpu's Pallas `_sweep` in interpret mode,
  float32, at tests/test_pairsweep.py's bars (energy 2e-3 relative, force
  2e-4 of max|f|, virial 2e-3, QEq 3e-4): same math, other summation order
  and the TPU's wider candidate windows;
* the plain sweeps in float64 against rxmd_tpu's independent ELL forms
  (`nonbond_cf_energy_forces`, the `cf_qeq_kernel` matvecs) within 1e-9:
  same pairs, same closed-form kernels, another summation order;
* the kernels' cell walk (the plain versions `walk_pairs_plain`,
  `nonbond_plain`, `qeq_build_plain` + `qeq_apply_plain`), on the 168-atom
  cell and its (2, 2, 1) replica: its pair set equals `_pair_list`'s
  exactly, and its rows equal `sweep_plain`'s within 1e-12 in float64
  (same pairs, another summation order); the QEq list's rows match
  rxmd_tpu's Pallas `_sweep` at the 3e-4 bar above.  The QEq list's
  layout itself is held in test_torch_qeq_list.py.

The CUDA kernels are held against the plain sweeps in test_torch_cuda.py.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rxmd_tpu import ffield as jff, system as jsys, neighbors as jnb, \
    reax as jrx, units
from rxmd_tpu.ops import pairsweep as jps
from rxmd_tpu_torch import ffield as tff, neighbors as tnb, reax as trx, \
    system as tsys
from rxmd_tpu_torch.ops import pairsweep as tps

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
SKIN = 0.4


def _setup(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type, dtype=jdt)
    jffd = jrx.ffdev_from(ff, dtype=jdt)
    tffd = trx.ffdev_from_numpy({k: np.asarray(v)
                                 for k, v in jffd._asdict().items()},
                                dtype=tdt)
    H = np.asarray(st.H)
    img = jnb.make_image_table(st.n, jnb.nimg_for_cutoff(H, 10.0 + SKIN),
                               jdt)
    grid = jps.make_pair_grid(H, units.RCTAP0, skin=SKIN, ccap=8)
    tgrid = tps.make_pair_grid(H, units.RCTAP0, skin=SKIN, ccap=8)
    pose = jnb.ext_positions(st.pos, st.H, img)
    sm = jps.bin_slots(pose, jnp.ones(pose.shape[0], bool), grid, st.n)
    tpose = torch.tensor(np.asarray(pose))
    tsm = tps.bin_slots(tpose, torch.ones(tpose.shape[0], dtype=torch.bool),
                        tgrid, st.n)
    rng = np.random.default_rng(11)
    q = rng.normal(scale=0.1, size=st.n)
    q -= q.mean()
    hs, ht = rng.normal(size=(2, st.n))
    S = img.n_images
    own = np.asarray(img.owner)
    types = np.asarray(st.types)
    m = pose.shape[0]
    ext = {"x": np.asarray(pose[:, 0]), "y": np.asarray(pose[:, 1]),
           "z": np.asarray(pose[:, 2]), "type": types[own].astype(dtype),
           "gid": np.asarray(st.gid)[own].astype(dtype),
           "prim": (np.arange(m) < st.n).astype(dtype),
           "q": np.tile(q, S).astype(dtype), "hs": np.tile(hs, S).astype(dtype),
           "ht": np.tile(ht, S).astype(dtype)}
    return dict(ff=ff, st=st, jffd=jffd, tffd=tffd, img=img, grid=grid,
                tgrid=tgrid, sm=sm, tsm=tsm, q=q, hs=hs, ht=ht, ext=ext,
                jdt=jdt, tdt=tdt)


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


@pytest.fixture(scope="module")
def f64():
    return _setup("float64")


NB_PLANES = ("x", "y", "z", "type", "gid", "q")
QEQ_PLANES = ("x", "y", "z", "type", "prim", "hs", "ht", "q")


def _packed(d, planes):
    jp = jps.pack_slots(d["sm"].slot_src,
                        [jnp.asarray(d["ext"][p], d["jdt"]) for p in planes])
    tp = tps.pack_slots(d["tsm"].slot_src,
                        [torch.tensor(d["ext"][p]) for p in planes])
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_slot_binning_matches(f32, f64, dtype):
    d = f32 if dtype == "float32" else f64
    assert d["grid"] == tuple(d["tgrid"])
    assert np.array_equal(np.asarray(d["sm"].slot_src),
                          d["tsm"].slot_src.numpy())
    assert np.array_equal(np.asarray(d["sm"].slot_of_atom),
                          d["tsm"].slot_of_atom.numpy())
    assert int(d["sm"].overflow) == int(d["tsm"].overflow) <= d["grid"].ccap
    jp, tp = _packed(d, QEQ_PLANES)
    assert np.array_equal(np.asarray(jp), tp.numpy())


def _plain_rows(d, planes, fn):
    _, tp = _packed(d, planes)
    out = tps.sweep_plain(d["tgrid"], tp, fn)
    return tps.gather_rows(d["tgrid"], out, d["tsm"].slot_of_atom).numpy()


def test_nonbond_plain_matches_pallas(f32):
    d = f32
    jp, _ = _packed(d, NB_PLANES)
    pair_fn, out_k, consts = jps.make_nonbond_pair_fn(
        d["jffd"], d["ff"].nso, float(d["jffd"].rctap2))
    out = jps._sweep(d["grid"], jp, pair_fn, out_k, consts=consts,
                     interpret=True)
    ref = np.asarray(jps.gather_rows(d["grid"], out, d["sm"].slot_of_atom))
    fn = tps.make_nonbond_pair_fn(d["tffd"], d["ff"].nso,
                                  float(d["tffd"].rctap2))
    got = _plain_rows(d, NB_PLANES, fn)
    for k in (0, 1):
        assert abs(got[k].sum() - ref[k].sum()) < 2e-3 * max(
            1.0, abs(ref[k].sum()))
    assert np.abs(got[2:5] - ref[2:5]).max() < 2e-4 * np.abs(ref[2:5]).max()
    w, wr = got[5:].sum(1), ref[5:].sum(1)
    assert np.abs(w - wr).max() < 2e-3 * max(1.0, np.abs(wr).max())


def test_qeq_plain_matches_pallas(f32):
    d = f32
    jp, _ = _packed(d, QEQ_PLANES)
    pair_fn, out_k, consts = jps.make_qeq_pair_fn(
        d["jffd"], d["ff"].nso, float(d["jffd"].rctap2))
    out = jps._sweep(d["grid"], jp, pair_fn, out_k, consts=consts,
                     interpret=True)
    ref = np.asarray(jps.gather_rows(d["grid"], out, d["sm"].slot_of_atom))
    fn = tps.make_qeq_pair_fn(d["tffd"], d["ff"].nso, float(d["tffd"].rctap2))
    got = _plain_rows(d, QEQ_PLANES, fn)
    for k in range(3):
        assert np.abs(got[k] - ref[k]).max() < 3e-4 * max(
            1.0, np.abs(ref[k]).max()), k


@pytest.fixture(scope="module")
def ell64(f64):
    d = f64
    st = d["st"]
    rc2b = np.asarray(d["jffd"].rc2b)
    rc2b = (np.sqrt(rc2b) + SKIN) ** 2 * (rc2b > 0)
    nbrs = jnb.build_neighbors_brute(st.pos, st.H, st.types, d["img"],
                                     jnp.asarray(rc2b), (10.0 + SKIN) ** 2,
                                     24, 1024)
    assert int(nbrs.cntnb.max()) <= 1024
    return nbrs


def test_nonbond_plain_matches_ell_f64(f64, ell64):
    d = f64
    st = d["st"]
    q = jnp.asarray(d["q"])
    amask = jnp.ones(st.n, bool)
    ctx = jrx.nb_ctx(st.pos, q, st.H, st.types, d["img"], ell64, st.gid,
                     amask, d["jffd"])
    evdw, eclmb, _, f, w = jrx.nonbond_cf_energy_forces(
        ctx, q, st.types, amask, d["jffd"], with_virial=True, img=d["img"])
    fn = tps.make_nonbond_pair_fn(d["tffd"], d["ff"].nso,
                                  float(d["tffd"].rctap2))
    got = _plain_rows(d, NB_PLANES, fn)
    assert abs(got[0].sum() - float(evdw)) <= 1e-9 * abs(float(evdw))
    assert abs(got[1].sum() - float(eclmb)) <= 1e-9 * abs(float(eclmb))
    f = np.asarray(f)
    assert np.abs(got[2:5].T - f).max() <= 1e-9 * np.abs(f).max()
    w = np.asarray(w)
    w6 = np.array([w[0, 0], w[1, 1], w[2, 2], w[1, 2], w[2, 0], w[0, 1]])
    assert np.abs(got[5:].sum(1) - w6).max() <= 1e-9 * np.abs(w6).max()


def test_qeq_plain_matches_ell_f64(f64, ell64):
    d = f64
    st = d["st"]
    n = st.n
    img = d["img"]
    amask = jnp.ones(n, bool)
    ctx = jrx.nb_ctx(st.pos, None, st.H, st.types, img, ell64, st.gid, amask,
                     d["jffd"])
    in_range = ctx.mask & (ctx.dr2 < d["jffd"].rctap2)
    hess = jrx.cf_qeq_kernel(ctx.dr2, jrx.ctx_prm(ctx, st.types, d["jffd"]),
                             d["jffd"], in_range)
    mask = ell64.masknb
    hz = jnp.where(mask, hess, 0.0)
    oj = img.owner_of(ctx.idx)
    idxnb = jnp.where(mask, ell64.idxnb, 0)
    estw = jnp.where(idxnb < n, 1.0, 0.5)
    want = [jnp.sum(hz * jnp.where(mask, jnp.asarray(v)[oj], 0.0), axis=1)
            for v in (d["hs"], d["ht"])]
    want.append(jnp.sum(estw * hz * jnp.where(mask, jnp.asarray(d["q"])[oj],
                                              0.0), axis=1))
    fn = tps.make_qeq_pair_fn(d["tffd"], d["ff"].nso, float(d["tffd"].rctap2))
    got = _plain_rows(d, QEQ_PLANES, fn)
    for k in range(3):
        w = np.asarray(want[k])
        assert np.abs(got[k] - w).max() <= 1e-9 * np.abs(w).max(), k


# ---------------------------------------------------------------------------
# the kernels' cell walk
# ---------------------------------------------------------------------------

def _walk_setup(mc, dtype=torch.float64):
    """The port's slot layout of the deck replicated `mc`, its planes with
    numpy-seeded charges and CG vectors, and both pair functions."""
    tf = tff.parse_ffield(FF)
    st = tsys.from_cellfile(CELL, tf.name_to_type, mc=mc, dtype=dtype)
    H = st.H.numpy()
    img = tnb.make_image_table(st.n, tnb.nimg_for_cutoff(H, 10.0 + SKIN),
                               dtype, "cpu")
    pose = tnb.ext_positions(st.pos, st.H, img)
    grid = tps.make_pair_grid(H, units.RCTAP0, skin=SKIN, ccap=8)
    sm = tps.bin_slots(pose, torch.ones(pose.shape[0], dtype=torch.bool),
                       grid, st.n)
    rng = np.random.default_rng(17)
    q = rng.normal(scale=0.1, size=st.n)
    q -= q.mean()
    hs, ht = (torch.tensor(v, dtype=dtype) for v in rng.normal(size=(2, st.n)))
    q = torch.tensor(q, dtype=dtype)
    own = img.owner.to(torch.int64)
    prim = (torch.arange(pose.shape[0]) < st.n).to(dtype)
    cols = {"x": pose[:, 0], "y": pose[:, 1], "z": pose[:, 2],
            "type": st.types[own].to(dtype), "gid": st.gid[own].to(dtype),
            "prim": prim, "q": q[own], "hs": hs[own], "ht": ht[own]}
    packed = {name: tps.pack_slots(sm.slot_src, [cols[p] for p in planes])
              for name, planes in (("nonbond", NB_PLANES),
                                   ("qeq", QEQ_PLANES))}
    ffd = trx.ffdev_from(tf, dtype=dtype)
    fns = {"nonbond": tps.make_nonbond_pair_fn(ffd, tf.nso,
                                               float(ffd.rctap2)),
           "qeq": tps.make_qeq_pair_fn(ffd, tf.nso, float(ffd.rctap2))}
    slot_owner = torch.where(sm.slot_src >= 0, sm.slot_src % st.n, 0)
    return dict(n=st.n, grid=grid, sm=sm, packed=packed, fns=fns, hs=hs,
                ht=ht, q=q, slot_owner=slot_owner)


@pytest.fixture(scope="module", params=[(1, 1, 1), (2, 2, 1)],
                ids=["cell", "replica221"])
def walk64(request):
    return _walk_setup(request.param)


def test_walk_pairs_equal_pair_list(walk64):
    """The kernels' culling rule (per-column reach counted with rctap +
    skin, filled slots from the cell counts) finds exactly the pairs
    within rctap that `_pair_list`'s wider windows find."""
    d = walk64
    grid, packed, fn = d["grid"], d["packed"]["qeq"], d["fns"]["qeq"]
    walk = tps.slot_walk(grid, packed)
    # the filled slots and cell counts the engine's walk reads are the
    # planes' own
    awalk = tps.atom_walk(d["sm"])
    assert torch.equal(walk.cell_start, awalk.cell_start)
    # the engine's walk holds them first, then 0 to its fixed length
    M = walk.slots.shape[0]
    assert torch.equal(walk.slots, awalk.slots[:M])
    assert not bool(awalk.slots[M:].any())
    assert torch.equal(torch.diff(walk.cell_start), d["sm"].cell_count)
    i, tsl, src = tps.walk_pairs_plain(grid, walk, packed[:3], fn.rc2)
    got = set(zip(walk.trow[i].tolist(), tsl.tolist(), src.tolist()))
    tgt, tsl2, src2 = tps._pair_list(grid, packed, fn.rc2, 1 << 22)
    want = set(zip(tgt.tolist(), tsl2.tolist(), src2.tolist()))
    assert len(got) == i.shape[0] > 0     # no pair twice
    assert got == want
    # per target, the pairs come in the kernels' order: column by column,
    # slots ascending within a column, targets in walk order
    assert bool((torch.diff(i) >= 0).all())
    reach = tps._reach_table(grid)
    assert reach.max() <= grid.zreach and reach.min() >= 1


def test_qeq_list_rows_equal_sweep_plain_f64(walk64):
    """qeq_build_plain + qeq_apply_plain over the sweep's target layout
    (each slot its own source index) and over the engine's walk (owner
    indices with the image flag) give sweep_plain's QEq rows; the list
    holds the walk's candidates, float64 records of (code, bits of h)."""
    d = walk64
    grid, packed, fn = d["grid"], d["packed"]["qeq"], d["fns"]["qeq"]
    ref = tps.sweep_plain(grid, packed, fn)
    walk = tps.slot_walk(grid, packed)
    own = torch.arange(grid.nslots, dtype=torch.int32)
    lst = tps.qeq_build_plain(grid, walk, packed[:5], fn, own, grid.nslots)
    got = tps.qeq_apply_plain(lst, walk, packed[5:7].T.contiguous(),
                              packed[7])
    assert got.shape == ref.shape == (3, grid.n_targets)
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert bool(((got - ref).abs() <= 1e-12 * scale).all())
    assert (int(lst.need) == lst.rec.shape[0]
            == int(tps.walk_candidates(grid, walk))
            > int(lst.count.sum()) > 0)
    assert lst.rec.dtype == torch.int64 and lst.h.dtype == torch.float64

    awalk = tps.atom_walk(d["sm"])
    alst = tps.qeq_build_plain(grid, awalk, packed[:5], fn,
                               d["slot_owner"], d["n"])
    X = torch.stack([d["hs"], d["ht"]], dim=1)
    rows = tps.qeq_apply_plain(alst, awalk, X, d["q"])
    want = tps.gather_rows(grid, ref, d["sm"].slot_of_atom)
    assert rows.shape == (3, d["n"])
    assert bool(((rows - want).abs() <= 1e-12 * scale).all())
    # without q, the Est row is 0 and the others stay
    assert torch.equal(tps.qeq_apply_plain(alst, awalk, X)[:2], rows[:2])
    assert not bool(tps.qeq_apply_plain(alst, awalk, X)[2].any())
    # the image flag: primary sources keep their owner, images get ~owner
    live = torch.cat([torch.arange(int(s), int(s) + int(c)) for s, c in
                      zip(alst.start, alst.count)])
    src = alst.code[live]
    assert bool((src >= 0).any()) and bool((src < 0).any())
    assert bool((torch.where(src >= 0, src, ~src) < d["n"]).all())


def test_nonbond_walk_equals_sweep_plain_f64(walk64):
    d = walk64
    grid, packed, fn = d["grid"], d["packed"]["nonbond"], d["fns"]["nonbond"]
    ref = tps.sweep_plain(grid, packed, fn)
    got = tps.nonbond_plain(grid, tps.slot_walk(grid, packed), packed, fn)
    assert got.shape == ref.shape == (11, grid.n_targets)
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert bool(((got - ref).abs() <= 1e-12 * scale).all())
    rows = tps.nonbond_plain(grid, tps.atom_walk(d["sm"]), packed, fn)
    want = tps.gather_rows(grid, ref, d["sm"].slot_of_atom)
    assert bool(((rows - want).abs() <= 1e-12 * scale).all())
    # rows=: only those targets, each exactly as without it
    rows_t = tps.target_index(grid, d["sm"].slot_of_atom[:5])
    part = tps.nonbond_plain(grid, tps.slot_walk(grid, packed, rows_t),
                             packed, fn)
    assert torch.equal(part[:, rows_t], got[:, rows_t])
    keep = torch.ones(grid.n_targets, dtype=torch.bool)
    keep[rows_t] = False
    assert not bool(part[:, keep].any())


def test_qeq_list_matches_pallas(f32):
    """The QEq build + apply rows, float32, against rxmd_tpu's Pallas
    `_sweep` with the QEq body in interpret mode (bar as above)."""
    d = f32
    jp, tp = _packed(d, QEQ_PLANES)
    pair_fn, out_k, consts = jps.make_qeq_pair_fn(
        d["jffd"], d["ff"].nso, float(d["jffd"].rctap2))
    out = jps._sweep(d["grid"], jp, pair_fn, out_k, consts=consts,
                     interpret=True)
    ref = np.asarray(jps.gather_rows(d["grid"], out, d["sm"].slot_of_atom))
    fn = tps.make_qeq_pair_fn(d["tffd"], d["ff"].nso, float(d["tffd"].rctap2))
    grid = d["tgrid"]
    walk = tps.atom_walk(d["tsm"])
    own = d["tsm"].slot_src.clamp(min=0) % d["st"].n
    lst = tps.qeq_build(grid, walk, tp[:5].contiguous(), fn, own.int(),
                        d["st"].n)          # CPU tensors: the plain build
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    X = torch.stack([f(d["hs"]), f(d["ht"])], dim=1)
    got = tps.qeq_apply(lst, walk, X, f(d["q"])).numpy()
    for k in range(3):
        assert np.abs(got[k] - ref[k]).max() < 3e-4 * max(
            1.0, np.abs(ref[k]).max()), k
