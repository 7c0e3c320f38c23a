"""rxmd_tpu_torch's CUDA kernels (the pair kernels, the hydrogen-bond
kernel, the torsion kernel and the pair list's nonbond kernel) against
their plain PyTorch versions, on a card (every case skips without one).

This file imports no jax, so it also runs where jax is not installed;
tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

168-atom deck, float32, the engine's own slot layout, walk and planes.
Bar: each output row within 1e-4 of its largest magnitude (at least 1):
the kernel and the plain version add the same float32 pair terms in
another order.  The QEq list: the same count per row and the same
sources in each row's records, in walk order (both gate on the same
float32 distance), h within 1e-5 of max|h|.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu_torch import config, ffield, md, neighbors, reax, system
from rxmd_tpu_torch.ops import hbond as hb
from rxmd_tpu_torch.ops import pairsweep as ps
from rxmd_tpu_torch.ops import torsion as tor

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")


@pytest.fixture(scope="module")
def planes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ff = ffield.parse_ffield(FF)
    st = system.from_cellfile(CELL, ff.name_to_type)
    e = md.Engine(ff, st, config.RunConfig(dtype="float32"), device="cuda")
    e._rebuild(e.state)
    s = e.state
    ops = e.pairs.data(s.pos, s, None, e._layout)
    rng = np.random.default_rng(3)
    q = rng.normal(scale=0.2, size=s.n)
    q -= q.mean()
    hs, ht = rng.normal(size=(2, s.n))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    q, hs, ht = t(q), t(hs), t(ht)
    okf = (e._layout.sm.slot_src >= 0).float()
    qeq8 = torch.cat([ops.qeq_planes(),
                      torch.stack([hs, ht, q])[:, ops.own.long()] * okf])
    return dict(grid=ops.grid, n=s.n, ops=ops, nb_fn=ops.nb_fn,
                qeq_fn=ops.fn, nb=ops.nonbond_planes(q), qeq8=qeq8,
                hs=hs, ht=ht, q=q, X=torch.stack([hs, ht], dim=1),
                slot_of_atom=e._layout.sm.slot_of_atom)


def _live(lst):
    """The indices of the list's records that rows hold, row by row."""
    return torch.cat([torch.arange(int(s), int(s) + int(c), device=s.device)
                      for s, c in zip(lst.start, lst.count)])


def _within(got, ref, bar=1e-4):
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs().amax(dim=1)
    scale = ref.abs().amax(dim=1).clamp(min=1.0)
    assert bool((err <= bar * scale).all()), (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nonbond", "qeq"])
def test_kernel_matches_plain(planes, name):
    """The kernels over the engine's walk (the nonbond kernel, or
    qeq_build then qeq_apply) against `gather_rows` of `sweep_plain` over
    the TPU kernel's target layout."""
    d = planes
    grid, ops = d["grid"], d["ops"]
    packed, fn = ((d["nb"], d["nb_fn"]) if name == "nonbond"
                  else (d["qeq8"], d["qeq_fn"]))
    n0 = dict(ps.launches)
    if name == "nonbond":
        got = ps.nonbond(grid, ops.walk, packed, fn)
    else:
        lst = ps.qeq_build(grid, ops.walk, ops.qeq_planes(), fn, ops.own,
                           d["n"])
        got = ps.qeq_apply(lst, ops.walk, d["X"], d["q"])
    want = ({"nonbond": 1} if name == "nonbond"
            else {"qeq_build": 1, "qeq_apply": 1})
    assert {k: ps.launches[k] - n0[k] for k in n0} == {
        k: want.get(k, 0) for k in n0}
    ref = ps.gather_rows(grid, ps.sweep_plain(grid, packed, fn),
                         d["slot_of_atom"])
    torch.cuda.synchronize()
    assert got.shape == (fn.out_k, d["n"])
    _within(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nonbond", "qeq_build", "qeq_apply"])
def test_walk_kernel_matches_plain(planes, name):
    """Each kernel on the engine's walk against its plain version."""
    d = planes
    grid, ops, n = d["grid"], d["ops"], d["n"]
    walk = ops.walk
    n0 = ps.launches[name]
    if name == "nonbond":
        got = ps.nonbond(grid, walk, d["nb"], d["nb_fn"])
        ref = ps.nonbond_plain(grid, walk, d["nb"], d["nb_fn"])
        _within(got, ref)
    elif name == "qeq_build":
        args = (grid, walk, ops.qeq_planes(), d["qeq_fn"], ops.own, n)
        lst = ps.qeq_build(*args)
        ref = ps.qeq_build_plain(*args)
        assert torch.equal(lst.start, ref.start)
        assert torch.equal(lst.count, ref.count)
        assert int(lst.need) == int(ref.need) == lst.rec.shape[0]
        live = _live(ref)
        assert torch.equal(lst.code[live], ref.code[live])
        assert float((lst.h[live] - ref.h[live]).abs().max()) <= 1e-5 * float(
            ref.h[live].abs().max())
    else:
        lst = ps.qeq_build(grid, walk, ops.qeq_planes(), d["qeq_fn"],
                           ops.own, n)
        n0 = ps.launches[name]
        got = ps.qeq_apply(lst, walk, d["X"], d["q"])
        _within(got, ps.qeq_apply_plain(lst, walk, d["X"], d["q"]))
    torch.cuda.synchronize()
    assert ps.launches[name] == n0 + 1


@pytest.mark.gpu
def test_qeq_apply_takes_strided_columns(planes):
    """qeq_apply reads the CG's strided columns as the (n, 2) state
    itself, and without q (the gradient) gives the same first two rows and
    an Est row of 0, with one launch each."""
    d = planes
    grid, ops, n = d["grid"], d["ops"], d["n"]
    walk = ops.walk
    lst = ps.qeq_build(grid, walk, ops.qeq_planes(), d["qeq_fn"], ops.own, n)
    n0 = ps.launches["qeq_apply"]
    got = ps.qeq_apply(lst, walk, d["X"], d["q"])
    grad = ps.qeq_apply(lst, walk, d["X"])
    torch.cuda.synchronize()
    assert ps.launches["qeq_apply"] == n0 + 2
    _within(got, ps.qeq_apply_plain(lst, walk, d["X"], d["q"]))
    assert torch.equal(grad[:2], got[:2]) and not bool(grad[2].any())


def _build_groups(grid, walk, build_z=16):
    """The QEq build's groups as the kernel forms them (each block's
    targets cut where one lies below the group's first z-cell or
    build_z cells above it), each with its staged window's filled slots
    (per stencil column, the union of its targets' reaches)."""
    ccap, nz = grid.ccap, grid.nc[2]
    coloffs = ps._target_tables(grid)[1].tolist()
    reach = ps._reach_table(grid).tolist()
    cs = walk.cell_start.tolist()
    ts = walk.tslot.tolist()
    out = []
    for a, b in walk.qblocks.tolist():
        i = a
        while i < b:
            z0 = (ts[i] % (nz * ccap)) // ccap
            j = i
            while j < b and 0 <= (ts[j] % (nz * ccap)) // ccap - z0 < build_z:
                j += 1
            z1 = max((t % (nz * ccap)) // ccap for t in ts[i:j])
            base = ts[i] - ts[i] % (nz * ccap)
            slots = sum(
                cs[(base + o) // ccap + min(z1 + r, nz - 1) + 1]
                - cs[(base + o) // ccap + max(z0 - r, 0)]
                for o, r in zip(coloffs, reach))
            out.append((z1 - z0, slots))
            i = j
    return out


@pytest.mark.gpu
def test_qeq_build_tall_box_matches_plain():
    """The build on a tall deck (the cell replicated (1, 1, 8), 1,344
    atoms), where blocks span more than 16 z-cells (several groups a
    block) and windows outgrow one staged chunk, against its plain
    version: the same counts and sources per row, h within 1e-5 of
    max|h|; the apply's rows within the bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ff = ffield.parse_ffield(FF)
    st = system.from_cellfile(CELL, ff.name_to_type, mc=(1, 1, 8))
    e = md.Engine(ff, st, config.RunConfig(dtype="float32"), device="cuda")
    e._rebuild(e.state)
    s = e.state
    ops = e.pairs.data(s.pos, s, None, e._layout)
    grid, walk = ops.grid, ops.walk
    groups = _build_groups(grid, walk)
    stage = 4096 - (16 + 2 * grid.zreach) * grid.ccap
    assert len(groups) > int((walk.qblocks[:, 1] > walk.qblocks[:, 0]).sum())
    assert max(slots for _, slots in groups) > stage
    args = (grid, walk, ops.qeq_planes(), ops.fn, ops.own, s.n, ops.cap)
    lst = ps.qeq_build(*args)
    ref = ps.qeq_build_plain(*args)
    assert torch.equal(lst.count, ref.count)
    live = _live(ref)
    assert torch.equal(lst.code[live], ref.code[live])
    assert float((lst.h[live] - ref.h[live]).abs().max()) <= 1e-5 * float(
        ref.h[live].abs().max())
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(s.n, 2)), dtype=torch.float32,
                        device="cuda")
    q = torch.as_tensor(rng.normal(scale=0.2, size=s.n), dtype=torch.float32,
                        device="cuda")
    _within(ps.qeq_apply(lst, walk, X, q), ps.qeq_apply_plain(lst, walk, X, q))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(planes):
    """A wrong dtype, shape or device, or strided planes, raise before any
    launch."""
    d = planes
    grid, ops, n = d["grid"], d["ops"], d["n"]
    walk = ops.walk
    lst = ps.qeq_build(grid, walk, ops.qeq_planes(), d["qeq_fn"], ops.own, n)
    n0 = dict(ps.launches)
    bad_walk = walk._replace(tslot=walk.tslot.cpu())
    X = d["X"]
    calls = [
        lambda: ps.qeq_build(grid, walk._replace(qstart=walk.qstart[:-1]),
                             ops.qeq_planes(), d["qeq_fn"], ops.own, n),
        lambda: ps.qeq_apply(lst, walk, X.t().contiguous().t(), d["q"]),
        lambda: ps.nonbond(grid, walk, d["nb"].double(), d["nb_fn"]),
        lambda: ps.nonbond(grid, walk, d["nb"].t().contiguous().t(),
                           d["nb_fn"]),
        lambda: ps.nonbond(grid, bad_walk, d["nb"], d["nb_fn"]),
        lambda: ps.qeq_build(grid, walk, d["qeq8"], d["qeq_fn"], ops.own, n),
        lambda: ps.qeq_build(grid, walk, ops.qeq_planes(), d["qeq_fn"],
                             ops.own.long(), n),
        lambda: ps.qeq_apply(lst, walk, X.double(), d["q"]),
        lambda: ps.qeq_apply(lst, walk, X[:-1], d["q"]),
        lambda: ps.qeq_apply(lst, walk, X, d["q"][:-1]),
        lambda: ps.qeq_apply(lst, walk, X, X[:, 0]),
        lambda: ps.qeq_apply(lst._replace(rec=lst.rec.cpu()), walk, X,
                             d["q"]),
        lambda: ps.qeq_apply(lst, walk, torch.empty(
            2 * n + 1, device="cuda")[1:].view(n, 2), d["q"]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="takes a"):
            call()
    assert dict(ps.launches) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["PQEq", "LG"])
def test_pqeq_and_lg_step_on_the_card(what):
    """prepare + one step under PQEq and under LG on the card, float32:
    the pair-list engine (the sweep takes neither), no sweep kernel
    launched, finite, and the total PE within 1e-4 of the same run on the
    CPU (the float32 CG may stop an iteration apart on the two devices)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lg = what == "LG"
    ff = ffield.parse_ffield(os.path.join(DATA, "ffield_chon_synth_lg")
                             if lg else FF, lg=lg)
    kw = dict(dtype="float32", NMAXQEq=8)
    if not lg:
        kw.update(isPQEq=True,
                  pqeq_parm_path=os.path.join(DATA, "pqeq_chon.par"))
    pe = {}
    for dev in ("cuda", "cpu"):
        st = system.from_cellfile(CELL, ff.name_to_type)
        e = md.Engine(ff, st, config.RunConfig(**kw), device=dev)
        assert e.pair_engine == "ell" and not hasattr(e.pairs, "grid")
        n0 = dict(ps.launches)
        e.init_velocity(seed=2)
        e.prepare()
        e.step()
        assert dict(ps.launches) == n0
        assert bool(torch.isfinite(e.comps).all())
        assert bool(torch.isfinite(e.state.spos).all())
        pe[dev] = float(e.comps[0])
    assert abs(pe["cuda"] - pe["cpu"]) <= 1e-4 * abs(pe["cpu"])


# ----------------------------------------------------------------------
# the hydrogen-bond kernel (csrc/hbond.cu) against its plain version

def _card_deck(mc, dtype, device):
    """The cell replicated `mc` on `device`: positions, box, types, global
    ids, image table, neighbor lists (built in float64, then held) and
    force field in `dtype`, and the engine's capacities."""
    ff = ffield.parse_ffield(FF)
    st = system.from_cellfile(CELL, ff.name_to_type, mc=mc, device=device)
    ffd = reax.ffdev_from(ff, device=device)
    kb, knb, caps = md.probe_capacities(ff, st, ffd, 10.0, skin=0.4)
    nimg = neighbors.nimg_for_cutoff(st.H.cpu().numpy(), 10.4)
    img64 = neighbors.make_image_table(st.n, nimg, torch.float64, device)
    rc2b, rctap2 = md._skinned_cutoffs(ffd, 10.0, 0.4)
    nbrs = md._build(st, img64, md._cell_grid(ff, st, img64, 0.4, 10.0),
                     rc2b, rctap2, kb, knb)
    img = neighbors.make_image_table(st.n, nimg, dtype, device)
    return dict(pos=st.pos.to(dtype), H=st.H.to(dtype), types=st.types,
                gid=st.gid, img=img, nbrs=nbrs,
                ffd=reax.ffdev_from(ff, dtype=dtype, device=device),
                amask=torch.ones(st.n, dtype=torch.bool, device=device),
                kh=caps["kh"], caps=caps)


def _hbond_inputs(d):
    bo = reax.bond_order(d["pos"], d["H"], d["types"], d["img"], d["nbrs"],
                         d["ffd"])
    tab, _ = reax.hbond_tables(d["pos"], d["types"], d["img"], d["nbrs"],
                               bo, d["amask"], d["ffd"], d["kh"])
    return tab, bo.bo[:d["nbrs"].center_rows, :, 0].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mc", [(1, 1, 1), (4, 4, 3)], ids=["168", "8064"])
def test_hbond_kernel_matches_plain(mc, dtype):
    """The kernel against `hbond_plain` on the same CUDA tensors, with
    dE/dH and without, one launch each: the energy, dE/dpos, dE/dBO0 and
    dE/dH within 1e-4 (float32: the same terms summed in another order,
    atomics in any order) or 1e-10 (float64) of their largest magnitude
    (the energy: of itself).  Both gate on the same rounded distance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    bar = 1e-4 if dt == torch.float32 else 1e-10
    d = _card_deck(mc, dt, "cuda")
    tab, bo0 = _hbond_inputs(d)
    n0 = hb.launches["hbond"]
    got = hb.hbond(d["pos"], d["H"], bo0, tab, want_dh=True)
    bare = hb.hbond(d["pos"], d["H"], bo0, tab)
    ref = hb.hbond_plain(d["pos"], d["H"], bo0, tab, want_dh=True)
    torch.cuda.synchronize()
    assert hb.launches["hbond"] == n0 + 2
    assert bare[3] is None
    assert abs(float(ref[0])) > 0
    assert abs(float(got[0] - ref[0])) <= bar * abs(float(ref[0]))
    for a, b, what in zip(got[1:], ref[1:], ("dE/dpos", "dE/dBO", "dE/dH")):
        assert bool(torch.isfinite(a).all()), what
        err = float((a - b).abs().max())
        assert err <= bar * float(b.abs().max()), (what, err)
    assert torch.equal(bare[2], got[2])


@pytest.mark.gpu
def test_hbond_term_on_the_card_matches_cpu():
    """`reax.e_hbond_rows` through autograd (the kernel's gradients carried
    through the bond order and the box) on the card against the plain
    version on the CPU, float64: energy within 1e-12, dE/dpos and dE/dH
    within 1e-10; one launch per forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    out = {}
    for dev in ("cuda", "cpu"):
        d = _card_deck((1, 1, 1), torch.float64, dev)
        p = d["pos"].clone().requires_grad_(True)
        H = d["H"].clone().requires_grad_(True)
        bo = reax.bond_order(p, H, d["types"], d["img"], d["nbrs"], d["ffd"])
        n0 = hb.launches["hbond"]
        e = reax.e_hbond_rows(p, H, d["types"], d["img"], d["nbrs"], bo,
                              d["amask"], d["ffd"], kh=d["kh"])
        gp, gh = torch.autograd.grad(e, (p, H))
        assert hb.launches["hbond"] == n0 + (dev == "cuda")
        out[dev] = [x.detach().cpu() for x in (e, gp, gh)]
    (e1, gp1, gh1), (e0, gp0, gh0) = out["cuda"], out["cpu"]
    assert abs(float(e1 - e0)) <= 1e-12 * abs(float(e0))
    for a, b in ((gp1, gp0), (gh1, gh0)):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


@pytest.mark.gpu
def test_hbond_refuses_what_it_does_not_take():
    """A tensor on another device, a wrong dtype or a strided input raise
    before any launch; a donor with more hydrogens than kh raises as it
    did before the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    d = _card_deck((1, 1, 1), torch.float32, "cuda")
    tab, bo0 = _hbond_inputs(d)
    pos, H = d["pos"], d["H"]
    n0 = hb.launches["hbond"]
    calls = [
        lambda: hb.hbond(pos, H.cpu(), bo0, tab),
        lambda: hb.hbond(pos, H, bo0, tab._replace(idxnb=tab.idxnb.cpu())),
        lambda: hb.hbond(pos, H.double(), bo0, tab),
        lambda: hb.hbond(pos, H, bo0.double(), tab),
        lambda: hb.hbond(pos, H, bo0, tab._replace(types=tab.types.int())),
        lambda: hb.hbond(pos, H, bo0, tab._replace(hmask=tab.hmask.byte())),
        lambda: hb.hbond(pos, H, bo0.t().contiguous().t(), tab),
        lambda: hb.hbond(pos.t().contiguous().t(), H, bo0, tab),
        lambda: hb.hbond(pos, H, bo0, tab._replace(
            idxnb=tab.idxnb.t().contiguous().t())),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="takes a"):
            call()
    with pytest.raises(ValueError, match="float32 or float64"):
        hb.hbond(pos.half(), H.half(), bo0.half(), tab)
    bo = reax.bond_order(pos, H, d["types"], d["img"], d["nbrs"], d["ffd"])
    with pytest.raises(RuntimeError, match="hbond overflow"):
        reax.e_hbond_rows(pos, H, d["types"], d["img"], d["nbrs"], bo,
                          d["amask"], d["ffd"], kh=1)
    assert hb.launches["hbond"] == n0


# ----------------------------------------------------------------------
# the torsion kernel (csrc/torsion.cu) against its plain version

def _torsion_inputs(d):
    """The term's tables (the engine's capacities) and its inputs that
    carry a gradient: BO0, the pi BO, drb, delta."""
    bo = reax.bond_order(d["pos"], d["H"], d["types"], d["img"], d["nbrs"],
                         d["ffd"])
    caps = d["caps"]
    tab = tor.TorsionTables(
        types=d["types"], gid=d["gid"], amask=d["amask"],
        maskb=bo.mask.contiguous(), img=d["img"], nbrs=d["nbrs"],
        ffd=d["ffd"], ks=caps["ks"], cap=caps["tor"], rowcap=caps["tor_row"])
    return tab, (bo.bo[..., 0].contiguous(), bo.bo[..., 2].contiguous(),
                 bo.drb.contiguous(), bo.delta.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mc", [(1, 1, 1), (4, 4, 3)], ids=["168", "8064"])
def test_torsion_kernel_matches_plain(mc, dtype):
    """The kernel against `torsion_plain` on the same CUDA tensors, one
    launch: the same count of torsions; each energy within 1e-4 (float32)
    or 1e-10 (float64) of itself, and its gradients with respect to BO0,
    the pi BO, drb and delta within that of their largest magnitude.  Both
    keep the same torsions (the same products of the same float32 bond
    orders); the kernel takes cos 2w and cos 3w as polynomials of cos w
    where the plain version takes arccos, and sums in another order, with
    atomics in any order: float32 rounding, ~1e-6 of the largest
    gradient, and float64's, ~1e-15."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    bar = 1e-4 if dt == torch.float32 else 1e-10
    d = _card_deck(mc, dt, "cuda")
    tab, x = _torsion_inputs(d)
    n0 = tor.launches["torsion"]
    got = tor.torsion(*x, tab)
    ref = tor.torsion_plain(*x, tab)
    torch.cuda.synchronize()
    assert tor.launches["torsion"] == n0 + 1
    assert int(got[3]) == int(ref[3]) > 0
    for a, b in zip(got[:2], ref[:2]):
        assert abs(float(b)) > 0
        assert abs(float(a - b)) <= bar * abs(float(b))
    N, kb = tab.maskb.shape
    for k in (0, 1):
        for a, b, what in zip(tor.split(got[2][k], N, kb),
                              tor.split(ref[2][k], N, kb),
                              ("BO0", "pi", "drb", "delta")):
            assert bool(torch.isfinite(a).all()), (k, what)
            err = float((a - b).abs().max())
            assert err <= bar * float(b.abs().max()), (k, what, err)


@pytest.mark.gpu
def test_torsion_term_on_the_card_matches_cpu():
    """`reax.e_4body` without a list through autograd (the kernel's
    gradients carried through the bond order and the box) on the card
    against the plain version on the CPU, float64: each energy within
    1e-12, dE/dpos and dE/dH within 1e-10 of their largest magnitude; one
    launch per call on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    out = {}
    for dev in ("cuda", "cpu"):
        d = _card_deck((1, 1, 1), torch.float64, dev)
        p = d["pos"].clone().requires_grad_(True)
        H = d["H"].clone().requires_grad_(True)
        bo = reax.bond_order(p, H, d["types"], d["img"], d["nbrs"], d["ffd"])
        n0 = tor.launches["torsion"]
        et, ec = reax.e_4body(p, H, d["types"], d["img"], d["nbrs"], bo,
                              d["amask"], d["gid"], d["ffd"],
                              ks=d["caps"]["ks"])
        gp, gh = torch.autograd.grad(et + ec, (p, H))
        assert tor.launches["torsion"] == n0 + (dev == "cuda")
        out[dev] = [t.detach().cpu() for t in (et, ec, gp, gh)]
    (t1, c1, gp1, gh1), (t0, c0, gp0, gh0) = out["cuda"], out["cpu"]
    for a, b in ((t1, t0), (c1, c0)):
        assert abs(float(a - b)) <= 1e-12 * abs(float(b))
    for a, b in ((gp1, gp0), (gh1, gh0)):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


@pytest.mark.gpu
def test_torsion_launches_in_the_ell_step():
    """The pair-list engine with uncached terms (the benchmark's _ell
    cells) launches the kernel in its steps, captured into its graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ff = ffield.parse_ffield(FF)
    st = system.from_cellfile(CELL, ff.name_to_type)
    e = md.Engine(ff, st, config.RunConfig(
        dtype="float32", isQEq=2, term_cache=False, dense_direct_max=0,
        pstep=100), device="cuda")
    assert e.pair_engine == "ell" and e.uses_graphs()
    e.init_velocity(seed=1)
    e.prepare()
    n0 = tor.launches["torsion"]
    e.run(12, log=None)
    torch.cuda.synchronize()
    assert e.timers.counters.get("graph captures", 0) > 0
    assert tor.launches["torsion"] > n0
    assert bool(torch.isfinite(e.comps).all())


@pytest.mark.gpu
def test_torsion_refuses_what_it_does_not_take():
    """A tensor on another device, a wrong dtype or a strided input raise
    before any launch; a center with more candidate bonds than ks raises
    on the exact path as it did before the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    d = _card_deck((1, 1, 1), torch.float32, "cuda")
    tab, (bo0, bopi, drb, delta) = _torsion_inputs(d)
    n0 = tor.launches["torsion"]
    calls = [
        lambda: tor.torsion(bo0, bopi.cpu(), drb, delta, tab),
        lambda: tor.torsion(bo0, bopi.double(), drb, delta, tab),
        lambda: tor.torsion(bo0, bopi, drb.transpose(0, 1).contiguous()
                            .transpose(0, 1), delta, tab),
        lambda: tor.torsion(bo0, bopi, drb, delta,
                            tab._replace(gid=tab.gid.int())),
        lambda: tor.torsion(bo0, bopi, drb, delta,
                            tab._replace(maskb=tab.maskb.byte())),
        lambda: tor.torsion(bo0, bopi, drb, delta, tab._replace(
            nbrs=tab.nbrs._replace(idxb=tab.nbrs.idxb.cpu()))),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="takes a"):
            call()
    with pytest.raises(ValueError, match="float32 or float64"):
        tor.torsion(bo0.half(), bopi.half(), drb.half(), delta.half(), tab)
    bo = reax.bond_order(d["pos"], d["H"], d["types"], d["img"], d["nbrs"],
                         d["ffd"])
    with pytest.raises(RuntimeError, match="many-body candidate overflow"):
        reax.e_4body(d["pos"], d["H"], d["types"], d["img"], d["nbrs"], bo,
                     d["amask"], d["gid"], d["ffd"], ks=2)
    assert tor.launches["torsion"] == n0


# ----------------------------------------------------------------------
# the pair list's nonbond kernel (csrc/nonbond_list.cu) against its plain
# version

def _nonbond_inputs(d, layout):
    """The kernel's inputs from the deck `d` at charges from a seeded
    normal draw of zero sum: the deck as the pair-list engine holds it
    ("images"), or in the sharded engine's layout ("rows": the ext atoms
    as atoms of their own under the identity image, the residents the
    center rows, some dead, the slots' charges gathered per slot)."""
    from rxmd_tpu_torch.ops import nonbond_list as nbl
    dev, dt = d["pos"].device, d["pos"].dtype
    g = torch.Generator().manual_seed(11)
    q = torch.randn(d["pos"].shape[0], generator=g, dtype=torch.float64)
    q = (0.2 * (q - q.mean())).to(dt).to(dev)
    amask = d["amask"].clone()
    if layout == "images":
        return nbl.NonbondInputs(d["pos"], d["H"], d["types"], d["gid"],
                                 amask, d["img"], d["nbrs"], d["ffd"]), q, None
    amask[::7] = False
    img = d["img"]
    own, M = img.owner, img.owner.shape[0]
    pos = neighbors.ext_positions(d["pos"], d["H"], img).contiguous()
    ident = neighbors.ImageTable(owner=torch.arange(M, device=dev),
                                 shift=torch.zeros((M, 3), dtype=dt,
                                                   device=dev),
                                 nimg=(0, 0, 0))
    amask_ext = torch.zeros(M, dtype=torch.bool, device=dev)
    amask_ext[:amask.shape[0]] = amask
    qj = q[own][d["nbrs"].idxnb.clamp(min=0)]
    return nbl.NonbondInputs(pos, d["H"], d["types"][own], d["gid"][own],
                             amask_ext, ident, d["nbrs"], d["ffd"]), q, qj


@pytest.mark.gpu
@pytest.mark.parametrize("with_virial", [True, False], ids=["W", "noW"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mc, layout", [((4, 4, 3), "images"),
                                        ((1, 1, 1), "rows")],
                         ids=["8064", "rows"])
def test_nonbond_list_kernel_matches_plain(mc, layout, dtype, with_virial):
    """The kernel against `nonbond_list_plain` on the same CUDA tensors,
    one launch: each energy within 1e-5 (float32) or 1e-12 (float64) of
    itself, the forces within 1e-4 (1e-11) of their rms and the virial
    within 1e-5 (1e-12) of its largest entry.  Both take the same pairs
    (a pair the two gates could part on sits at the taper's cut, where
    its terms vanish); each pair term is a few ulp apart (the kernel's
    float32 powers, exponential, cube root and divisions are the
    special-function unit's) and the sums run in another order (a warp's
    lanes and then the rows, against PyTorch's reductions over the
    planes): on an H100, ~3e-7 of an energy and ~8e-6 of the forces'
    rms in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from rxmd_tpu_torch.ops import nonbond_list as nbl
    dt = getattr(torch, dtype)
    e_bar, f_bar = (1e-5, 1e-4) if dt == torch.float32 else (1e-12, 1e-11)
    d = _card_deck(mc, dt, "cuda")
    inp, q, qj = _nonbond_inputs(d, layout)
    n0 = nbl.launches["nonbond_list"]
    got = nbl.nonbond_list(inp, q, qj, with_virial)
    ref = nbl.nonbond_list_plain(inp, q, qj, with_virial)
    torch.cuda.synchronize()
    assert nbl.launches["nonbond_list"] == n0 + 1
    for k in (0, 1):
        assert abs(float(ref[k])) > 0
        assert abs(float(got[k] - ref[k])) <= e_bar * abs(float(ref[k])), k
    assert bool(torch.isfinite(got[2]).all())
    rms = float(ref[2].double().pow(2).mean().sqrt())
    assert float((got[2] - ref[2]).abs().max()) <= f_bar * rms
    if layout == "rows":
        dead = ~inp.amask[:inp.nbrs.center_rows]
        assert bool(dead.any()) and float(got[2][dead].abs().max()) == 0.0
    if with_virial:
        err = float((got[3] - ref[3]).abs().max())
        assert err <= e_bar * float(ref[3].abs().max())
    else:
        assert got[3] is None and ref[3] is None


@pytest.mark.gpu
def test_nonbond_list_is_the_pair_list_path(monkeypatch):
    """An MD run of the pair-list engine in float32 (the benchmark's _ell
    cells: closed form, uncached terms, graphs) launches the kernel in its
    steps and blocks and never runs the planes' closed form
    (reax.cf_nonbond); a relax probe of the sweep launches it not at
    all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from rxmd_tpu_torch.ops import nonbond_list as nbl

    def planes(*a, **k):
        raise AssertionError("reax.cf_nonbond ran on the pair list")
    monkeypatch.setattr(reax, "cf_nonbond", planes)
    ff = ffield.parse_ffield(FF)
    st = system.from_cellfile(CELL, ff.name_to_type)
    e = md.Engine(ff, st, config.RunConfig(
        dtype="float32", isQEq=2, term_cache=False, dense_direct_max=0,
        pstep=100), device="cuda")
    assert e.pair_engine == "ell" and e.uses_graphs()
    e.init_velocity(seed=1)
    e.prepare()
    n0 = nbl.launches["nonbond_list"]
    e.run(12, log=None)
    torch.cuda.synchronize()
    assert e.timers.counters.get("graph captures", 0) > 0
    assert nbl.launches["nonbond_list"] > n0
    assert bool(torch.isfinite(e.comps).all())
    monkeypatch.undo()
    sw = md.Engine(ff, system.from_cellfile(CELL, ff.name_to_type),
                   config.RunConfig(dtype="float32", isQEq=1), device="cuda")
    assert sw.pair_engine == "sweep"
    sw.prepare()
    n0 = nbl.launches["nonbond_list"]
    sw.probe(sw.state.pos.clone())
    torch.cuda.synchronize()
    assert nbl.launches["nonbond_list"] == n0


@pytest.mark.gpu
def test_nonbond_list_refuses_what_it_does_not_take():
    """A tensor on another device, a wrong dtype or a strided input raise
    before any launch, and so does LG dispersion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import dataclasses
    from rxmd_tpu_torch.ops import nonbond_list as nbl
    d = _card_deck((1, 1, 1), torch.float32, "cuda")
    inp, q, _ = _nonbond_inputs(d, "images")
    n0 = nbl.launches["nonbond_list"]
    nb = inp.nbrs
    calls = [
        lambda: nbl.nonbond_list(inp._replace(H=inp.H.cpu()), q),
        lambda: nbl.nonbond_list(inp._replace(pos=inp.pos.double()), q),
        lambda: nbl.nonbond_list(inp._replace(gid=inp.gid.int()), q),
        lambda: nbl.nonbond_list(inp._replace(amask=inp.amask.byte()), q),
        lambda: nbl.nonbond_list(inp._replace(
            pos=inp.pos.t().contiguous().t()), q),
        lambda: nbl.nonbond_list(inp._replace(nbrs=nb._replace(
            idxnb=nb.idxnb.t().contiguous().t())), q),
        lambda: nbl.nonbond_list(inp, q[:10]),
        lambda: nbl.nonbond_list(inp, q, q[None, :]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="takes a"):
            call()
    with pytest.raises(ValueError, match="float32 or float64"):
        nbl.nonbond_list(inp, q.half())
    lg = inp._replace(ffd=dataclasses.replace(inp.ffd, is_lg=True))
    with pytest.raises(ValueError, match="LG"):
        nbl.nonbond_list(lg, q)
    assert nbl.launches["nonbond_list"] == n0
