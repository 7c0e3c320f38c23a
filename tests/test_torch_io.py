"""rxmd_tpu_torch's file I/O against rxmd_tpu's, on the 168-atom deck.

* rxff.bin (the reference's restart format), its atype encoding and the
  npz checkpoint: round trips in the port, and files written by either
  package read by the other to equal arrays.
* the .xyz, .pdb and .bnd writers: byte-identical to rxmd_tpu's for the
  same state (the .bnd writers take the same bond table).  The .xyz
  writer formats in C++ (the port's csrc/trajio.cpp, built at first use):
  its bytes are rxmd_tpu's native library's and both packages' Python
  formatting's, for float64 and float32 states, negative zeros, names of
  1-3 characters and appended frames; where C and Python differ (a
  negative NaN, a 4-character name, a type past the names) it is
  rxmd_tpu's native path.  A failing compiler and an unwritable file
  raise.
* the bond table of both engines: the same partners, bond orders within
  1e-10 (float64, the same bond-order expressions in another order).
* geninit: the same three files as rxmd_tpu's geninit.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from rxmd_tpu import config as jcfg, ffield as jff, md as jmd, \
    system as jsys
from rxmd_tpu.io import checkpoint as jck, refbin as jrb, traj as jtr
from rxmd_tpu.tools import geninit as jgeninit
from rxmd_tpu_torch import config as tcfg, ffield as tff, md as tmd, \
    system as tsys
from rxmd_tpu_torch.io import checkpoint as tck, refbin as trb, \
    traj as ttr
from rxmd_tpu_torch.tools import geninit as tgeninit

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
FIELDS = ("pos", "vel", "q", "qsfp", "qsfv", "types", "gid", "H")


@pytest.fixture(scope="module")
def states():
    """The deck with seeded velocities, charges and extended-Lagrangian
    state, at step 37, in both packages."""
    ff = jff.parse_ffield(FF)
    st = jsys.from_cellfile(CELL, ff.name_to_type)
    rng = np.random.default_rng(7)
    n = st.n
    extra = dict(vel=rng.normal(size=(n, 3)), q=rng.normal(scale=0.3, size=n),
                 qsfp=rng.normal(size=n), qsfv=rng.normal(size=n), step=37)
    js = jsys.make_state(np.asarray(st.pos), np.asarray(st.types),
                         np.asarray(st.H), **extra)
    ts = tsys.make_state(np.asarray(st.pos), np.asarray(st.types),
                         np.asarray(st.H), **extra)
    return ff, js, ts


def _np(s):
    return {k: np.asarray(getattr(s, k)) if not isinstance(
        getattr(s, k), torch.Tensor) else getattr(s, k).numpy()
        for k in FIELDS}


def _assert_states_equal(a, b, pos_tol=0.0):
    x, y = _np(a), _np(b)
    for k in FIELDS:
        if k == "pos":
            assert np.abs(x[k] - y[k]).max() <= pos_tol, k
        else:
            assert np.array_equal(x[k], y[k]), k
    assert int(a.step) == int(b.step)


def test_atype_encoding(states):
    rng = np.random.default_rng(1)
    types = rng.integers(0, 4, size=1000)
    gid = rng.integers(0, 2_000_000, size=1000)
    a = trb.encode_atype(types, gid)
    assert np.array_equal(a, jrb.encode_atype(types, gid))
    t, g = trb.decode_atype(a)
    assert np.array_equal(t, types) and np.array_equal(g, gid)
    for x, y in zip((t, g), jrb.decode_atype(a)):
        assert np.array_equal(x, y) and x.dtype == y.dtype


def test_rxff_bin_round_trip(states, tmp_path):
    _, js, ts = states
    path = str(tmp_path / "rxff.bin")
    trb.write_rxff_bin(path, ts)
    back, meta = trb.read_rxff_bin(path)
    assert meta["nprocs"] == 1 and meta["counts"].tolist() == [ts.n]
    # positions pass through fractional coordinates: a few ulp
    _assert_states_equal(ts, back, pos_tol=1e-12)
    # the same bytes as rxmd_tpu's writer
    jpath = str(tmp_path / "jax.bin")
    jrb.write_rxff_bin(jpath, js)
    assert filecmp.cmp(path, jpath, shallow=False)


def test_rxff_bin_rank_slabs(states, tmp_path):
    """vprocs (2,1,1): per-rank slabs of local fractional coordinates,
    x-fastest rank order, read back with each rank's origin added."""
    _, js, ts = states
    path = str(tmp_path / "rxff.bin")
    trb.write_rxff_bin(path, ts, vprocs=(2, 1, 1))
    jpath = str(tmp_path / "jax.bin")
    jrb.write_rxff_bin(jpath, js, vprocs=(2, 1, 1))
    assert filecmp.cmp(path, jpath, shallow=False)
    back, meta = trb.read_rxff_bin(path)
    assert meta["nprocs"] == 2 and meta["vprocs"] == (2, 1, 1)
    assert int(meta["counts"].sum()) == ts.n and (meta["counts"] > 0).all()
    # the slabs reorder the atoms: compare by global id
    order = torch.argsort(back.gid)
    for k in ("vel", "q", "qsfp", "qsfv", "types", "gid"):
        assert torch.equal(getattr(back, k)[order], getattr(ts, k)), k
    assert float((back.pos[order] - ts.pos).abs().max()) <= 1e-12
    jback, _ = jrb.read_rxff_bin(path)
    _assert_states_equal(back, jback)


def test_rxff_bin_across_packages(states, tmp_path):
    _, js, ts = states
    a, b = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jrb.write_rxff_bin(a, js)
    trb.write_rxff_bin(b, ts)
    _assert_states_equal(trb.read_rxff_bin(a)[0], jrb.read_rxff_bin(a)[0])
    _assert_states_equal(jrb.read_rxff_bin(b)[0], trb.read_rxff_bin(b)[0])


def test_checkpoint_round_trip_and_across_packages(states, tmp_path):
    _, js, ts = states
    port, jax_ = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tck.save(port, ts)
    _assert_states_equal(tck.load(port), ts)
    # rxmd_tpu restarts from the port's file; the port writes its spos,
    # zeros for this state without PQEq shells (test_torch_pqeq.py carries
    # relaxed shells across)
    jl = jck.load(port)
    _assert_states_equal(jl, ts)
    assert np.array_equal(np.asarray(jl.spos), np.zeros((ts.n, 3)))
    # and the port from rxmd_tpu's
    jck.save(jax_, js)
    _assert_states_equal(tck.load(jax_), js)
    with np.load(port) as a, np.load(jax_) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k


def test_checkpoint_dtype_and_device(states, tmp_path):
    _, _, ts = states
    path = str(tmp_path / "c.npz")
    tck.save(path, ts)
    s = tck.load(path, dtype=torch.float32)
    assert s.pos.dtype == torch.float32 and s.types.dtype == torch.int64
    assert s.step == 37


@pytest.mark.parametrize("fmt", ["xyz", "pdb"])
def test_text_writers_byte_identical(states, tmp_path, fmt):
    ff, js, ts = states
    a, b = str(tmp_path / f"jax.{fmt}"), str(tmp_path / f"port.{fmt}")
    getattr(jtr, f"write_{fmt}")(a, js, ff.atom_names)
    getattr(ttr, f"write_{fmt}")(b, ts, ff.atom_names)
    assert filecmp.cmp(a, b, shallow=False)


def test_xyz_append_and_read_frames(states, tmp_path):
    ff, _, ts = states
    path = str(tmp_path / "t.xyz")
    ttr.write_xyz(path, ts, ff.atom_names)
    ttr.write_xyz(path, ts, ff.atom_names, append=True)
    frames = list(ttr.read_xyz_frames(path, ff.name_to_type))
    assert len(frames) == 2
    assert np.abs(frames[1]["pos"] - ts.pos.numpy()).max() <= 5e-6
    assert np.array_equal(frames[1]["types"], ts.types.numpy())
    assert np.array_equal(frames[0]["gid"], ts.gid.numpy())
    assert frames[0]["cell"] == pytest.approx(ttr.cell_params(ts.H), abs=5e-6)


# ----------------------------------------------------------------------
# the .xyz writer: the port's csrc/trajio.cpp against rxmd_tpu's native
# library (native/libtrajio.so) and its Python formatting

XYZ_CASES = ("float64", "float32", "negative_zero", "names_1_to_3", "append")


def _xyz_case(ff, ts, case):
    """(port state, rxmd_tpu state, atom names) of an .xyz case: the deck
    with seeded charges in float64 or float32; negative zeros (and values
    that print as -0.00000) in positions and charges; names of 1, 2 and 3
    characters."""
    import jax.numpy as jnp
    pos, q = ts.pos.numpy().copy(), ts.q.numpy().copy()
    types, H = ts.types.numpy(), ts.H.numpy()
    names = list(ff.atom_names)
    if case == "negative_zero":
        pos[:4, 0], q[:4] = -0.0, -0.0
        pos[4:8, 1], q[4:8] = -1e-7, -1e-5
    if case == "names_1_to_3":
        names = [("H", "Cx", "Nit")[k % 3] for k in range(len(names))]
    f32 = case == "float32"
    t = tsys.make_state(pos, types, H, q=q,
                        dtype=torch.float32 if f32 else torch.float64)
    j = jsys.make_state(pos, types, H, q=q,
                        dtype=jnp.float32 if f32 else jnp.float64)
    return t, j, names


@pytest.mark.parametrize("case", XYZ_CASES)
def test_xyz_native_bytes(states, tmp_path, monkeypatch, case):
    """The port's native bytes equal rxmd_tpu's native bytes and its Python
    bytes (rxmd_tpu's `_NATIVE` switched off by a monkeypatch), and the
    port's plain formatting's; with `append`, two frames in one file."""
    ff, _, ts = states
    t, j, names = _xyz_case(ff, ts, case)
    frames = 2 if case == "append" else 1
    paths = {k: str(tmp_path / f"{k}.xyz")
             for k in ("port", "port_plain", "jax", "jax_plain")}
    for k in range(frames):
        kw = dict(append=k > 0)
        ttr.write_xyz(paths["port"], t, names, **kw)
        ttr.write_xyz_plain(paths["port_plain"], t, names, **kw)
        assert jtr._native()
        jtr.write_xyz(paths["jax"], j, names, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(jtr, "_NATIVE", False)
            jtr.write_xyz(paths["jax_plain"], j, names, **kw)
    for k in ("port_plain", "jax", "jax_plain"):
        assert filecmp.cmp(paths["port"], paths[k], shallow=False), k
    text = open(paths["port"]).read()
    assert text.count("\n") == frames * (ts.n + 2)
    if case == "negative_zero":
        assert "-0.00000" in text and "  -0.000" in text
    if case == "names_1_to_3":
        assert "\nH  " in text and "\nCx " in text


def test_xyz_native_and_plain_differ_where_c_and_python_do(states,
                                                           tmp_path):
    """Where C and Python format differently, the port's native path is
    rxmd_tpu's native path and its plain path rxmd_tpu's Python path: a
    negative NaN ("-nan" against "nan"), a name of 4 characters (cut to 3
    in C) and a type past the name table (type 0 in C, an IndexError in
    Python)."""
    ff, _, ts = states
    q = ts.q.numpy().copy()
    q[0] = -np.nan
    t = tsys.make_state(ts.pos.numpy(), ts.types.numpy(), ts.H.numpy(), q=q)
    j = jsys.make_state(ts.pos.numpy(), ts.types.numpy(), ts.H.numpy(), q=q)
    names = ["Hxyz"] + list(ff.atom_names[1:])
    paths = {k: str(tmp_path / f"{k}.xyz") for k in ("port", "plain", "jax")}
    ttr.write_xyz(paths["port"], t, names)
    ttr.write_xyz_plain(paths["plain"], t, names)
    jtr.write_xyz(paths["jax"], j, names)
    assert filecmp.cmp(paths["port"], paths["jax"], shallow=False)
    native, plain = open(paths["port"]).read(), open(paths["plain"]).read()
    assert "-nan" in native and "-nan" not in plain and "nan" in plain
    assert "Hxy" in native and "Hxyz" not in native and "Hxyz" in plain
    bad = tsys.make_state(ts.pos.numpy(), np.full(ts.n, len(names) + 2),
                          ts.H.numpy())
    ttr.write_xyz(paths["port"], bad, names)
    first = open(paths["port"]).read().splitlines()[2]
    assert first.startswith(names[0][:3])
    with pytest.raises(IndexError):
        ttr.write_xyz_plain(paths["plain"], bad, names)


def test_xyz_native_build(monkeypatch, tmp_path, states):
    """The library is built from csrc/trajio.cpp into build/rxmd_tpu_torch
    (keyed by the source, compiler and flags); a compiler that fails
    raises with its message, and a file that cannot be opened raises."""
    so = ttr.build()
    assert os.path.dirname(so).endswith(os.path.join("build",
                                                      "rxmd_tpu_torch"))
    assert os.path.basename(so).startswith("libtrajio_")
    ff, _, ts = states
    monkeypatch.setattr(ttr, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        ttr.write_xyz(str(tmp_path / "x.xyz"), ts, ff.atom_names)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        ttr.build()
    monkeypatch.delenv("CXX")
    with pytest.raises(OSError, match="could not write"):
        ttr.write_xyz(str(tmp_path / "no-dir" / "x.xyz"), ts, ff.atom_names)


@pytest.fixture(scope="module")
def engines(states):
    ff, js, ts = states
    je = jmd.Engine(ff, js, jcfg.RunConfig(dtype="float64", block_steps=1,
                                           nonbond_closed_form=True))
    te = tmd.Engine(tff.parse_ffield(FF), ts, tcfg.RunConfig(block_steps=1),
                    device="cpu")
    return je, te


def test_bond_table(engines):
    je, te = engines
    jg, jb, jc = (np.asarray(x) for x in je.bond_table())
    tg, tb, tc = (x.numpy() for x in te.bond_table())
    assert np.array_equal(jc, tc) and tc.sum() > 0
    for i in range(te.state.n):
        k = int(tc[i])
        assert sorted(jg[i, :k]) == sorted(tg[i, :k]), i
        assert np.array_equal(jg[i, :k], tg[i, :k]), i
    assert np.abs(jb - tb).max() <= 1e-10
    assert (tb[tg >= 0] > 0.3).all()


def test_bnd_writer_byte_identical(states, engines, tmp_path):
    _, js, ts = states
    _, te = engines
    g, b, c = (x.numpy() for x in te.bond_table())
    a, p = str(tmp_path / "jax.bnd"), str(tmp_path / "port.bnd")
    jtr.write_bnd(a, js, g, b, c)
    ttr.write_bnd(p, ts, g, b, c)
    assert filecmp.cmp(a, p, shallow=False)


def test_write_frame(states, engines, tmp_path):
    """Engine.write_frame writes each configured format."""
    ff, _, _ = states
    _, te = engines
    cfg = te.cfg
    old = (cfg.is_xyz, cfg.is_pdb, cfg.is_bondfile, cfg.is_binary)
    cfg.is_xyz = cfg.is_pdb = cfg.is_bondfile = cfg.is_binary = True
    try:
        te.write_frame(str(tmp_path / "000000037"))
    finally:
        cfg.is_xyz, cfg.is_pdb, cfg.is_bondfile, cfg.is_binary = old
    names = sorted(os.listdir(tmp_path))
    assert names == [f"000000037.{x}" for x in ("bin", "bnd", "pdb", "xyz")]
    st, _ = trb.read_rxff_bin(str(tmp_path / "000000037.bin"))
    assert st.step == 37 and st.n == te.state.n


def test_geninit_matches_rxmd_tpu(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    argv = ["-i", CELL, "-f", FF, "-mc", "1", "2", "1", "-vprocs", "2", "1",
            "1"]
    assert jgeninit.main(argv + ["-o", str(a)]) == 0
    assert tgeninit.main(argv + ["-o", str(b)]) == 0
    for name in ("rxff.bin", "geninit.xyz"):
        assert filecmp.cmp(a / name, b / name, shallow=False), name
    with np.load(a / "rxff.npz") as x, np.load(b / "rxff.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    st, meta = trb.read_rxff_bin(str(b / "rxff.bin"))
    assert st.n == 336 and meta["vprocs"] == (2, 1, 1)
