"""The program under PQEq and LG, and the analysis tools: rxmd_tpu_torch
against rxmd_tpu in float64 on the CPU.

`python -m rxmd_tpu_torch` (`__main__.main`, device="cpu") and `python -m
rxmd_tpu` on the 168-atom cell from --run_from_xyz, with `PQEqParm` in
rxmd.in and `--lg` on the LG force field: NVE, 10 steps, full-CG PQEq
capped at 8 iterations (the CG amplifies summation-order rounding, see
test_torch_pairpath.py), PRINTE every 5 steps, xyz and bnd frames every
5.  rxmd_tpu's `config.apply_cli` is wrapped (monkeypatch) to run one step
per dispatch (a fused block moves its list rebuilds); nothing in either
package changes.  Bars: the PRINTE lines to the printed digit (one unit
in the last printed digit absorbs a rounding at a digit boundary) with
the same CG counts, and the final rxff.npz within 1e-8, shells included.

The tools (`tools.stat`, `tools.plot`, `tools.bondlifetime`) on the
in-repo cell and on the port's own .bnd frames of that run: the same
numbers as rxmd_tpu's, and the files they write byte-identical (plot's
numpy parts: `read_table`, `to_csv`, `write_ba_dat`).
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from rxmd_tpu import __main__ as jmain, config as jcfg
from rxmd_tpu.tools import bondlifetime as jbl, plot as jplot, stat as jstat
from rxmd_tpu_torch import __main__ as tmain, config as tcfg, ffield as tff, \
    system as tsys
from rxmd_tpu_torch.tools import bondlifetime as tbl, plot as tplot, \
    stat as tstat

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF_LG = os.path.join(DATA, "ffield_chon_synth_lg")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
RXMD_IN = f"""\
mdmode       1
time         0.25  10
temperature  300.0  1.0  100
io_step      5  5
io_type      F  T  F  T
processors   1  1  1
QEq          1  8  1.0d-12  1
PQEqParm     {PAR}
"""
NPZ_KEYS = ("pos", "vel", "q", "qsfp", "spos")


def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def _ulp(tok):
    """One unit in the last printed digit of a numeric token."""
    mant, _, exp = tok.lower().partition("e")
    dec = len(mant.split(".")[1]) if "." in mant else 0
    if not exp and "." not in mant:
        return 0.0
    return 10.0 ** (int(exp or 0) - dec)


def _printe(text):
    return [ln.split() for ln in text.splitlines() if ln.startswith("MDstep:")]


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    root = tmp_path_factory.mktemp("pqeq_lg")
    rxmdin = root / "rxmd.in"
    rxmdin.write_text(RXMD_IN)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        # one step per dispatch in both programs
        for mod in (jcfg, tcfg):
            def apply_cli(cfg, args, orig=mod.apply_cli):
                cfg = orig(cfg, args)
                cfg.block_steps = 1
                return cfg
            mp.setattr(mod, "apply_cli", apply_cli)
        for name, main, kw in (("port", tmain.main, {"device": "cpu"}),
                               ("jax", jmain.main, {})):
            dat = root / name / "DAT"
            rc, out, err = _run(main, [
                "--rxmdin", str(rxmdin), "--ffield", FF_LG, "--lg",
                "--outDir", str(dat), "--dtype", "float64",
                "--run_from_xyz", CELL], **kw)
            assert rc == 0, err
            runs[name] = dict(dat=dat, out=out)
    return runs


def test_program_printe_lines(program):
    lp, lj = _printe(program["port"]["out"]), _printe(program["jax"]["out"])
    assert len(lp) == len(lj) == 3        # steps 0, 5 and the final 10
    for k, (a, b) in enumerate(zip(lp, lj)):
        assert len(a) == len(b) and a[-1] == b[-1] == "8", (k, a, b)
        for x, y in zip(a, b):
            if x != y:
                assert abs(float(x) - float(y)) <= max(_ulp(x), _ulp(y)) * (
                    1 + 1e-9), (k, x, y)
    out = program["port"]["out"]
    assert "charges PQEq full CG; LG dispersion" in out
    assert "rxmd-tpu successfully finished" in out


def test_program_checkpoint(program):
    with np.load(program["port"]["dat"] / "rxff.npz") as a, \
            np.load(program["jax"]["dat"] / "rxff.npz") as b:
        assert int(a["step"]) == int(b["step"]) == 10
        for k in NPZ_KEYS:
            assert np.abs(a[k] - b[k]).max() <= 1e-8, k
        assert np.abs(a["spos"]).max() > 0


# ---------------------------------------------------------------------------
# the tools

def _cell():
    tf = tff.parse_ffield(FF_LG, lg=True)
    st = tsys.from_cellfile(CELL, tf.name_to_type)
    return (st.pos.numpy(), st.types.numpy(), np.diag(st.H.numpy()),
            tf.atom_names[:4])


def test_stat_pair_analysis(tmp_path):
    pos, types, box, names = _cell()
    res = {}
    for pkg in (jstat, tstat):
        pa = pkg.PairAnalysis(names, rcut=8.0, dr=0.05, qmax=12.0)
        pa.add_frame(pos, types, box)
        pa.add_frame(pos + 0.01, types, box)
        d = tmp_path / pkg.__name__
        d.mkdir()
        res[pkg] = (pa.save(str(d / "gr.dat"), str(d / "sq.dat")), d)
    (rj, dj), (rt, dt) = res[jstat], res[tstat]
    for k in rj:
        assert np.array_equal(rj[k], rt[k]), k
    for f in ("gr.dat", "sq.dat"):
        assert (dj / f).read_bytes() == (dt / f).read_bytes(), f
    # a C-H bond peak below 1.3 A
    assert rt["r"][np.argmax(rt["gr"][1, 0])] < 1.3
    i, j, r = tstat.pair_distances(pos, box, 5.0)
    assert all(np.array_equal(a, b) for a, b in zip(
        (i, j, r), jstat.pair_distances(pos, box, 5.0)))


def test_bond_angles_and_plot_tables(tmp_path):
    pos, types, box, names = _cell()
    rcuts = {(a, b): 1.8 for a in range(4) for b in range(4)}
    hj = jstat.bond_angle_distribution(pos, types, box, rcuts)
    ht = tstat.bond_angle_distribution(pos, types, box, rcuts)
    assert sorted(hj) == sorted(ht) and len(ht) > 3
    for key in hj:
        assert np.array_equal(hj[key], ht[key]), key
    a = jplot.write_ba_dat(hj, names, str(tmp_path / "ba-j.dat"))
    b = tplot.write_ba_dat(ht, names, str(tmp_path / "ba-t.dat"))
    assert open(a, "rb").read() == open(b, "rb").read()
    hj_, dj = jplot.read_table(a)
    ht_, dt = tplot.read_table(b)
    assert hj_ == ht_ and np.array_equal(dj, dt)
    ca = jplot.to_csv(a, str(tmp_path / "j.csv"))
    cb = tplot.to_csv(b, str(tmp_path / "t.csv"))
    assert open(ca, "rb").read() == open(cb, "rb").read()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tplot.main(["--csv", b])
    assert out.getvalue().strip() == b + ".csv"
    assert open(b + ".csv", "rb").read() == open(cb, "rb").read()


def test_bond_lifetime_on_port_frames(program):
    pattern = str(program["port"]["dat"] / "*.bnd")
    paths = sorted(str(p) for p in program["port"]["dat"].glob("*.bnd"))
    assert len(paths) == 2                # steps 0 and 5
    for p in paths:
        assert jbl.read_bnd(p) == tbl.read_bnd(p)
    lj, nj = jbl.bond_lifetime(paths, 0.5)
    lt, nt = tbl.bond_lifetime(paths, 0.5)
    assert lj == lt and nj == nt == 2 and len(lt) > 100
    outs = []
    for pkg in (jbl, tbl):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert pkg.main([pattern, "0.5"]) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
