"""`python -m rxmd_tpu_torch` (`__main__.main`) against `python -m rxmd_tpu`
on the 168-atom deck in float64 on the CPU: mdmode 4, 10 steps from
--run_from_xyz, PRINTE every 5 steps, all four frame formats every 5
steps, QEq by full CG at tol 1e-12 (see test_torch_engine.py).

Neither CLI has a flag for `nonbond_closed_form`, nor rxmd_tpu's for
`block_steps`.  In float64 both would take the interpolation-table
nonbond over the pair list, whose CG stops an iteration count apart that
the 10% bar below does not hold (61 against 70 at step 10; the default's
parity is held per step by test_torch_engine_paths.py).  So both
packages' `config.apply_cli` are wrapped (monkeypatch) to set
nonbond_closed_form=True (the port then runs its pair sweep), and to set
block_steps=1, one step per dispatch in both; nothing in either package
changes.  `test_default_block_steps` runs both at their default
block_steps (10), where a block forms at the start (NVE, extended
Lagrangian, PRINTE every 10 of 20 steps), to the same bars.

Bars: the PRINTE numbers and the numbers of every text frame agree to
the printed precision (one unit in the last printed digit, which absorbs
a rounding at a digit boundary), the CG iteration count within 10%; the
final rxff.npz and the .bin frames within 1e-8 (qsfv: see `_bar`).  Then
restarts: the port from its own rxff.npz, and rxmd_tpu from the port's,
to the same bars; mdmode 10; and the error paths.
"""
import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from rxmd_tpu import __main__ as jmain, config as jcfg
from rxmd_tpu_torch import __main__ as tmain, config as tcfg
from rxmd_tpu_torch.io import refbin as trb

# the suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
RXMD_IN = """\
mdmode       4
time         0.25  10
temperature  300.0  0.98  2
io_step      5  5
io_type      T  T  T  T
processors   1  1  1
QEq          1  500  1.0d-12  1
CG_tol       10.0
"""
NPZ_KEYS = ("pos", "vel", "q", "qsfp", "qsfv")
# the packages' own apply_cli, before any fixture wraps it
APPLY_CLI = {"port": tcfg.apply_cli, "jax": jcfg.apply_cli}


def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def _argv(rxmdin, dat, *extra):
    return ["--rxmdin", str(rxmdin), "--ffield", FF, "--outDir", str(dat),
            "--dtype", "float64", *extra]


def _printe(text):
    return [ln.split() for ln in text.splitlines() if ln.startswith("MDstep:")]


def _ulp(tok):
    """One unit in the last printed digit of a numeric token (0 for an
    integer)."""
    mant, _, exp = tok.lower().partition("e")
    dec = len(mant.split(".")[1]) if "." in mant else 0
    if not exp and "." not in mant:
        return 0.0
    return 10.0 ** (int(exp or 0) - dec)


def _same_printe(a, b, where):
    """PRINTE lines to the printed digit, save the last column: the CG
    iteration count, where the two pair engines' summation orders stop
    a tol-1e-12 CG an iteration or a few apart (80 against 83 here)."""
    _same_to_print(a[:-1], b[:-1], where)
    na, nb = int(a[-1]), int(b[-1])
    assert 0 < na <= 500 and abs(na - nb) <= 0.1 * nb, (where, na, nb)


def _same_to_print(a, b, where):
    """Token lists equal, numbers within one unit of the last digit."""
    assert len(a) == len(b), (where, a, b)
    for x, y in zip(a, b):
        if x == y:
            continue
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            raise AssertionError((where, x, y)) from None
        assert abs(fx - fy) <= max(_ulp(x), _ulp(y)) * (1 + 1e-9), \
            (where, x, y)


def _same_text_file(pa, pb):
    with open(pa) as fa, open(pb) as fb:
        la, lb = fa.read().splitlines(), fb.read().splitlines()
    assert len(la) == len(lb), pa
    for k, (x, y) in enumerate(zip(la, lb)):
        _same_to_print(x.split(), y.split(), f"{os.path.basename(pa)}:{k}")


@pytest.fixture(scope="module")
def jax_cli():
    """rxmd_tpu's main with the closed-form nonbond and one step per
    dispatch, and the port's with the closed form (see the module
    docstring)."""
    orig, torig = jcfg.apply_cli, tcfg.apply_cli

    def apply_cli(cfg, args):
        cfg = orig(cfg, args)
        cfg.nonbond_closed_form = True
        cfg.block_steps = 1
        return cfg

    def port_apply_cli(cfg, args):
        cfg = torig(cfg, args)
        cfg.nonbond_closed_form = True
        cfg.block_steps = 1
        return cfg
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcfg, "apply_cli", apply_cli)
        mp.setattr(tcfg, "apply_cli", port_apply_cli)
        yield jmain.main


@pytest.fixture(scope="module")
def first(tmp_path_factory, jax_cli):
    root = tmp_path_factory.mktemp("cli")
    rxmdin = root / "rxmd.in"
    rxmdin.write_text(RXMD_IN)
    runs = {}
    for name, main, kw in (("port", tmain.main, {"device": "cpu"}),
                           ("jax", jax_cli, {})):
        dat = root / name / "DAT"
        rc, out, err = _run(main, _argv(rxmdin, dat, "--run_from_xyz",
                                        CELL), **kw)
        assert rc == 0, err
        runs[name] = dict(dat=dat, out=out)
    # the port's checkpoint as it was after the first run, for rxmd_tpu's
    # restart (the port's own restart overwrites it)
    shutil.copy(root / "port" / "DAT" / "rxff.npz", root / "port.npz")
    return root, rxmdin, runs


def test_printe_lines(first):
    _, _, runs = first
    lp, lj = _printe(runs["port"]["out"]), _printe(runs["jax"]["out"])
    assert len(lp) == len(lj) == 3        # steps 0, 5 and the final 10
    for k, (a, b) in enumerate(zip(lp, lj)):
        _same_printe(a, b, f"PRINTE line {k}")
    assert all(np.isfinite(float(t)) for ln in lp for t in ln[2:])
    assert "rxmd-tpu successfully finished" in runs["port"]["out"]
    assert "trajectory output" in runs["port"]["out"]


def test_header(first):
    _, _, runs = first
    head = [ln for ln in runs["port"]["out"].splitlines()
            if "MDMODE CURRENTSTEP" in ln or "NATOMS" in ln]
    jhead = [ln for ln in runs["jax"]["out"].splitlines()
             if "MDMODE CURRENTSTEP" in ln or "NATOMS" in ln]
    assert head == jhead
    assert head[0].split()[-3:] == ["4", "0", "10"]


def _bar(key):
    """1e-8, except for qsfv: with full-CG QEq the leapfrog sets it to
    Lex_k/dt * (q - qsfp), which carries the charges' difference (CG
    stops at 1e-12) times Lex_k/dt = 391 (dt 0.25 fs in internal units)."""
    return 1e-8 * (391.0 if key == "qsfv" else 1.0)


def test_final_checkpoint(first):
    _, _, runs = first
    with np.load(runs["port"]["dat"] / "rxff.npz") as a, \
            np.load(runs["jax"]["dat"] / "rxff.npz") as b:
        assert int(a["step"]) == int(b["step"]) == 10
        for k in NPZ_KEYS:
            assert np.abs(a[k] - b[k]).max() <= _bar(k), k
        for k in ("types", "gid", "H"):
            assert np.array_equal(a[k], b[k]), k


def test_frames(first):
    _, _, runs = first
    names = sorted(os.listdir(runs["port"]["dat"]))
    assert names == sorted(os.listdir(runs["jax"]["dat"]))
    frames = [f"{s:09d}.{x}" for s in (0, 5)
              for x in ("bin", "bnd", "pdb", "xyz")]
    assert names == sorted(frames + ["rxff.bin", "rxff.npz"])
    for name in frames:
        a, b = runs["port"]["dat"] / name, runs["jax"]["dat"] / name
        if name.endswith(".bin"):
            sa, sb = trb.read_rxff_bin(str(a))[0], trb.read_rxff_bin(str(b))[0]
            assert sa.step == sb.step
            for k in NPZ_KEYS:
                assert float((getattr(sa, k) - getattr(sb, k)).abs().max()) \
                    <= _bar(k), (name, k)
        else:
            _same_text_file(a, b)


@pytest.fixture(scope="module")
def restarts(first, jax_cli):
    root, rxmdin, _ = first
    jdat = root / "jax_restart" / "DAT"
    jdat.mkdir(parents=True)
    shutil.copy(root / "port.npz", jdat / "rxff.npz")
    out = {}
    for name, main, dat, kw in (
            ("port", tmain.main, root / "port" / "DAT", {"device": "cpu"}),
            ("jax", jax_cli, jdat, {})):
        rc, text, err = _run(main, _argv(rxmdin, dat, "--ntime_step", "5"),
                             **kw)
        assert rc == 0, err
        out[name] = text
    return out


def test_restart_from_own_checkpoint(first, restarts):
    """The restart's header says step 10, and its first line carries the
    first run's last state: step, KE, T and the charge sum to the printed
    digit.  Its PE is not the last line's: that one came from the term
    lists cached at the last rebuild (gates slackened, margin 0), the
    restart builds them anew, and this deck forms bonds fast enough that
    the angle, torsion and hbond sums part in the 3rd-4th digit.  Both
    packages print the same restart line (next test)."""
    _, _, runs = first
    text = restarts["port"]
    head = [ln for ln in text.splitlines() if "MDMODE CURRENTSTEP" in ln]
    assert head[0].split()[-3:] == ["4", "10", "5"]
    last = _printe(runs["port"]["out"])[-1]
    start = _printe(text)[0]
    keep = (1, 4, 11, 13)                # step, KE, T, sum q
    _same_to_print([last[k] for k in keep], [start[k] for k in keep],
                   "restart line")
    _same_to_print(last[5:7], start[5:7], "restart Ebond, Elp group")
    with np.load(first[0] / "port" / "DAT" / "rxff.npz") as z:
        assert int(z["step"]) == 15


def test_rxmd_tpu_restarts_from_the_port(restarts):
    lp, lj = _printe(restarts["port"]), _printe(restarts["jax"])
    assert len(lp) == len(lj) == 2        # steps 10 and the final 15
    for k, (a, b) in enumerate(zip(lp, lj)):
        _same_printe(a, b, f"restart PRINTE line {k}")


def test_default_block_steps(tmp_path):
    """Both programs at their default block_steps: PRINTE lines and the
    final checkpoint to the bars of the pinned case, and a block ran in
    each (the port's "MD steps in blocks" counter, rxmd_tpu's "MD block
    (dispatch)" timer in their summaries)."""
    rxmdin = tmp_path / "rxmd.in"
    rxmdin.write_text(RXMD_IN.replace("mdmode       4", "mdmode       1")
                      .replace("0.25  10", "0.25  20")
                      .replace("io_step      5  5", "io_step      20  10")
                      .replace("T  T  T  T", "F  F  F  F")
                      .replace("QEq          1", "QEq          2"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod, main, kw in (("port", tcfg, tmain.main,
                                     {"device": "cpu"}),
                                    ("jax", jcfg, jmain.main, {})):
            def apply_cli(cfg, args, orig=APPLY_CLI[name]):
                cfg = orig(cfg, args)
                cfg.nonbond_closed_form = True
                assert cfg.block_steps == 10
                return cfg
            mp.setattr(mod, "apply_cli", apply_cli)
            dat = tmp_path / name / "DAT"
            rc, out, err = _run(main, _argv(rxmdin, dat, "--run_from_xyz",
                                            CELL), **kw)
            assert rc == 0, err
            runs[name] = dict(dat=dat, out=out)
    lp, lj = _printe(runs["port"]["out"]), _printe(runs["jax"]["out"])
    assert len(lp) == len(lj) == 3        # steps 0, 10 and the final 20
    for k, (a, b) in enumerate(zip(lp, lj)):
        _same_printe(a, b, f"PRINTE line {k}")
    blocks = [ln.split() for ln in runs["port"]["out"].splitlines()
              if "MD steps in blocks" in ln]
    assert blocks and int(blocks[0][-1]) >= 10
    assert "MD block (dispatch)" in runs["jax"]["out"]
    with np.load(runs["port"]["dat"] / "rxff.npz") as a, \
            np.load(runs["jax"]["dat"] / "rxff.npz") as b:
        assert int(a["step"]) == int(b["step"]) == 20
        for k in NPZ_KEYS:
            assert np.abs(a[k] - b[k]).max() <= _bar(k), k


def test_header_under_mdmode0(tmp_path):
    """mdmode 0 runs full-CG QEq (ref: init.F90:56-63) on the engine's copy
    of the RunConfig: the header names isQEq 1, as rxmd_tpu's does, and
    the caller's RunConfig keeps the 2 its rxmd.in gave."""
    rxmdin = tmp_path / "rxmd.in"
    rxmdin.write_text(RXMD_IN.replace("mdmode       4", "mdmode       0")
                      .replace("0.25  10", "0.25  2")
                      .replace("T  T  T  T", "F  F  F  F")
                      .replace("QEq          1", "QEq          2"))
    seen = []

    def apply_cli(cfg, args):
        cfg = APPLY_CLI["port"](cfg, args)
        seen.append(cfg)
        return cfg
    heads = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "apply_cli", apply_cli)
        for name, main, kw in (("port", tmain.main, {"device": "cpu"}),
                               ("jax", jmain.main, {})):
            rc, out, err = _run(main, _argv(rxmdin, tmp_path / name / "DAT",
                                            "--run_from_xyz", CELL), **kw)
            assert rc == 0, err
            heads[name] = [ln for ln in out.splitlines() if any(
                k in ln for k in ("parameter set:", "time step[fs]:",
                                  "MDMODE CURRENTSTEP", "isQEq,QEq_tol",
                                  "NATOMS:"))]
    assert heads["port"] == heads["jax"]
    line = [ln for ln in heads["port"] if "isQEq,QEq_tol" in ln]
    assert line and line[0].split()[1] == "1"
    assert len(seen) == 1 and seen[0].isQEq == 2


def test_structural_optimization(tmp_path):
    """mdmode 10 through main: one CG iteration (CG_tol 10 per atom stops
    after the first), then rxff.npz and rxff.bin of the relaxed state."""
    rxmdin = tmp_path / "rxmd.in"
    rxmdin.write_text(RXMD_IN)
    dat = tmp_path / "DAT"
    rc, out, err = _run(tmain.main, _argv(rxmdin, dat, "--run_from_xyz",
                                          CELL, "--mdmode", "10"),
                        device="cpu")
    assert rc == 0, err
    assert "Energy converged at iter 0" in out
    assert "structural optimization finished" in out
    pe = [float(ln.split("PE=")[1].split()[0]) for ln in out.splitlines()
          if ln.startswith("CG iter")]
    pe0 = float(out.split("PE0=")[1].split()[0])
    assert len(pe) == 1 and pe[0] < pe0
    st, _ = trb.read_rxff_bin(str(dat / "rxff.bin"))
    with np.load(dat / "rxff.npz") as z:
        L = np.diag(z["H"])
        d = st.pos.numpy() - z["pos"]         # the .bin holds wrapped ones
        assert np.abs(d - L * np.round(d / L)).max() <= 1e-9


def test_missing_input(tmp_path):
    rxmdin = tmp_path / "rxmd.in"
    rxmdin.write_text(RXMD_IN)
    rc, out, err = _run(tmain.main, _argv(rxmdin, tmp_path / "DAT"),
                        device="cpu")
    assert rc == 1
    assert err.startswith("ERROR: no input configuration")


def test_unknown_rxmd_in_key(tmp_path):
    rxmdin = tmp_path / "rxmd.in"
    rxmdin.write_text(RXMD_IN + "bogus_key  1\n")
    with pytest.raises(ValueError, match="bogus_key"):
        _run(tmain.main, _argv(rxmdin, tmp_path / "DAT", "--run_from_xyz",
                               CELL), device="cpu")


def test_sharded_runs_raise(tmp_path, monkeypatch):
    """A domain grid needs one process per domain: without the RXMD_*
    launch, with an incomplete one, or with another process count, main
    raises naming the launch."""
    from rxmd_tpu_torch.parallel import dryrun
    rxmdin = tmp_path / "rxmd.in"
    rxmdin.write_text(RXMD_IN)
    argv = _argv(rxmdin, tmp_path / "DAT", "--run_from_xyz", CELL)
    with pytest.raises(RuntimeError, match="launch 2 processes .*"
                       "RXMD_COORDINATOR=host:port RXMD_NUM_PROCESSES=2"):
        tmain.main(argv + ["--vprocs", "2", "1", "1"], device="cpu")
    monkeypatch.setenv("RXMD_COORDINATOR", "localhost:1234")
    with pytest.raises(RuntimeError, match="RXMD_NUM_PROCESSES"):
        tmain.main(argv, device="cpu")
    monkeypatch.setenv("RXMD_COORDINATOR",
                       f"127.0.0.1:{dryrun.free_port()}")
    monkeypatch.setenv("RXMD_NUM_PROCESSES", "1")
    monkeypatch.setenv("RXMD_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="2 domain.* 1 processes were "
                       "launched: launch one process per domain"):
        tmain.main(argv + ["--vprocs", "2", "1", "1"], device="cpu")
    assert not torch.distributed.is_initialized()


def test_default_device_needs_a_card(tmp_path):
    """main() runs on "cuda" unless told otherwise, and never falls back
    to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rxmdin = tmp_path / "rxmd.in"
    rxmdin.write_text(RXMD_IN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(tmain.main, _argv(rxmdin, tmp_path / "DAT", "--run_from_xyz",
                               CELL, "--dtype", "float32"))
