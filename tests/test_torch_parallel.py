"""rxmd_tpu_torch.parallel (comm, halo, the engine's setup) against
rxmd_tpu.parallel, on the CPU over gloo.

Ranks are processes spawned by the port's launcher (`dryrun.launch`, one
torch thread each, a join timeout per test, every rank checking that it
imported neither jax nor rxmd_tpu); rxmd_tpu runs in this process under
jax.shard_map on conftest's 8 virtual CPU devices.

  * factor_mesh and distribute: equal to rxmd_tpu's;
  * halo plans on 1, 2 and 8 ranks (meshes (1,1,1), (2,1,1), (2,2,2)):
    sel, shift, both counts, the ghosts' fractional coordinates and
    validity equal entry for entry; the gradient of sum(w * apply_plan(x))
    (the ghost-force copy-back) within 1e-12 of jax.grad; psum and pmax
    bitwise equal on every rank;
  * migration on 2 ranks, and its overflow trap raising on every rank;
  * one step on 8 ranks, mesh (2,2,2), at rxmd_tpu's reduced knobs (rctap
    5 A, one bonded ghost layer; tests/test_parallel.py:53-70): the atom
    count holds, energies and forces finite;
  * the dry run's float32 branch (`dryrun.run`, which chip_smoke launches
    over NCCL on two or more cards) on 2 ranks;
  * the caller's ForceField after PQEq engines (ROADMAP §3);
  * the CG optimizer on two ranks against md.Engine's;
  * `python -m rxmd_tpu_torch` as two processes (the RXMD_* launch)
    against one, MD and mdmode 10.
The engine's per-step parity is test_torch_sharded.py's.
"""
import contextlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from rxmd_tpu import ffield as jff, system as jsys
from rxmd_tpu.parallel import engine as jeng, halo as jhalo
from rxmd_tpu_torch import __main__ as tmain, config as tcfg, \
    ffield as tff, md as tmd, opt as topt, system as tsys
from rxmd_tpu_torch.parallel import dryrun, engine as teng

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FF = os.path.join(DATA, "ffield_chon_synth")
CELL = os.path.join(DATA, "chon168.xyz")
PAR = os.path.join(DATA, "pqeq_chon.par")
TIMEOUT = 240.0


def _ulp(tok):
    """One unit in the last printed digit of a numeric token."""
    mant, _, exp = tok.lower().partition("e")
    dec = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - dec)


def same_printe(la, lb):
    """Two PRINTE lines: the same step and CG count, each number within one
    unit of its last printed digit (a rounding at a digit boundary; -0.00
    equals 0.00)."""
    ta, tb = la.split(), lb.split()
    assert ta[:2] == tb[:2] and ta[-1] == tb[-1], (la, lb)
    for x, y in zip(ta[2:-1], tb[2:-1]):
        assert abs(float(x) - float(y)) <= 1.01 * _ulp(y), (la, lb)


def test_factor_mesh_and_distribute():
    for n in (1, 2, 3, 4, 6, 8, 12):
        assert teng.factor_mesh(n) == jeng.factor_mesh(n)
    ff = jff.parse_ffield(FF)
    js = jsys.from_cellfile(CELL, ff.name_to_type, mc=(2, 2, 2))
    ts = tsys.from_cellfile(CELL, ff.name_to_type, mc=(2, 2, 2))
    for mesh in ((2, 1, 1), (1, 2, 1), (2, 2, 2)):
        ncap = 1344 // int(np.prod(mesh)) + 64
        jd = jeng.distribute(js, mesh, ncap)
        td = teng.distribute(ts, mesh, ncap)
        for f in teng.FIELDS:
            a, b = np.asarray(getattr(jd, f)), getattr(td, f).numpy()
            assert a.shape == b.shape, f
            assert np.array_equal(a, b), (mesh, f)


def _global_layout(mesh, ncap, seed):
    """Random atoms in [0,1)^3 binned into the mesh's blocks, a few
    residents pushed just past their domain's faces (the drift the
    one-sided bound keeps), padded to ncap."""
    rng = np.random.default_rng(seed)
    ndev = int(np.prod(mesh))
    n = 40 * ndev
    frac = rng.random((n, 3))
    cell = np.minimum((frac * mesh).astype(int), np.array(mesh) - 1)
    lin = (cell[:, 0] * mesh[1] + cell[:, 1]) * mesh[2] + cell[:, 2]
    fb = np.zeros((ndev * ncap, 3))
    vb = np.zeros(ndev * ncap, bool)
    for d in range(ndev):
        sel = np.where(lin == d)[0]
        fb[d * ncap:d * ncap + len(sel)] = frac[sel]
        vb[d * ncap:d * ncap + len(sel)] = True
    drift = rng.random(fb.shape) < 0.05
    fb = np.where(vb[:, None] & drift, fb + 0.004 * np.sign(fb - 0.5), fb)
    return fb, vb


def _jax_halo(fb, vb, wb, mesh, skin, ncap, bcap):
    devs = np.array(jax.devices()[:int(np.prod(mesh))]).reshape(mesh)
    jm = Mesh(devs, ("x", "y", "z"))
    spec = jhalo.HaloSpec(("x", "y", "z"), tuple(mesh), tuple(skin), ncap,
                          bcap)

    def f(frac, valid, w):
        plan, fe, ve = jhalo.build_plan(frac, valid, spec)
        g = jax.grad(lambda x: jnp.sum(w * jhalo.apply_plan(
            plan, x, spec, is_frac=True)))(frac)
        return (plan.sel, plan.shift, plan.cnt_send, plan.cnt_recv, fe, ve,
                g)

    spx = P(("x", "y", "z"))
    out = jax.jit(jax.shard_map(f, mesh=jm, in_specs=(spx,) * 3,
                                out_specs=(spx,) * 7))(
        jnp.asarray(fb), jnp.asarray(vb), jnp.asarray(wb))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("mesh", [(1, 1, 1), (2, 1, 1), (2, 2, 2)])
def test_halo_plans_match_rxmd_tpu(mesh):
    ncap, bcap = 96, 160
    skin = (0.27, 0.31, 0.29)
    ndev = int(np.prod(mesh))
    fb, vb = _global_layout(mesh, ncap, seed=ndev)
    mext = ncap + 6 * bcap
    wb = np.random.default_rng(7).normal(size=(ndev * mext, 3))
    j = _jax_halo(fb, vb, wb, mesh, skin, ncap, bcap)
    recs = dryrun.launch(ndev, dryrun.halo_case, fb, vb, wb, mesh, skin,
                         ncap, bcap, timeout=TIMEOUT)
    assert max(int(j[2].max()), 1) <= bcap      # no ghost buffer overflow
    for r, t in enumerate(recs):
        six = slice(6 * r, 6 * (r + 1))
        ext = slice(r * mext, (r + 1) * mext)
        assert np.array_equal(t["sel"], j[0][six]), r
        assert np.array_equal(t["shift"], j[1][six]), r
        assert np.array_equal(t["cnt_send"], j[2][six]), r
        assert np.array_equal(t["cnt_recv"], j[3][six]), r
        assert np.array_equal(t["frac_ext"], j[4][ext]), r
        assert np.array_equal(t["valid_ext"], j[5][ext]), r
        assert np.array_equal(t["y"], j[4][ext]), r
        g = j[6][r * ncap:(r + 1) * ncap]
        assert np.abs(t["grad"] - g).max() <= 1e-12 * np.abs(g).max(), r
        # an integer field rides the same plan: ghosts carry their
        # owners' (rank, row) ids
        live = t["valid_ext"]
        assert np.array_equal(t["ids"][:ncap], np.arange(ncap) + 1000 * r)
        assert (t["ids"][live] >= 0).all()
        assert np.array_equal(t["psum"], recs[0]["psum"])
        assert np.array_equal(t["pmax"], recs[0]["pmax"])
    v = np.stack([np.random.default_rng(r).normal(size=7)
                  for r in range(ndev)])
    assert np.allclose(recs[0]["psum"], v.sum(0), rtol=1e-14, atol=0)
    assert np.array_equal(recs[0]["pmax"], v.max(0))


def test_migration_and_its_overflow_trap():
    """Every atom moved a quarter box along x, then a rebuild on 2 ranks:
    with room (mcap 128) each atom lands in its new domain with its id and
    position; with mcap 4 more atoms cross a face than the buffer holds
    and every rank raises (the reference aborts too, comm.F90:467-472)."""
    for r in dryrun.launch(2, dryrun.migration, (2, 1, 1), 128, 0.25,
                           timeout=TIMEOUT):
        assert r["err"] is None and r["n_atoms"] == 168 and r["inside"]
        assert np.array_equal(r["gid"][:, 0], np.arange(168))
        d = np.abs(r["frac"] - r["frac0"])
        assert np.minimum(d, 1.0 - d).max() <= 1e-12
    for r in dryrun.launch(2, dryrun.migration, (2, 1, 1), 4, 0.25,
                           timeout=TIMEOUT):
        m = r["err"]
        assert m is not None and "migration buffer overflow" in m \
            and "mcap=4" in m, m


def test_eight_ranks_reduced_step():
    recs = dryrun.launch(8, dryrun.reduced_step, (2, 2, 2), 1,
                         timeout=TIMEOUT)
    for r in recs:
        assert r["n_atoms"] == 168
        assert np.isfinite(r["pe"]) and np.isfinite(r["ke"]) and r["finite"]
    assert len({r["pe"] for r in recs}) == 1


def test_dryrun_float32_two_ranks(capsys):
    """dryrun.run in float32 on 2 gloo ranks at mc (2,2,2): prepare and one
    step, the total PE within 1e-4 of md.Engine's, no atom lost."""
    err, rec, ref = dryrun.run(2, "cpu", dtype="float32", timeout=TIMEOUT)
    assert err <= 1e-4 and rec["mesh"] == (2, 1, 1)
    assert rec["n_atoms"] == ref["pos"].shape[0] == 1344
    assert rec["comps"].shape == ref["comps"].shape == (2, 14)
    assert "dryrun: 2 ranks, mesh (2, 1, 1), cpu" in capsys.readouterr().out


def test_forcefield_kept_by_pqeq_engines():
    """ROADMAP §3: a PQEq md.Engine and a PQEq ShardedEngine leave the
    caller's ForceField's chi and eta as parsed (rxmd_tpu writes PQEq's
    into it); a QEq engine built from it then matches one built from a
    fresh parse within 1e-12."""
    ff = tff.parse_ffield(FF)
    chi, eta = ff.chi.copy(), ff.eta.copy()
    st = tsys.from_cellfile(CELL, ff.name_to_type)
    pq = dict(isPQEq=True, pqeq_parm_path=PAR, isQEq=1, NMAXQEq=4)
    tmd.Engine(ff, st, tcfg.RunConfig(**pq), device="cpu")
    assert np.array_equal(ff.chi, chi) and np.array_equal(ff.eta, eta)
    se = teng.ShardedEngine(ff, st, tcfg.RunConfig(**pq), device="cpu")
    assert se.pq is not None and not np.array_equal(se.ff.eta, eta)
    assert np.array_equal(ff.chi, chi) and np.array_equal(ff.eta, eta)
    qeq = dict(isQEq=1, NMAXQEq=8)
    a = tmd.Engine(ff, st, tcfg.RunConfig(**qeq), device="cpu").prepare()
    b = tmd.Engine(tff.parse_ffield(FF), st, tcfg.RunConfig(**qeq),
                   device="cpu").prepare()
    a, b = a.numpy(), b.numpy()
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


def test_optimizer_two_ranks(monkeypatch):
    """opt.conjugate_gradient, one iteration, on mesh (2,1,1) (the (2,1,1)
    replica, 336 atoms) against md.Engine's under the same probe bound:
    the sharded adapter lets no probe move an atom more than half the
    Verlet skin (rxmd_tpu opt.py:67-90), so the single-device adapter is
    given that bound too.  The PE sequence within 1e-8 relative, positions
    within 1e-6 A (periodic), charges within 1e-7."""
    mc = (2, 1, 1)
    cfg = dict(dtype="float64", isQEq=1, NMAXQEq=4, QEq_tol=1e-14)
    recs = dryrun.launch(2, dryrun.optimize, mc, cfg, (2, 1, 1), 1,
                         timeout=TIMEOUT)
    ff = tff.parse_ffield(FF)
    st = tsys.from_cellfile(CELL, ff.name_to_type, mc=mc)
    run_cfg = tcfg.RunConfig(pair_kernel=False, dense_direct_max=0,
                             qeq_dense_max=0, **cfg)
    monkeypatch.setattr(topt._MDAdapter, "drift_limit",
                        0.5 * run_cfg.nbr_skin)
    e = tmd.Engine(ff, st, run_cfg, device="cpu")
    pes, lines = [], []
    pe = topt.conjugate_gradient(e, max_iter=1, log=lines.append,
                                 writer=lambda it, pos, p: pes.append(p))
    a = recs[0]
    seq_a = [a["pe0"]] + a["pes"]
    seq_b = [float(lines[0].split("PE0=")[1])] + pes
    assert len(seq_a) == len(seq_b) == 2
    assert np.abs(np.array(seq_a) - seq_b).max() <= 1e-8 * abs(seq_b[0])
    assert seq_b[-1] < seq_b[0] and a["pe"] == seq_a[-1] and pe == seq_b[-1]
    L = np.diag(st.H.numpy())
    d = np.abs(a["pos"] - (e.state.pos.numpy() % L))
    assert np.minimum(d, L - d).max() <= 1e-6
    assert np.abs(a["q"] - e.state.q.numpy()).max() <= 1e-7
    assert recs[1]["pes"] == a["pes"]


RXMD_IN = """\
mdmode       0
time         0.25  4
temperature  300.0  0.98  2
io_step      2  2
io_type      T  F  F  T
processors   {p}  1  1
QEq          1  8  1.0d-14  1
CG_tol       10.0
"""
CHILD = ("import sys, torch; torch.set_num_threads(1); "
         "from rxmd_tpu_torch.__main__ import main; "
         "rc = main(sys.argv[1:], device='cpu'); "
         "assert 'jax' not in sys.modules and 'rxmd_tpu' not in sys.modules; "
         "sys.exit(rc)")


def _launch_cli(n, argv, cwd):
    port = dryrun.free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RXMD_COORDINATOR=f"127.0.0.1:{port}",
                   RXMD_NUM_PROCESSES=str(n), RXMD_PROCESS_ID=str(r),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, *argv], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    return outs


def _printe(text):
    return [ln for ln in text.splitlines() if ln.startswith("MDstep:")]


def test_program_two_processes(tmp_path):
    """`python -m rxmd_tpu_torch` as two gloo processes (processors 2 1 1,
    the RXMD_* launch) against one process: the same PRINTE lines, the
    same final rxff.npz within 1e-8 (positions modulo the box), the same
    xyz frames (slab-written); then mdmode 10 across the two.  mdmode 0
    draws velocities (again at step 2) in global-id order in both; from
    rest the capped CG would iterate on converged charges, whose rounding
    it amplifies step by step.  The one
    process runs its CG on the pair list too (qeq_dense_max=0, which no
    rxmd.in key sets, hence the wrapped apply_cli): its dense fold sums
    in another order, which the capped CG from a cold start carries far
    past the bar within four steps."""
    orig = tcfg.apply_cli

    def ell_cg(cfg, args):
        cfg = orig(cfg, args)
        cfg.qeq_dense_max = 0
        return cfg
    runs = {}
    for p in (1, 2):
        rxmdin = tmp_path / f"rxmd{p}.in"
        rxmdin.write_text(RXMD_IN.format(p=p))
        dat = tmp_path / f"DAT{p}"
        argv = ["--rxmdin", str(rxmdin), "--ffield", FF, "--outDir",
                str(dat), "--run_from_xyz", CELL, "--mc", "2", "1", "1"]
        if p == 1:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    pytest.MonkeyPatch.context() as mp:
                mp.setattr(tcfg, "apply_cli", ell_cg)
                assert tmain.main(argv, device="cpu") == 0
            out = buf.getvalue()
        else:
            outs = _launch_cli(2, argv, str(tmp_path))
            out = outs[0][1]
            assert outs[1][1] == ""            # rank 0 alone prints
            assert "engine: sharded, mesh (2, 1, 1)" in out
        runs[p] = dict(dat=dat, out=out, argv=argv)
    with np.load(runs[1]["dat"] / "rxff.npz") as a, \
            np.load(runs[2]["dat"] / "rxff.npz") as b:
        assert int(a["step"]) == int(b["step"]) == 4
        L = np.diag(a["H"])
        d = np.abs((a["pos"] % L) - b["pos"])
        assert np.minimum(d, L - d).max() <= 1e-8
        for k in ("vel", "q", "qsfp"):
            assert np.abs(a[k] - b[k]).max() <= 1e-8, k
        for k in ("types", "gid", "H"):
            assert np.array_equal(a[k], b[k]), k
    pa, pb = _printe(runs[1]["out"]), _printe(runs[2]["out"])
    assert len(pa) == len(pb) == 3          # steps 0, 2 and the last (4)
    for la, lb in zip(pa, pb):
        same_printe(la, lb)
    for step in (0, 2):
        fa = (runs[1]["dat"] / f"{step:09d}.xyz").read_text().splitlines()
        fb = (runs[2]["dat"] / f"{step:09d}.xyz").read_text().splitlines()
        assert len(fa) == len(fb) == 338 and fa[:2] == fb[:2]
        for la, lb in zip(fa[2:], fb[2:]):
            ta, tb = la.split(), lb.split()
            assert ta[0] == tb[0] and ta[-1] == tb[-1]
            # one unit of the last printed digit: coordinates 12.5f, q 8.3f
            assert np.allclose([float(x) for x in ta[1:4]],
                               [float(x) for x in tb[1:4]], rtol=0,
                               atol=1.01e-5)
            assert abs(float(ta[4]) - float(tb[4])) <= 1.01e-3
    outs = _launch_cli(2, runs[2]["argv"] + ["--mdmode", "10"],
                       str(tmp_path))
    assert "structural optimization finished" in outs[0][1]
    assert "CG iter    0" in outs[0][1]
