"""The kind md_sharded on the CPU, launched as benchmarks/run.py launches a
cell on several cards (tests/sharded_rank.py: one process per domain over
gloo, no card): the CHON cell replicated (4, 4, 2), 5,376 atoms, over the
mesh (2, 2, 1).  Every rank runs the same steps; what rank 0 checked passes
md_exl's limits and the control (the reference in bfloat16) fails them;
its gathered snapshots agree with one domain's on the same seed (both in
float64, the CG to 1e-12); a rank that fails, dies or hangs ends the run
before the deadline, with no result line and no rank left, and so does a
launcher that its caller ends; a cell on four cards runs on no machine
with fewer."""
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_small  # noqa: E402
from sharded_rank import load_run  # noqa: E402

from harness import deck, judge, port_sharded  # noqa: E402

SEED = 5000000011
RANK = os.path.join(bench_small.BENCH, "tests", "sharded_rank.py")
EXACT = ("--dtype", "float64", "--qeq-tol", "1e-12")
RUNS = {"f32": ("--mesh", "2,2,1"), "f64": ("--mesh", "2,2,1", *EXACT),
        "f64 one domain": ("--mesh", "1,1,1", *EXACT)}


def start(*args):
    return subprocess.Popen([sys.executable, RANK, *map(str, args)],
                            cwd=bench_small.ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (result line, stderr, rank 0's dump)} of one run of the seed
    for each of RUNS, all at once."""
    tmp = tmp_path_factory.mktemp("sharded")
    dumps = {k: tmp / f"{i}.pkl" for i, k in enumerate(RUNS)}
    procs = {k: start("--seed", SEED, *a, "--dump", dumps[k])
             for k, a in RUNS.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=1800)
        assert p.returncode == 0, stderr[-3000:]
        with open(dumps[k], "rb") as fh:
            out[k] = (json.loads(stdout.strip().splitlines()[-1]), stderr,
                      pickle.load(fh))
    return out


def test_rank_zeros_line(runs):
    line, stderr, dump = runs["f32"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    dev = line["device"]
    assert dev["count"] == 4 and [d["rank"] for d in dev["ranks"]] \
        == [0, 1, 2, 3]
    assert dev["memory_peak_bytes"] == max(d["memory_peak_bytes"]
                                           for d in dev["ranks"])
    assert set(line["metrics"]) == {"atom_steps_per_s", "setup_s"}
    assert stderr.strip().splitlines()[-1].startswith("check ")


def test_every_rank_runs_the_same_steps(runs):
    for line, _, dump in runs.values():
        steps = [a["steps"] for a in dump["ranks"]]
        assert steps == [line["attempted"]] * len(steps) and steps[0] > 0
    assert len({line["attempted"] for line, _, _ in runs.values()}) == 1


def test_numbers_pass_and_the_control_fails(runs):
    limits = bench_small.sharded_cell().limits
    for _, _, dump in runs.values():
        assert judge.verdict(dump["numbers"], limits)[0], dump["numbers"]
        assert not judge.verdict(dump["control"], limits)[0], dump["control"]


def test_gathered_snapshots_agree_with_one_domain(runs):
    """Four domains against one on the same seed, in float64 with the CG
    to a relative Est change of 1e-12.  Each domain sums its rows' pair,
    bond and CG terms in another order, and the CG's stop reads
    all-reduced sums: the two CGs stop some iterations apart, which leaves
    the charges ~5e-7 e apart (measured: 5.5e-7 at the start, 4e-7 after),
    the forces ~6e-8 of their largest, the positions ~2e-9 A after five
    steps.  The tolerances allow ~20 x that; a term, an atom or a ghost
    left out moves them by 1e-3 and more."""
    a, b = runs["f64"][2]["snaps"], runs["f64 one domain"][2]["snaps"]
    H = runs["f64"][2]["H"]
    for s in ("start", "end", "next"):
        assert a[s]["step"] == b[s]["step"]
        assert np.abs(judge.min_image(a[s]["pos"] - b[s]["pos"], H)).max() \
            < 5e-8
        assert np.abs(a[s]["vel"] - b[s]["vel"]).max() \
            < 1e-6 * np.abs(b[s]["vel"]).max()
        assert judge.q_e(a[s]["q"], b[s]["q"]) < 1e-5
        assert judge.q_e(a[s]["qsfp"], b[s]["qsfp"]) < 1e-5
        assert judge.f_rel(a[s]["force"], b[s]["force"]) < 1e-6
        assert judge.pe_rel(a[s]["comps"], b[s]["comps"]) < 1e-10
    assert np.abs(a["end"]["bo_sum"] - b["end"]["bo_sum"]).max() < 5e-8


def test_a_domains_bond_sums_are_the_bond_tables():
    """port_sharded.bond_sums (each domain's rows on the last rebuild's
    lists, its ghosts refreshed to the engine's positions) against the
    sums of ShardedEngine.bond_table, which builds lists anew over the
    whole gathered deck: one domain in float64, two steps past the lists'
    positions (sums at the lists' own positions part by 0.045); the
    same bonds and bond orders, summed in another order (4e-15)."""
    cell = bench_small.sharded_cell((1, 1, 1), dtype="float64")
    inputs = deck.make(cell.config, cell.traffic, SEED)
    eng = port_sharded.engine(cell.config, cell.traffic, inputs, "cpu")
    eng.prepare()
    eng.run(2, log=None)
    mine = eng.sstate.valid
    sums = port_sharded.bond_sums(eng)[mine]
    order = eng.sstate.gid[mine].argsort()
    _, bos, _ = eng.bond_table(eng.to_state(), bo_cutoff=0.0)
    whole = bos.sum(dim=1)
    assert eng.step_count == 2 and whole.min() > 0.5
    assert (sums[order] - whole).abs().max() < 1e-12 * whole.max()


@pytest.mark.parametrize("fault, allowance", [
    ("raise", 900), ("kill", 900), ("hang", 30)])
def test_a_rank_fault_ends_the_run(fault, allowance):
    """Rank 1 raises or kills itself as its window starts, or hangs before
    joining; the launcher ends the run (the hang at its deadline,
    `allowance` after its start), kills every rank and prints nothing."""
    t = time.monotonic()
    p = start("--seed", SEED, "--fault", fault, "--allowance", allowance)
    stdout, stderr = p.communicate(timeout=allowance + 300)
    took = time.monotonic() - t
    assert p.returncode != 0 and stdout.strip() == "", stderr[-3000:]
    assert took < allowance + 60
    assert "every rank was killed, no result" in stderr
    if fault == "hang":
        assert "were not done 30 s after" in stderr
    else:
        assert re.search(r"rank \d exited with code", stderr)
    pids = [int(x) for x in re.findall(r"launch: rank \d pid (\d+)", stderr)]
    assert len(pids) == 4
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def gone(pid):
    """Whether process `pid` has ended (a zombie that no one reaped yet
    counts as ended)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("sig", ["SIGTERM", "SIGKILL"])
def test_an_ended_launcher_leaves_no_rank(sig):
    """The launcher's caller ends it while its ranks wait (rank 1 hangs
    before joining): on SIGTERM it kills them itself and exits non-zero
    with no result; on SIGKILL the kernel ends them (each rank dies with
    its launcher)."""
    p = start("--seed", SEED, "--fault", "hang", "--allowance", 900)
    pids = []
    while len(pids) < 4:
        m = re.search(r"launch: rank \d pid (\d+)", p.stderr.readline())
        if m:
            pids.append(int(m.group(1)))
    time.sleep(2.0)
    p.send_signal(getattr(signal, sig))
    stdout, _ = p.communicate(timeout=120)
    assert p.returncode != 0 and stdout.strip() == ""
    t = time.monotonic()
    while not all(gone(pid) for pid in pids) and time.monotonic() - t < 60:
        time.sleep(0.2)
    assert all(gone(pid) for pid in pids)


def test_four_cards_on_fewer(capsys):
    """A four-card cell on this machine (no card, or fewer than four)
    exits 2 and prints no result."""
    run = load_run()
    cell = bench_small.sharded_cell()
    code = run.main(["--workload", cell.name, "--seed", "1", "--seconds",
                     "1"], cell=cell)
    out = capsys.readouterr()
    assert code == 2 and out.out == ""
    assert "needs 4 CUDA card(s)" in out.err
