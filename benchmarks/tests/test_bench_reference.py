"""The plain reference at 168 atoms in float64 against the port's CPU
path: prepare and one velocity-Verlet step.

The port's exact path (term lists enumerated in every call, the pair
list) agrees to rounding.  Its cached term lists (which the pair sweep
runs, and so the benchmark) agree at the positions they were built at and
part from exact ReaxFF afterwards: a term whose geometry crosses a cutoff
after the build enters at the next rebuild, an omission the port bounds
by ~1e-4 kcal/mol an atom (rxmd_tpu_torch/config.py, term_margin)."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_small import BENCH  # noqa: E402

from harness import deck, judge  # noqa: E402
from reference import evaluate  # noqa: E402

DATA = os.path.join(BENCH, "data")


@pytest.fixture(scope="module", params=["exact", "cached"])
def pair(request):
    from rxmd_tpu_torch import config, ffield, md, system
    ff, pos, types, H = evaluate.load_deck(
        os.path.join(DATA, "chon168.xyz"),
        os.path.join(DATA, "ffield_chon_synth"), (1, 1, 1))
    vel = deck.maxwell_boltzmann(np.random.default_rng(5), ff.mass[types],
                                 300.0)
    cfg = config.RunConfig(dtype="float64", nonbond_closed_form=True,
                           mdmode=1, isQEq=1, QEq_tol=1e-12, NMAXQEq=3000,
                           term_cache=request.param == "cached",
                           pair_kernel=request.param == "cached")
    st = system.make_state(pos, types, H, vel=vel, dtype=torch.float64)
    eng = md.Engine(ffield.parse_ffield(os.path.join(DATA,
                                                     "ffield_chon_synth")),
                    st, cfg, device="cpu")
    host = lambda t: t.detach().cpu().numpy()
    eng.prepare()
    start = dict(pos=host(eng.state.pos), vel=host(eng.state.vel),
                 q=host(eng.state.q), force=host(eng.force),
                 comps=host(eng.comps))
    eng.step()
    nxt = dict(pos=host(eng.state.pos), vel=host(eng.state.vel),
               q=host(eng.state.q), force=host(eng.force),
               comps=host(eng.comps))
    return ff, types, H, cfg, start, nxt, request.param


def test_prepare_agrees(pair):
    ff, types, H, cfg, start, _, _ = pair
    r = evaluate.Evaluator(ff, types, H).evaluate(start["pos"])
    assert judge.q_e(start["q"], r["q"]) < 1e-6
    assert judge.f_rel(start["force"], r["force"]) < 1e-7
    assert judge.pe_rel(start["comps"], r["comps"]) < 1e-9


def test_one_step_agrees(pair):
    ff, types, H, cfg, start, nxt, path = pair
    R = evaluate.Evaluator(ff, types, H)
    r0 = R.evaluate(start["pos"])
    vh, x1 = R.half_step(start["pos"], start["vel"], r0["force"], cfg.dt_fs)
    assert np.abs(judge.min_image(nxt["pos"] - x1, H)).max() < 1e-9
    r1 = R.evaluate(nxt["pos"])
    assert judge.q_e(nxt["q"], r1["q"]) < 1e-6
    if path == "cached":
        terms = judge._terms(nxt["comps"]) - judge._terms(r1["comps"])
        assert np.abs(terms).max() < 1e-4 * len(types)
        return
    v1 = R.kick(vh, r1["force"], cfg.dt_fs)
    assert np.abs(nxt["vel"] - v1).max() / np.abs(v1).max() < 1e-7
    assert judge.f_rel(nxt["force"], r1["force"]) < 1e-7
    assert judge.pe_rel(nxt["comps"], r1["comps"]) < 1e-9


@pytest.mark.parametrize("mc, block_rows, blocks", [
    # 1,344 atoms in 48 blocks, each smaller than its halo: ghosts are
    # images of residents too
    ((2, 2, 2), 2000, (4, 4, 3)),
    # 5,376 atoms (52.7 x 46.3 x 21.4 A) in 3 x 2 x 1 blocks: a block and
    # its 10.1-A halo on both sides (37.8 x 43.3 A) fall short of the box
    # in x and y, so those ghost layers are cut where the halo ends; the
    # faces at a third of the box in x pass through molecules, and ghosts
    # taken 0.5 A short of the halo part from one pass by f_rel 1e-8
    ((4, 4, 2), 8000, (3, 2, 1)),
])
def test_blocks_agree_with_one_pass(mc, block_rows, blocks):
    """A deck evaluated in spatial blocks against one pass, in float64:
    the same global CG gives the same charges and bond orders; the
    energies and forces sum the same terms in another order (rounding,
    ~1e-14 of the largest)."""
    ff, pos, types, H = evaluate.load_deck(
        os.path.join(DATA, "chon168.xyz"),
        os.path.join(DATA, "ffield_chon_synth"), mc)
    pos = pos + np.random.default_rng(3).normal(scale=0.05, size=pos.shape)
    one = evaluate.Evaluator(ff, types, H)
    blocked = evaluate.Evaluator(ff, types, H, max_atoms=0,
                                 block_rows=block_rows)
    assert one.blocks is None and blocked.blocks == blocks
    if mc == (4, 4, 2):
        L = np.diag(H)[:2]
        assert (L / np.asarray(blocks[:2]) + 2 * blocked.halo < L).all()
    a, b = one.evaluate(pos), blocked.evaluate(pos)
    assert np.array_equal(a["q"], b["q"])
    assert np.array_equal(a["bo_sum"], b["bo_sum"])
    assert judge.f_rel(b["force"], a["force"]) < 1e-12
    assert np.abs(a["comps"] - b["comps"]).max() < 1e-12 * abs(a["comps"][0])
