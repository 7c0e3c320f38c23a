"""The benchmark's operation and byte counters on a small deck: the pairs
inside the taper radius against a plain loop over atoms and images, and
each kernel's bytes and operations from them."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH]

from harness import roofline  # noqa: E402
from reference import evaluate  # noqa: E402


def plain_pairs(pos, L, rc):
    """Directed (i, j, image) pairs within rc by a loop over images."""
    x = pos - np.floor(pos / L) * L
    reach = [int(np.ceil(rc / l)) for l in L]
    every = distinct = 0
    for s in itertools.product(*[range(-m, m + 1) for m in reach]):
        d = x[:, None, :] - x[None, :, :] + np.asarray(s) * L
        near = (d * d).sum(-1) < rc * rc
        same = np.eye(len(x), dtype=bool)
        every += int((near & ~(same & (np.asarray(s) == 0).all())).sum())
        distinct += int((near & ~same).sum())
    return every, distinct


def deck(mc):
    data = os.path.join(BENCH, "data")
    _, pos, _, H = evaluate.load_deck(os.path.join(data, "chon168.xyz"),
                                      os.path.join(data, "ffield_chon_synth"),
                                      mc)
    return pos, H


@pytest.mark.parametrize("mc", [(1, 1, 1), (2, 2, 2)])
def test_pairs_against_a_plain_loop(mc):
    pos, H = deck(mc)
    rng = np.random.default_rng(3)
    pos = pos + rng.normal(scale=0.3, size=pos.shape) - 5.0   # unwrapped
    got = roofline.count_pairs(torch.as_tensor(pos), H, rows=100)
    want = plain_pairs(pos, np.diag(H), roofline.RCTAP)
    assert got == want
    # (1, 1, 1) is a 10.7 A box, where the count runs over the images;
    # (2, 2, 2) is over twice the cutoff on every axis, where it takes the
    # minimum image
    assert (min(np.diag(H)) > 2 * roofline.RCTAP) == (mc == (2, 2, 2))


def test_kernel_costs():
    n, p = 1000, 400_000
    nb_bytes, nb_ops = roofline.nonbond_cost(n, p)
    assert (nb_bytes, nb_ops) == (4 * 6 * n + 4 * 11 * n, 101 * p)
    b1, o1 = roofline.qeq_apply_cost(n, p, True)
    b0, o0 = roofline.qeq_apply_cost(n, p, False)
    assert o1 == o0 == 7 * p
    assert b1 == 8 * p + 4 * (n + 1) + 24 * n
    assert b1 - b0 == 8 * n
    # H100 data sheet: 3.35 TB/s, 67 TFLOP/s float32
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)


def test_kernel_share():
    by = {"void qeq_apply_kernel<16, true>(int*)": (2e-3, 100),
          "void qeq_apply_kernel<16, false>(int*)": (1e-4, 5),
          "other": (1.0, 1)}
    cost = lambda name: roofline.qeq_apply_cost(1000, 400_000,
                                                "true" in name)
    least = (100 * roofline.bound_s(*cost("true"))
             + 5 * roofline.bound_s(*cost("false")))
    got = roofline.kernel_share(by, "qeq_apply_kernel", cost)
    assert got == pytest.approx(100.0 * least / 2.1e-3)
    assert roofline.kernel_share(by, "nonbond_kernel", cost) is None
