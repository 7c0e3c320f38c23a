"""rxmd_tpu_torch's CUDA sweep kernels against their plain PyTorch
versions, on a card (every case skips without one).

This file imports no jax, so it also runs where jax is not installed;
tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

168-atom deck, float32, the engine's own slot layout and packed planes.
Bar: each output row within 1e-4 of its largest magnitude (at least 1):
the kernel and the plain sweep add the same float32 pair terms in
another order.
"""
import os

import numpy as np
import pytest
import torch

from rxmd_tpu_torch import config, ffield, md, system
from rxmd_tpu_torch.ops import pairsweep as ps

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
    ops = e._make_pair_ops(s.pos, s.H, s.types, e._slotmap)
    rng = np.random.default_rng(3)
    q = rng.normal(scale=0.2, size=s.n)
    q -= q.mean()
    hs, ht = rng.normal(size=(2, s.n))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    return e.pairk, {"nonbond": (ops.nonbond_planes(t(q)), e._nb_fn),
                     "qeq": (ops.qeq_planes(t(hs), t(ht), t(q)), e._qeq_fn)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nonbond", "qeq"])
def test_kernel_matches_plain(planes, name):
    grid, cases = planes
    packed, fn = cases[name]
    n0 = ps.launches[name]
    got = ps.sweep(grid, packed, fn)
    assert ps.launches[name] == n0 + 1
    ref = ps.sweep_plain(grid, packed, fn)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (fn.out_k, grid.n_targets)
    assert bool(torch.isfinite(got).all())
    err = (got - ref).abs().amax(dim=1)
    scale = ref.abs().amax(dim=1).clamp(min=1.0)
    assert bool((err <= 1e-4 * scale).all()), (err, scale)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(planes):
    grid, cases = planes
    packed, fn = cases["qeq"]
    n0 = ps.launches["qeq"]
    with pytest.raises(ValueError, match="float32"):
        ps.sweep(grid, packed.double(), fn)
    with pytest.raises(ValueError, match="float32"):
        ps.sweep(grid, packed[:6].contiguous(), fn)
    assert ps.launches["qeq"] == n0
