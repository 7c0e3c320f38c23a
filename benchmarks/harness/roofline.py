"""The card's peaks and each pair kernel's least time, from what its inputs
need: the pairs inside the cutoff, counted here from the state's positions,
never from the program's list layout.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet at 700 W: 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM3 (reported with the
card's power limit beside them).  Operations per pair are counted from
rxmd_tpu_torch/csrc/pairsweep.cu as it stood when this benchmark was made
(each +, -, *, / and each sqrtf, powf, expf as one): the nonbond pair body
and the hessian apply's three products and sums with the image weight.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
OPS_NONBOND, OPS_QEQ_APPLY = 101, 7
# the taper radius of the nonbond and QEq pair terms [A] (reference/units)
RCTAP = 10.0


def bound_s(nbytes, nops):
    """The least seconds the card could take to move `nbytes` and do `nops`
    float32 operations."""
    return max(nbytes / PEAK_BYTES, nops / PEAK_F32)


def nonbond_cost(n, pairs):
    """(bytes, operations) of one nonbond launch over `n` atoms and `pairs`
    directed pairs of distinct atoms inside the taper radius: each atom's
    position, type, id and charge read once (6 words), its 11 rows of
    energies, forces and virial written once; 101 operations a pair."""
    return 4 * 6 * n + 4 * 11 * n, OPS_NONBOND * pairs


def qeq_apply_cost(n, pairs, with_q):
    """(bytes, operations) of one hessian apply over `n` atoms and `pairs`
    directed entries (periodic images included): each entry's column and
    value (8 bytes), the row offsets, the (n, 2) state in, with q the
    charges in and the Est row out, the two product rows out; 7
    operations an entry."""
    nbytes = 8 * pairs + 4 * (n + 1) + 8 * n + 8 * n
    if with_q:
        nbytes += 4 * n + 4 * n
    return nbytes, OPS_QEQ_APPLY * pairs


@torch.no_grad()
def count_pairs(pos, H, rc=RCTAP, rows=256):
    """(directed pairs (i, j, image) with |r| < rc, other than an atom with
    itself at no shift; of those, the pairs of distinct atoms), for an
    orthogonal box `H` (numpy (3, 3)) and positions `pos` (a tensor, any
    device), in float64."""
    dev = pos.device
    L = torch.as_tensor(np.diag(H).copy(), dtype=torch.float64, device=dev)
    x = pos.double()
    x = x - torch.floor(x / L) * L
    n = x.shape[0]
    rc2 = rc * rc
    min_image = bool((L > 2.0 * rc).all())
    reach = [0 if min_image else math.ceil(rc / float(l)) for l in L]
    shifts = torch.cartesian_prod(*[torch.arange(-m, m + 1, device=dev,
                                                 dtype=torch.float64)
                                    for m in reach]).reshape(-1, 3) * L
    every = distinct = 0
    for a in range(0, n, rows):
        xa = x[a:a + rows]
        ids = torch.arange(a, a + xa.shape[0], device=dev)
        for s in shifts:
            d = xa[:, None, :] - x[None, :, :] + s
            if min_image:
                d = d - torch.round(d / L) * L
            near = (d * d).sum(-1) < rc2
            same = ids[:, None] == torch.arange(n, device=dev)[None, :]
            zero = bool((s == 0).all())
            every += int((near & ~(same & zero)).sum())
            distinct += int((near & ~same).sum())
    return every, distinct


def kernel_share(by_name, kernel, cost):
    """Percent of the least time over the device time of `kernel`'s
    launches in a trace (`by_name`: kernel name -> (seconds, launches));
    `cost(name)` is (bytes, operations) of one launch of that name.  None
    where the trace holds no launch of it."""
    least = took = 0.0
    for name, (sec, calls) in by_name.items():
        if kernel in name and calls:
            least += calls * bound_s(*cost(name))
            took += sec
    return 100.0 * least / took if took > 0 else None
