"""Charge equilibration (QEq): two-vector conjugate gradient over the pair
sweep (counterpart of the `pair_ops` branch of rxmd_tpu.qeq.solve).

The (s, t) vectors are solved jointly as one (N, 2) state; each CG
iteration applies the shielded-Coulomb hessian to both and sums the
electrostatic energy Est in one pass (ref: get_hsh, qeq.F90:271-318).
`pair_ops` keeps the hessian as a pair list, built at the solve's first
matvec and applied at every one (ref: qeq_initialize's hessian rows,
qeq.F90:183).  Termination follows the reference's
two tests on Est (ref: qeq.F90:114-115); the loop reads the stop flag on
the host once per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QEqResult(NamedTuple):
    q: torch.Tensor       # (N,) converged charges
    qs: torch.Tensor
    qt: torch.Tensor
    iters: int            # number of completed CG updates
    est: torch.Tensor     # () final electrostatic energy [eV]


def solve(pos, q, qsfp, types, ffd, pair_ops, amask=None, isqeq: int = 1,
          nmax: int = 500, tol: float = 1e-7,
          lex_fqs: float = 1.0) -> QEqResult:
    """Solve for charges.  isqeq=1: full CG (ref: qeq.F90:39-48); isqeq=2:
    extended-Lagrangian warm start, one iteration (ref: qeq.F90:51-57).
    `pair_ops.sweep3(hs, ht, q)` returns the per-atom (H·hs, H·ht, Est pair
    sum) rows of the QEq sweep."""
    n = pos.shape[0]
    dtype = pos.dtype
    # the stop tests are RELATIVE energy changes; below ~20 ulp of the
    # working precision they never trigger and the CG burns iterations on
    # rounding noise — floor the tolerance (f64 keeps the reference's)
    tol = max(tol, 20.0 * float(torch.finfo(dtype).eps))
    if amask is None:
        amask = torch.ones((n,), dtype=torch.bool, device=pos.device)
    eta = torch.where(amask, ffd.eta[types], 0.0)
    chi = torch.where(amask, ffd.chi[types], 0.0)
    w = amask.to(dtype)

    def matvec2(X):
        mvs, mvt, _ = pair_ops.sweep3(X[:, 0], X[:, 1],
                                      torch.zeros_like(X[:, 0]))
        return eta[:, None] * X + torch.stack([mvs, mvt], dim=1)

    def matvec2_and_est(Hv, qcur):
        mvs, mvt, estp = pair_ops.sweep3(Hv[:, 0], Hv[:, 1], qcur)
        mv = eta[:, None] * Hv + torch.stack([mvs, mvt], dim=1)
        per_atom = chi * qcur + 0.5 * eta * qcur * qcur + estp * qcur
        return mv, torch.sum(torch.where(amask, per_atom, 0.0))

    def gradient(X):
        rhs = torch.stack([-chi, -w], dim=1)
        return torch.where(amask[:, None], rhs - matvec2(X), 0.0)

    return _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs,
               matvec2_and_est, gradient)


def _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs, matvec2_and_est,
        gradient):
    """Two-vector CG with the reference's exact termination semantics
    (ref: qeq.F90:96-166): on a stop the previous iterate is kept."""
    if isqeq == 2:
        qs0 = torch.where(amask, lex_fqs * qsfp + (1.0 - lex_fqs) * q, 0.0)
        nmax_eff = 1
    else:
        qs0 = torch.where(amask, q, 0.0)
        nmax_eff = nmax
    X = torch.stack([qs0, torch.zeros_like(q)], dim=1)   # (n, 2) = (qs, qt)
    G = gradient(X)
    gnew = torch.sum(G * G, dim=0)                        # (2,)
    Hv = G
    qcur = q
    # "never converged yet" sentinel (ref GEst2=1.d99, qeq.F90:98), the
    # dtype's own max so f32 does not overflow
    gest2 = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=q.device)
    est = torch.zeros((), dtype=dtype, device=q.device)
    it = 0
    while it < nmax_eff:
        HH, est = matvec2_and_est(Hv, qcur)              # (n, 2), ()
        g_h = torch.sum(G * Hv, dim=0)
        h_hsh = torch.sum(Hv * HH, dim=0)
        ex1 = 0.5 * (torch.abs(gest2) + torch.abs(est)) < tol
        ex2 = (torch.abs(gest2) > 0.0) & (torch.abs(est / gest2 - 1.0) < tol)
        if bool(ex1 | ex2):
            break
        lmin = g_h / torch.where(h_hsh != 0.0, h_hsh, 1.0)
        X1 = X + lmin[None, :] * Hv
        st = torch.sum(X1, dim=0)                         # (2,): Σqs, Σqt
        mu = st[0] / st[1]
        q1 = torch.where(amask, X1[:, 0] - mu * X1[:, 1], 0.0)
        # CG residual recurrence: gradient(X1) = gradient(X) - lmin*A·Hv,
        # and A·Hv = HH was just computed (saves the explicit
        # get_gradient sweep of ref qeq.F90:157)
        G1 = torch.where(amask[:, None], G - lmin[None, :] * HH, 0.0)
        gnew1 = torch.sum(G1 * G1, dim=0)
        gsafe = torch.where(torch.abs(gnew) > 0.0, gnew, 1.0)
        Hv = G1 + (gnew1 / gsafe)[None, :] * Hv
        X, qcur, G, gnew, gest2 = X1, q1, G1, gnew1, est
        it += 1
    return QEqResult(q=qcur, qs=X[:, 0], qt=X[:, 1], iters=it, est=est)
