"""Charge equilibration (QEq): two-vector conjugate gradient
(counterpart of rxmd_tpu.qeq).

The (s, t) vectors are solved jointly as one (N, 2) state; each CG
iteration applies the shielded-Coulomb hessian to both and sums the
electrostatic energy Est in one pass (ref: get_hsh, qeq.F90:271-318).
The hessian is the operator the pair engine hands in (pairs.py); the
solve runs one CG over it.
Termination follows the reference's two tests on Est (ref:
qeq.F90:114-115).  The loop is rxmd_tpu's `lax.while_loop` (qeq.py:268-316)
as a masked update: every iteration computes the next iterate and keeps the
previous one where the loop has ended (its condition failed or a stop test
fired), so a fixed run of iterations gives the while loop's result.  The
iterations run in chunks of CG_CHUNK; between chunks `loop` reads one
"finished" flag on the host (none when a solve fits in one chunk, as the
extended Lagrangian's single iteration does).  The iteration count and Est
stay on the device.  A domain of the sharded engine solves over its residents:
`allreduce` sums the CG's scalars over the domains (the reference's
batched MPI buffer, qeq.F90:126-131); its operator brings a resident vector
to the ghost rows its pair context indexes (MODE_QCOPY1/2,
qeq.F90:86-164).  `lmin_f32` stores the line-minimization step in float32
as the reference does (qeq.F90:23), so iteration counts match its.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


# CG iterations per chunk: the host reads one "finished" flag per chunk
CG_CHUNK = 8


class QEqResult(NamedTuple):
    q: torch.Tensor       # (N,) converged charges
    qs: torch.Tensor
    qt: torch.Tensor
    iters: torch.Tensor   # () int32 number of completed CG updates
    est: torch.Tensor     # () final electrostatic energy [eV]


class CGCarry(NamedTuple):
    """The CG's loop state (rxmd_tpu qeq.py:265-266), on the device."""
    it: torch.Tensor      # () int32 completed updates
    X: torch.Tensor       # (n, 2) the (qs, qt) iterate
    qcur: torch.Tensor    # (n,) its charges
    Hv: torch.Tensor      # (n, 2) search direction
    G: torch.Tensor       # (n, 2) gradient
    gnew: torch.Tensor    # (2,) G.G
    gest2: torch.Tensor   # () Est of the previous update
    est: torch.Tensor     # () Est of the last iteration run
    done: torch.Tensor    # () bool: a stop test fired
    fin: torch.Tensor     # () bool: the loop has ended


def eager_loop(chunk, carry, nchunks):
    """Run `chunk` (CG_CHUNK masked iterations) on `carry` up to `nchunks`
    times, reading the finished flag on the host between chunks."""
    carry = chunk(carry)
    for _ in range(nchunks - 1):
        if bool(carry.fin):
            break
        carry = chunk(carry)
    return carry


def solve(q, qsfp, types, ffd, hessian, amask=None, isqeq: int = 1,
          nmax: int = 500, tol: float = 1e-7, lex_fqs: float = 1.0, *,
          lmin_f32: bool = False, allreduce=None, loop=None) -> QEqResult:
    """Solve for charges.  isqeq=1: full CG (ref: qeq.F90:39-48); isqeq=2:
    extended-Lagrangian warm start, one iteration (ref: qeq.F90:51-57).

    `hessian`: the pair engine's hessian operator (pairs.py).  `allreduce`
    sums a tensor over the sharded engine's domains (rxmd_tpu
    qeq.py:60-64).  `loop(run_chunk, carry, nchunks)` drives the CG's
    chunks (`eager_loop` if None; a CUDA graph capture passes its own)."""
    n, dtype = q.shape[0], q.dtype
    # the stop tests are RELATIVE energy changes; below ~20 ulp of the
    # working precision they never trigger and the CG burns iterations on
    # rounding noise — floor the tolerance (f64 keeps the reference's)
    tol = max(tol, 20.0 * float(torch.finfo(dtype).eps))
    if amask is None:
        amask = torch.ones((n,), dtype=torch.bool, device=q.device)
    eta = torch.where(amask, ffd.eta[types], 0.0)
    chi = torch.where(amask, ffd.chi[types], 0.0)
    w = amask.to(dtype)
    matvec, matvec_est = hessian(eta)

    def gradient(X):
        rhs = torch.stack([-chi, -w], dim=1)
        return torch.where(amask[:, None], rhs - matvec(X), 0.0)

    def matvec2_and_est(Hv, qcur):
        mv, pair_sum = matvec_est(Hv, qcur)
        per_atom = chi * qcur + 0.5 * eta * qcur * qcur + pair_sum * qcur
        return mv, torch.sum(torch.where(amask, per_atom, 0.0))
    return _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs, lmin_f32,
               matvec2_and_est, gradient, allreduce, loop)


def _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs, lmin_f32,
        matvec2_and_est, gradient, allreduce=None, loop=None):
    """Two-vector CG with the reference's exact termination semantics
    (ref: qeq.F90:96-166): on a stop the previous iterate is kept.  The
    body of rxmd_tpu's while loop (qeq.py:272-311) runs as a masked update
    in chunks of CG_CHUNK iterations (module docstring).  Under `allreduce`
    an iteration makes two reductions: (Est, g.h, h.Hh), the one fused
    reduction of rxmd_tpu (qeq.py:283-287), then (sum X1, g1.g1), which
    rxmd_tpu makes as two."""
    nmax_eff = 1 if isqeq == 2 else int(nmax)
    if isqeq == 2:
        qs0 = torch.where(amask, lex_fqs * qsfp + (1.0 - lex_fqs) * q, 0.0)
    else:
        qs0 = torch.where(amask, q, 0.0)
    dev = q.device
    X = torch.stack([qs0, torch.zeros_like(q)], dim=1)   # (n, 2) = (qs, qt)
    G = gradient(X)
    gnew = torch.sum(G * G, dim=0)                        # (2,)
    if allreduce is not None:
        gnew = allreduce(gnew)
    scalar = lambda v, dt: torch.full((), v, dtype=dt, device=dev)
    # "never converged yet" sentinel (ref GEst2=1.d99, qeq.F90:98), the
    # dtype's own max so f32 does not overflow
    carry = CGCarry(it=scalar(0, torch.int32), X=X, qcur=q, Hv=G, G=G,
                    gnew=gnew, gest2=scalar(torch.finfo(dtype).max, dtype),
                    est=scalar(0.0, dtype), done=scalar(False, torch.bool),
                    fin=scalar(nmax_eff <= 0, torch.bool))

    def body(c):
        HH, est = matvec2_and_est(c.Hv, c.qcur)          # (n, 2), ()
        g_h = torch.sum(c.G * c.Hv, dim=0)
        h_hsh = torch.sum(c.Hv * HH, dim=0)
        if allreduce is not None:
            red = allreduce(torch.cat([est[None], g_h, h_hsh]))
            est, g_h, h_hsh = red[0], red[1:3], red[3:5]
        ex1 = 0.5 * (torch.abs(c.gest2) + torch.abs(est)) < tol
        ex2 = ((torch.abs(c.gest2) > 0.0)
               & (torch.abs(est / c.gest2 - 1.0) < tol))
        lmin = g_h / torch.where(h_hsh != 0.0, h_hsh, 1.0)
        if lmin_f32:
            lmin = lmin.to(torch.float32).to(dtype)       # ref: qeq.F90:23
        X1 = c.X + lmin[None, :] * c.Hv
        st = torch.sum(X1, dim=0)                         # (2,): Σqs, Σqt
        # CG residual recurrence: gradient(X1) = gradient(X) - lmin*A·Hv,
        # and A·Hv = HH was just computed (saves the explicit
        # get_gradient sweep of ref qeq.F90:157)
        G1 = torch.where(amask[:, None], c.G - lmin[None, :] * HH, 0.0)
        gnew1 = torch.sum(G1 * G1, dim=0)
        if allreduce is not None:
            red = allreduce(torch.cat([st, gnew1]))
            st, gnew1 = red[:2], red[2:]
        mu = st[0] / st[1]
        q1 = torch.where(amask, X1[:, 0] - mu * X1[:, 1], 0.0)
        gsafe = torch.where(torch.abs(c.gnew) > 0.0, c.gnew, 1.0)
        H1 = G1 + (gnew1 / gsafe)[None, :] * c.Hv
        # rxmd_tpu's cond (it < nmax and not done) and sel(old, new).
        # `fin` comes from all-reduced scalars alone (Est, g.h and h.Hh
        # above): under `allreduce` every domain reads the same flag and
        # runs (or replays) the same number of chunks; a domain running
        # one chunk more would wait forever in its collectives
        run = (c.it < nmax_eff) & ~c.done
        take = run & ~(ex1 | ex2)
        sel = lambda new, old: torch.where(take, new, old)
        it = c.it + take.to(torch.int32)
        done = c.done | (run & ~take)
        return CGCarry(it=it, X=sel(X1, c.X), qcur=sel(q1, c.qcur),
                       Hv=sel(H1, c.Hv), G=sel(G1, c.G),
                       gnew=sel(gnew1, c.gnew), gest2=sel(est, c.gest2),
                       est=torch.where(run, est, c.est), done=done,
                       fin=done | (it >= nmax_eff))

    if nmax_eff > 0:
        size = min(CG_CHUNK, nmax_eff)

        def run_chunk(c):
            for _ in range(size):
                c = body(c)
            return c
        carry = (loop or eager_loop)(run_chunk, carry,
                                     math.ceil(nmax_eff / size))
    return QEqResult(q=carry.qcur, qs=carry.X[:, 0], qt=carry.X[:, 1],
                     iters=carry.it, est=carry.est)
