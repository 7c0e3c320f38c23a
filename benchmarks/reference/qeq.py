"""Charge equilibration (QEq): two-vector conjugate gradient
(counterpart of rxmd_tpu.qeq).

The (s, t) vectors are solved jointly as one (N, 2) state; each CG
iteration applies the shielded-Coulomb hessian to both and sums the
electrostatic energy Est in one pass (ref: get_hsh, qeq.F90:271-318).
The hessian comes from one of three pair engines:
  * the pair sweep (`pair_ops`): a pair list built at the solve's first
    matvec and applied at every one by the CUDA kernels;
  * the dense minimum-image form (`direct`): (n, n) matrices and matmuls;
  * the pair context over the nonbonded list (ELL, from `pre` or built
    here), closed-form or table column 4; a full CG (isQEq=1) at
    n <= `dense_max` folds it into a dense (n, n) matrix once.
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
batched MPI buffer, qeq.F90:126-131), `refresh` brings a resident vector
to the ghost rows the pair context indexes (MODE_QCOPY1/2,
qeq.F90:86-164), each the identity on one device.  `lmin_f32` stores the line-minimization step in float32 as
the reference does (qeq.F90:23), so iteration counts match its.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .reax import (_table_rows, cf_qeq_kernel, ctx_prm, nb_ctx,
                   pair_bond_type, qeq_dense_direct)


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


def solve(pos, q, qsfp, types, ffd, pair_ops=None, amask=None,
          isqeq: int = 1, nmax: int = 500, tol: float = 1e-7,
          lex_fqs: float = 1.0, *, H=None, img=None, nbrs=None,
          lmin_f32: bool = False, closed_form=None, pre=None,
          dense_max: int = 8192, direct: bool = False, allreduce=None,
          refresh=None, resident_ext=None, loop=None) -> QEqResult:
    """Solve for charges.  isqeq=1: full CG (ref: qeq.F90:39-48); isqeq=2:
    extended-Lagrangian warm start, one iteration (ref: qeq.F90:51-57).

    The engine, in order: `direct` (the dense minimum-image hessian, needs
    H); `pair_ops`, whose `sweep3(X, q)` returns the per-atom (H·X[:, 0],
    H·X[:, 1], Est pair sum) rows of the pair sweep for the (n, 2) state X
    (q None: no Est sum, that row 0); else the pair context:
    `pre` = (ctx, table rows, ok) from reax.pair_rows, or (ctx, None, None)
    for the closed form, or None to build it from (H, img, nbrs) with the
    closed form if `closed_form` else the tables.

    Multi-domain hooks (rxmd_tpu qeq.py:60-64), each None on one device:
    `allreduce` sums a tensor over the domains, `refresh` maps a vector
    over the rows (`pos`, `q`) to the extended rows the pair context
    indexes, `resident_ext` marks the extended rows that are this
    domain's own (the Est pair weights, ref: qeq.F90:304-306).  With
    `refresh` the pair context (`pre`) is required and no dense fold is
    made.

    `loop(run_chunk, carry, nchunks)` drives the CG's chunks of CG_CHUNK
    iterations (`eager_loop` if None; a CUDA graph capture passes its
    own)."""
    n = pos.shape[0]
    local_only = refresh is None
    if refresh is None:
        refresh = lambda x: x
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

    def cg(matvec2, matvec2_and_est):
        def gradient(X):
            rhs = torch.stack([-chi, -w], dim=1)
            return torch.where(amask[:, None], rhs - matvec2(X), 0.0)
        return _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs,
                   lmin_f32, matvec2_and_est, gradient, allreduce, loop)

    def est_of(pair_sum, qcur):
        per_atom = chi * qcur + 0.5 * eta * qcur * qcur + pair_sum * qcur
        return torch.sum(torch.where(amask, per_atom, 0.0))

    if direct:
        Hd, Hw = qeq_dense_direct(pos, H, types, ffd)
        return cg(lambda X: eta[:, None] * X + Hd @ X,
                  lambda Hv, qc: (eta[:, None] * Hv + Hd @ Hv,
                                  est_of(Hw @ qc, qc)))

    if pair_ops is not None:
        def matvec2(X):
            mvs, mvt, _ = pair_ops.sweep3(X, None)
            return eta[:, None] * X + torch.stack([mvs, mvt], dim=1)

        def matvec2_and_est(Hv, qcur):
            mvs, mvt, estp = pair_ops.sweep3(Hv, qcur)
            mv = eta[:, None] * Hv + torch.stack([mvs, mvt], dim=1)
            return mv, est_of(estp, qcur)
        return cg(matvec2, matvec2_and_est)

    # the pair context: QEq keeps periodic self-images (ref: qeq.F90:200-
    # 256), so its notself mask is unused and gid may be a dummy
    if pre is not None:
        ctx, rows, ok = pre
        if rows is None:
            hess = cf_qeq_kernel(ctx.dr2, ctx_prm(ctx, types, ffd), ffd,
                                 ctx.mask & (ctx.dr2 < ffd.rctap2))
        else:
            hess = torch.where(ok & (ctx.dr2 < ffd.rctap2), rows[..., 4], 0.0)
    else:
        ctx = nb_ctx(pos, None, H, types, img, nbrs, torch.zeros_like(types),
                     amask, ffd)
        in_range = nbrs.masknb & (ctx.dr2 < ffd.rctap2)
        if closed_form:
            hess = cf_qeq_kernel(ctx.dr2, ctx_prm(ctx, types, ffd), ffd,
                                 in_range)
        else:
            bc = pair_bond_type(ctx, types, ffd)
            ok = in_range & (bc >= 0)
            rows = _table_rows(ffd, torch.where(ok, bc, 0), ctx.dr2, ok)
            hess = torch.where(ok, rows[..., 4], 0.0)
    mask = nbrs.masknb
    oj = img.owner_of(ctx.idx)
    hz = torch.where(mask, hess, 0.0)
    # Est pair weight: 0.5 per directed entry plus another 0.5 when the
    # neighbor is an atom of this domain, not an image or a ghost (ref:
    # qeq.F90:304-306)
    own = ctx.idx < n if resident_ext is None else resident_ext[ctx.idx]
    est_w = torch.where(own, 1.0, 0.5).to(dtype)

    if local_only and n <= dense_max and isqeq != 2:
        # a full CG: fold the list into a dense (n, n) matrix once, each
        # matvec a matmul; index_put_ with accumulate sums repeated
        # (row, owner) entries in a fixed order
        row = torch.arange(n, device=pos.device)[:, None].expand_as(oj)
        Hd = torch.zeros((n, n), dtype=dtype, device=pos.device)
        Hd.index_put_((row.reshape(-1), oj.reshape(-1)), hz.reshape(-1),
                      accumulate=True)

        def matvec2_and_est(Hv, qcur):
            qj = torch.where(mask, qcur[oj], 0.0)
            return (eta[:, None] * Hv + Hd @ Hv,
                    est_of(torch.sum(est_w * hz * qj, dim=1), qcur))
        return cg(lambda X: eta[:, None] * X + Hd @ X, matvec2_and_est)

    def matvec2(X):
        Xs = torch.where(mask[..., None], refresh(X)[oj], 0.0)   # (n, knb, 2)
        return eta[:, None] * X + torch.einsum("nk,nkc->nc", hz, Xs)

    def matvec2_and_est(Hv, qcur):
        """One (n, knb, 3) gather feeds both H·(hs, ht) and the Est pair
        sum (cf. the reference's single get_hsh pass)."""
        Y = torch.cat([Hv, qcur[:, None]], dim=1)
        Ys = torch.where(mask[..., None], refresh(Y)[oj], 0.0)
        mv = eta[:, None] * Hv + torch.einsum("nk,nkc->nc", hz, Ys[..., :2])
        return mv, est_of(torch.sum(est_w * hz * Ys[..., 2], dim=1), qcur)
    return cg(matvec2, matvec2_and_est)


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
