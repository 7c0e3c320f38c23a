"""Structural optimization: nonlinear conjugate gradient (mdmode=10)
(counterpart of rxmd_tpu.opt).

Reimplements the reference optimizer (ref: src/cg.F90:26-393): Polak-Ribiere
style CG over atom positions, bracketing by step doubling from 1e-2/N with
Wolfe-condition tests, golden-section line minimization, convergence when
|dPE| <= ftol * N.  Each energy evaluation re-solves QEq, exactly like
EvaluateEnergyWithStep (ref: cg.F90:358-387).

The line-search control flow runs on the host and reads one float per
probe.  On one device a probe is the engine's probe program
(`md.Engine.probe`, rxmd_tpu's jitted evaluation): fresh neighbor lists
and, for the pair sweep, the slot layout, then a full CG and the forces
over the uncached terms (what rxmd_tpu evaluates), through the engine's
pair engine; on a card a CUDA graph, its PE and list counts read in one
transfer.  The same loop drives the sharded engine, eagerly, through an
adapter whose vectors are each domain's block: its dot products and
maxima are reduced over the mesh, the CG vectors migrate with their atoms
between iterations (MigrateVec3D, ref: cg.F90:292-314) and a probe may
move an atom at most half the Verlet skin, so the probe's fresh halo
plan stays complete (rxmd_tpu opt.py:67-90).

Host spans (utils/timers.py): each iteration's "line search" (the
bracket and the golden section, their probes inside) and "direction",
and every read of a dot product or a norm.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils import timers as trace

GOLD = 0.5 * (np.sqrt(5.0) - 1.0)

# reference line-search constants (ref: cg.F90:6-16)
CG_MAX_BRACKET = 20       # CG_MaxBracketLoop
CG_MAX_LINEMIN = 100      # CG_MaxLineMinLoop
CG_WC1 = 1e-4             # Armijo constant
CG_GSTOL = 1e-6           # golden-section interval tolerance (per atom)


class _MDAdapter:
    """Single-device engine: positions are a plain (n, 3) tensor."""

    drift_limit = np.inf

    def __init__(self, engine):
        self.engine = engine
        self.n = engine.state.n
        # the box is fixed under mdmode 10: its inverse once, outside the
        # probes (inverting reads the host)
        self.hinv = torch.linalg.inv(engine.state.H)

    @staticmethod
    def dot(a, b):
        with trace.span("dot read"):
            return float(torch.sum(a * b))

    @staticmethod
    def max_norm(p):
        with trace.span("norm read"):
            return float(torch.max(torch.linalg.norm(p, dim=-1)))

    @staticmethod
    def resync(pos, g, p):
        return pos, g, p

    def positions(self):
        return self.engine.state.pos

    def evaluate(self, pos):
        """(PE, forces, charges) at `pos` (md.Engine.probe)."""
        return self.engine.probe(pos, self.hinv)

    def commit(self, pos, q):
        self.engine.state = dataclasses.replace(self.engine.state,
                                                pos=pos, q=q)


class _ShardedAdapter:
    """Sharded engine: positions are the domain's block; dot products and
    maxima are reduced over the mesh, so every rank takes the same line
    search."""

    def __init__(self, engine):
        self.engine = engine
        self.n = engine.n
        # residents may sit at most this far outside their subdomain
        # before a probe's ghost selection could miss an interaction
        self.drift_limit = 0.5 * engine.skin_nb

    def dot(self, a, b):
        with trace.span("dot read"):
            return float(self.engine.comm.psum(torch.sum(a * b)))

    def max_norm(self, p):
        with trace.span("norm read"):
            return float(self.engine.comm.pmax(
                torch.max(torch.linalg.norm(p, dim=-1))))

    def positions(self):
        return self.engine.cg_positions()

    def evaluate(self, pos):
        return self.engine.cg_evaluate(pos)

    def resync(self, pos, g, p):
        return self.engine.cg_resync(pos, g, p)

    def commit(self, pos, q):
        self.engine.cg_commit(pos, q)


def _make_adapter(engine):
    from .md import Engine as MDEngine
    from .parallel.engine import ShardedEngine
    if isinstance(engine, MDEngine):
        return _MDAdapter(engine)
    if isinstance(engine, ShardedEngine):
        return _ShardedAdapter(engine)
    raise TypeError(f"conjugate_gradient needs md.Engine or ShardedEngine, "
                    f"got {type(engine).__name__}")


def conjugate_gradient(engine, max_iter: int = 500, ftol: float = None,
                       max_bracket: int = 50, log=print, writer=None):
    """Minimize the potential energy of the engine's state in place
    (ref: ConjugateGradient cg.F90:26-98)."""
    ad = _make_adapter(engine)
    cfg = engine.cfg
    ftol = cfg.ftol if ftol is None else ftol
    n = ad.n

    pos = ad.positions()
    pe_, g, q = ad.evaluate(pos)
    pe = float(pe_)
    p = g                                   # initial direction (cg.F90:50)
    if log:
        log(f"Start structural optimization. ftol={ftol:.2e} PE0={pe:.6f}")

    def e_at(alpha, pos, p, pmax):
        if alpha * pmax > ad.drift_limit:
            # the probe would outrun the halo skin margin
            return None
        e, _, _ = ad.evaluate(pos + alpha * p)
        return float(e)

    def bracket(pos, p, pe0, f0, pmax):
        """Double the step from 1e-2/N until the Armijo test fails
        (ref: BracketSearchRange cg.F90:101-141 + WolfeConditions
        cg.F90:144-208).  The reference's stop test reads
        `.not.WolfeC1 .or. .not.WolfeC1` — i.e. only the Armijo rule
        gates the bracket (the curvature bool is computed but unused);
        we reproduce that observable behavior."""
        stepl = 1e-2 / n
        p_dot_f = ad.dot(p, f0)                    # p . force(x)
        for _ in range(min(max_bracket, CG_MAX_BRACKET)):
            stepl *= 2.0
            e = e_at(stepl, pos, p, pmax)
            if e is None:
                # cap the bracket at the decomposition's drift limit
                return stepl * 0.5
            armijo = e <= pe0 + p_dot_f * CG_WC1 * stepl
            if not armijo:                         # bracket found
                return stepl
        return None

    def golden(pos, p, b, pmax):
        """Golden-section minimization on [0, b]: interval shrinks until
        |a-d| <= CG_GStol/N, returns the right edge like the reference
        (GoldenSectionSearch returns dx, cg.F90:242-281 + use at :232)."""
        a = 0.0
        x1 = b - GOLD * (b - a)
        x2 = a + GOLD * (b - a)
        f1 = e_at(x1, pos, p, pmax)
        f2 = e_at(x2, pos, p, pmax)
        for _ in range(CG_MAX_LINEMIN):
            if abs(a - b) <= CG_GSTOL / n:
                break
            if f1 < f2:
                b = x2
            else:
                a = x1
            x1 = b - GOLD * (b - a)
            x2 = a + GOLD * (b - a)
            f1 = e_at(x1, pos, p, pmax)
            f2 = e_at(x2, pos, p, pmax)
        return b

    for it in range(max_iter):
        with trace.span("line search"):
            pmax = ad.max_norm(p)
            b = bracket(pos, p, pe, g, pmax)
            if b is not None:
                alpha = golden(pos, p, b, pmax)
        if b is None:
            if log:
                log(f"no bracket found at iter {it}; at a minimum")
            break
        pos = pos + alpha * p
        # atoms and the CG vectors move to their new domains before the
        # next evaluation (the identity on one device)
        pos, g_old, p = ad.resync(pos, g, p)
        pe_old = pe
        pe_, g, q = ad.evaluate(pos)
        pe = float(pe_)
        if writer:
            writer(it, pos, pe)
        if log:
            log(f"CG iter {it:4d}: PE={pe:.8f} dPE={pe - pe_old:.3e} "
                f"alpha={alpha:.3e}")
        if abs(pe - pe_old) <= ftol * n:    # ref: cg.F90:75
            if log:
                log(f"Energy converged at iter {it}")
            break
        with trace.span("direction"):
            b1 = ad.dot(g_old, g_old)
            b2 = ad.dot(g, g)
            b3 = ad.dot(g, g_old)
            p = (b2 - b3) / b1 * p + g      # ref: cg.F90:82-89

    ad.commit(pos, q)
    return pe
