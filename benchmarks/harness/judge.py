"""What decides `correct`: the port's outputs against the plain reference
(reference/evaluate.py in float64), each number beside its limit
(limits/<cell>.json).

MD.  The reference cannot follow a trajectory (MD is chaotic), so it
follows the port from the port's own states.  It checks the start (the
outputs of `prepare` at the seed's positions: the numbers ending in 0),
the state the window ends in and one more step of `run` from it (the
others):
  q_e     the largest charge difference [e] (full CG to 1e-12, or under
          isQEq=2 the extended Lagrangian's one iteration from the port's
          fictitious charges qsfp);
  f_rel   the largest force difference over max|f| of the reference;
  f_rms   the root mean square force difference over the reference's root
          mean square force;
  pe_rel  the largest difference of a PE term over |PE|, Eclmb and Echarge
          summed (the CG's stop moves energy between the two, and their
          sum is what QEq minimises);
  bo      the largest difference of an atom's summed bond order, at the
          window's end state (the port's `bond_table`);
  x_A     the next step's positions against the reference's half kick and
          drift from the end state [A, minimum image];
  v_rel   its velocities against the reference's second half kick, over
          max|v|.
Relaxation.  At the start positions (the numbers ending in 0) and at the
last iteration's:
  q_e, f_rel, f_rms   of the probe (`Engine.probe`, the optimizer's
               evaluation);
  pe_rel       |PE - PE_ref| / |PE_ref|: of the first probe, and of the PE
               the optimizer reported for its last iterate;
  bo           at the last iterate;
  line_cos     |cos| of the last iteration's step and the reference's
               force at its end: the line search ends at a minimum along
               its direction, where the force is normal to it (1 where the
               iteration did not move).
"""
from __future__ import annotations

import math

import numpy as np


def _terms(comps):
    c = np.asarray(comps, dtype=np.float64)
    return np.concatenate([c[1:12], [c[12] + c[13]]])


def pe_rel(comps, ref):
    return float(np.abs(_terms(comps) - _terms(ref)).max() / abs(ref[0]))


def f_rel(f, ref):
    return float(np.linalg.norm(f - ref, axis=1).max()
                 / np.linalg.norm(ref, axis=1).max())


def f_rms(f, ref):
    return float(np.sqrt(np.mean(np.sum((f - ref) ** 2, axis=1))
                         / np.mean(np.sum(ref * ref, axis=1))))


def q_e(q, ref):
    return float(np.abs(q - ref).max())


def min_image(d, H):
    L = np.diag(H)
    return d - L * np.round(d / L)


# -- MD ----------------------------------------------------------------------
def md_reference(R, snaps, run):
    """The reference evaluator R's outputs beside the port's snapshots
    (start, end, next): the start and the end state evaluated, the next
    step integrated from the end state with R's forces, and R's charges and
    forces at the port's next positions for its second half kick."""
    start, end, nxt = snaps["start"], snaps["end"], snaps["next"]
    isq = run["isQEq"]
    r0 = R.evaluate(start["pos"], isqeq=1)
    rn = R.evaluate(end["pos"], isqeq=isq, qsfp=end["qsfp"],
                    lex_fqs=run["Lex_fqs"])
    v = end["vel"]
    if run["mdmode"] == 5 and end["step"] % run["sstep"] == 0:
        v = R.mdmode5(v, run["treq"])
    vh, x1 = R.half_step(end["pos"], v, rn["force"], run["dt_fs"])
    r1 = R.evaluate(nxt["pos"], isqeq=isq, qsfp=nxt["qsfp"],
                    lex_fqs=run["Lex_fqs"])
    r1.update(pos=x1, vel=R.kick(vh, r1["force"], run["dt_fs"]))
    return dict(start=r0, end=rn, next=r1)


def md_numbers(prog, ref, H):
    """The MD checks (module docstring) of `prog` (the port's snapshots, or
    a control's md_reference) against `ref` (md_reference in float64)."""
    nx, rx = prog["next"], ref["next"]

    def state(keys, suffix=""):
        return {
            "q_e" + suffix: max(q_e(prog[s]["q"], ref[s]["q"]) for s in keys),
            "f_rel" + suffix: max(f_rel(prog[s]["force"], ref[s]["force"])
                                  for s in keys),
            "f_rms" + suffix: max(f_rms(prog[s]["force"], ref[s]["force"])
                                  for s in keys),
            "pe_rel" + suffix: max(pe_rel(prog[s]["comps"], ref[s]["comps"])
                                   for s in keys)}
    return dict(
        **state(("start",), "0"), **state(("end", "next")),
        bo=float(np.abs(prog["end"]["bo_sum"] - ref["end"]["bo_sum"]).max()),
        x_A=float(np.abs(min_image(nx["pos"] - rx["pos"], H)).max()),
        v_rel=float(np.abs(nx["vel"] - rx["vel"]).max()
                    / np.abs(rx["vel"]).max()))


# -- relaxation --------------------------------------------------------------
def relax_numbers(prog, ref):
    """The relaxation checks of `prog` = dict(start=dict(pe, force, q),
    last=dict(pe, force, q, bo_sum, pos, prev)) against `ref` = the
    float64 reference's outputs at prog's start and last positions."""
    s, l = prog["start"], prog["last"]
    rs, rl = ref["start"], ref["last"]
    step = (l["pos"] - l["prev"]).reshape(-1)
    f = rl["force"].reshape(-1)
    norm = np.linalg.norm(step) * np.linalg.norm(f)
    rel = lambda pe, r: float(abs(pe - r["comps"][0]) / abs(r["comps"][0]))
    return dict(
        q_e0=q_e(s["q"], rs["q"]), f_rel0=f_rel(s["force"], rs["force"]),
        f_rms0=f_rms(s["force"], rs["force"]), pe_rel0=rel(s["pe"], rs),
        q_e=q_e(l["q"], rl["q"]), f_rel=f_rel(l["force"], rl["force"]),
        f_rms=f_rms(l["force"], rl["force"]), pe_rel=rel(l["pe"], rl),
        bo=float(np.abs(l["bo_sum"] - rl["bo_sum"]).max()),
        line_cos=float(abs(step @ f) / norm) if norm > 0 else 1.0)


def golden_along(R, x0, d, iters=20):
    """The minimum of R's energy on x0 + t d, t in [0, 2], by golden-section
    search (the control's line search)."""
    g = 0.5 * (math.sqrt(5.0) - 1.0)
    e = lambda t: R.evaluate(x0 + t * d)["comps"][0]
    a, b = 0.0, 2.0
    t1, t2 = b - g * (b - a), a + g * (b - a)
    f1, f2 = e(t1), e(t2)
    for _ in range(iters):
        if f1 < f2:
            b, t2, f2 = t2, t1, f1
            t1 = b - g * (b - a)
            f1 = e(t1)
        else:
            a, t1, f1 = t1, t2, f2
            t2 = a + g * (b - a)
            f2 = e(t2)
    return x0 + 0.5 * (a + b) * d


# -- the verdict -------------------------------------------------------------
def verdict(numbers, limits):
    """(correct, checks): every number finite and within its limit; checks
    = {name: {"value", "limit"}} in the limits' order."""
    missing = sorted(set(numbers) ^ set(limits))
    if missing:
        raise KeyError(f"numbers and limits differ in {missing}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
