"""The pair engine's nonbond in device milliseconds per MD step over the
profiled sub-window: the device marks of the "nonbond" phase
(md.Engine._potential around the pair engine's nonbond: on the pair list
the closed-form vdW and Coulomb energies, row forces and virial) in the
step and block programs, summed, over the sub-window's MD steps; the
"pairs" phase's ms per step beside it (md.Engine._pair_data: the pair
data that QEq and the nonbond share), from the port's session record
(harness/session.py)."""
from harness import session

STEPS = ("step", "block")


def read(art):
    s = session.last()
    if s is None:
        return None
    v = session.per(s, art, "md", session.phase_ns(s, STEPS, "nonbond"),
                    "MD steps")
    if v is None:
        return None
    return v, {"pairs": session.per(s, art, "md",
                                    session.phase_ns(s, STEPS, "pairs"),
                                    "MD steps") or 0.0}
