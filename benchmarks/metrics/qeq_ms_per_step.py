"""The QEq solve's device milliseconds per MD step over the profiled
sub-window: the device marks of the "qeq" phase (md.Engine._qeq_step
around qeq.solve) in the step and block programs, from the solve's start
to its end, so the CG's chunk graphs and the gaps between them inside,
summed, over the sub-window's MD steps (harness/session.py)."""
from harness import session


def read(art):
    s = session.last()
    if s is None:
        return None
    return session.per(s, art, "md",
                       session.phase_ns(s, ("step", "block"), "qeq"),
                       "MD steps")
