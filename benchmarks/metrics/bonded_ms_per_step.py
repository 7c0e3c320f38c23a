"""Bonded autograd's device milliseconds per MD step over the profiled
sub-window: the device marks of the "bonded" phase (md.Engine._potential
around reax.energy_and_forces: the bonded terms' forward and backward) in
the step and block programs, summed, over the sub-window's MD steps; the
forward's, the backward's and each term's ms per step beside it (the
port's session record, harness/session.py)."""
import re

from harness import session

STEPS = ("step", "block")


def read(art):
    s = session.last()
    if s is None:
        return None
    v = session.per(s, art, "md", session.phase_ns(s, STEPS, "bonded"),
                    "MD steps")
    if v is None:
        return None
    names = {name for _, name in s["phases"]
             if name in ("forward", "backward") or name.startswith("E:")}
    extra = {re.sub(r"\W+", "_", n.replace("E:", "term_")).strip("_"):
             session.per(s, art, "md", session.phase_ns(s, STEPS, n),
                         "MD steps") or 0.0 for n in sorted(names)}
    return v, extra
