"""Bonded autograd's device milliseconds per optimizer probe over the
profiled iteration: the device marks of the "bonded" phase in the probe
program (md.Engine._probe_fn), summed, over the iteration's probes
(harness/session.py)."""
from harness import session


def read(art):
    s = session.last()
    if s is None:
        return None
    return session.per(s, art, "relax",
                       session.phase_ns(s, ("probe",), "bonded"), "probes")
