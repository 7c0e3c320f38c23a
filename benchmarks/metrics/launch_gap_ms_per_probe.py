"""Launch gaps per optimizer probe over the profiled iteration: the device
milliseconds from one captured graph part's end to the next part's start
(a probe segment or CG chunk), summed, over the iteration's probes, with
the number of gaps beside it (`n`).  The port files each gap under the
host span that came before the next launch: a probe's read and checks,
the line search, a CG flag read (harness/session.py)."""
from harness import session


def read(art):
    s = session.last()
    if s is None:
        return None
    ns, n = session.gaps(s)
    v = session.per(s, art, "relax", ns, "probes")
    return None if v is None else (v, {"n": n})
