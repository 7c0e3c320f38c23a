"""Launch gaps per MD step over the profiled sub-window: the device
milliseconds from one captured graph part's end to the next part's start
(a step or block segment, a CG chunk, a rebuild), summed, over the
sub-window's MD steps, with the number of gaps beside it (`n`).  The port
files each gap under the host span that came before the next launch
(harness/session.py)."""
from harness import session


def read(art):
    s = session.last()
    if s is None:
        return None
    ns, n = session.gaps(s)
    v = session.per(s, art, "md", ns, "MD steps")
    return None if v is None else (v, {"n": n})
