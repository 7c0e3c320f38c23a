"""The rebuild program's device milliseconds per rebuild over the
profiled sub-window: the device marks of the "rebuild" phase in the
rebuild program (md.Engine._rebuild_fn: wrap, neighbor lists, term lists,
slot layout), summed, over the rebuilds the sub-window ran (a probe's
neighbor build is its own program's, not counted; harness/session.py)."""
from harness import session


def read(art):
    s = session.last()
    if s is None:
        return None
    return session.per(s, art, "md",
                       session.phase_ns(s, ("rebuild",), "rebuild"),
                       "rebuilds")
