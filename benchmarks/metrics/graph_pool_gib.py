"""GiB of the device's memory held in the graphs' memory pool over the
profiled sub-window: the port's level "graph pool GiB", set after each
capture from the pool's segments (graphs.Memory.gib), the largest that the
session saw (none is captured in it: the one set last in set-up).  A port
without that level gives None (harness/session.py)."""
from harness import session


def read(art):
    s = session.last()
    if s is None or art.get("trace") is None or "steps" not in art:
        return None
    return s.get("levels", {}).get("graph pool GiB")
