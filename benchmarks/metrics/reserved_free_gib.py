"""GiB that the device's allocator reserves and no tensor takes
(memory_reserved - memory_allocated), the largest over the profiled
sub-window: the port's level "reserved free GiB", set at each rebuild's
host read, from the one that held when the session opened.  A port
without that level gives None (harness/session.py)."""
from harness import session


def read(art):
    s = session.last()
    if s is None or art.get("trace") is None or "steps" not in art:
        return None
    return s.get("levels", {}).get("reserved free GiB")
