"""The port's own record of the profiled sub-window.

`trace.profiled` runs the sub-window under a torch.profiler session, and
rxmd_tpu_torch's tracing (rxmd_tpu_torch/utils/timers.py) keeps what that
session saw in a module-level record, read after the run by
`timers.last_session()`: host spans, device marks summed by (program,
phase), launch gaps by cause, and the counts "MD steps", "probes" and
"rebuilds" of the sub-window.  A port without that record gives None, and
so does every reader of it.
"""


def last():
    """`timers.last_session()` of the port, or None."""
    try:
        from rxmd_tpu_torch.utils import timers
    except ImportError:
        return None
    read = getattr(timers, "last_session", None)
    return None if read is None else read()


def phase_ns(s, programs, phase):
    """Device ns of the marks of `phase` in the programs `programs`."""
    return sum(ns for (kind, name), (ns, _) in s["phases"].items()
               if kind in programs and name == phase)


def count(s, name):
    return s["counts"].get(name, 0)


def per(s, art, kind, ns, counter):
    """`ns` in ms per `counter` of the session, for a traced run of `kind`
    ("md": art has steps, "relax": iterations), or None where the run is
    of the other kind, untraced, or nothing was marked or counted."""
    key = "steps" if kind == "md" else "iterations"
    if art.get("trace") is None or key not in art or not ns \
            or not count(s, counter):
        return None
    return ns * 1e-6 / count(s, counter)


def gaps(s):
    """(device ns between one captured part's end and the next one's
    start, summed, and the number of such gaps)."""
    return (sum(ns for ns, _ in s["gaps"].values()),
            sum(n for _, n in s["gaps"].values()))
