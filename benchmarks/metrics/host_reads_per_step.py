"""Host reads per MD step over the traced window: the count-mode copy of
HostReadGuard (harness/trace.py) over the window's `run` calls, divided by
the window's MD steps."""


def read(art):
    if "host_reads" not in art or not art.get("steps"):
        return None
    return art["host_reads"] / art["steps"]
