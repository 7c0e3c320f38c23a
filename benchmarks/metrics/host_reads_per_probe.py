"""Host reads per optimizer probe over the traced window: the count-mode
copy of HostReadGuard (harness/trace.py) over the optimizer, divided by its
probes."""


def read(art):
    if "host_reads" not in art or not art.get("probes"):
        return None
    return art["host_reads"] / art["probes"]
