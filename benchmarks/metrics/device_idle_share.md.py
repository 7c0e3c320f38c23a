"""The device's idle share over the profiled MD sub-window, in percent:
100 (1 - busy / window), busy the union of the device's intervals in the
torch.profiler trace, window the host's wall of the sub-window."""


def read(art):
    tr = art.get("trace")
    if tr is None or "steps" not in art or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
