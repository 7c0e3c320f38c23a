"""nonbond_kernel's share of its roofline over the profiled optimizer
iteration: the least time of its launches over their device time in the
trace.  A launch's least time is harness/roofline.py's bound on the
directed pairs of distinct atoms inside the taper radius, counted from
each probe's positions (their mean over the iteration's probes)."""
from harness import roofline


def read(art):
    tr = art.get("trace")
    if tr is None or "pairs_distinct" not in art:
        return None
    cost = lambda name: roofline.nonbond_cost(art["n"], art["pairs_distinct"])
    return roofline.kernel_share(tr["by_name"], "nonbond_kernel", cost)
