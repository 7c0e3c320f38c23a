"""qeq_apply_kernel's share of its roofline over the profiled optimizer
iteration: the least time of its launches over their device time in the
trace.  A launch's least time is harness/roofline.py's bound on the
hessian's directed entries, images included, counted from each probe's
positions (their mean over the iteration's probes); the form with charges
where the kernel's name says `true`, else the form without, which moves
fewer bytes."""
from harness import roofline


def read(art):
    tr = art.get("trace")
    if tr is None or "pairs" not in art:
        return None
    cost = lambda name: roofline.qeq_apply_cost(art["n"], art["pairs"],
                                                "true" in name)
    return roofline.kernel_share(tr["by_name"], "qeq_apply_kernel", cost)
