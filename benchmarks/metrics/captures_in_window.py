"""CUDA graph captures inside the traced window (Timers' counter "graph
captures": step, block, rebuild and probe programs), which set-up should
leave at 0."""


def read(art):
    return art.get("captures")
