"""QEq CG iterations per MD step over the traced window: the engine's
device count of CG iterations summed over every solve (md.Engine.cg_iters,
read once after the window), divided by the window's MD steps.  (The
Timers counter "QEq iterations" samples one step every pstep.)"""


def read(art):
    if "qeq_iters" not in art or not art.get("steps"):
        return None
    return art["qeq_iters"] / art["steps"]
