"""Optimizer probes (Engine.probe calls) per CG iteration over the traced
window."""


def read(art):
    if not art.get("iterations") or "probes" not in art:
        return None
    return art["probes"] / art["iterations"]
