"""MD steps per neighbor rebuild over the traced window: the window's
steps over the rebuilds `md.Engine.run` made in it (Timers' calls of
"neighbor rebuild")."""


def read(art):
    if not art.get("rebuilds") or "steps" not in art:
        return None
    return art["steps"] / art["rebuilds"]
