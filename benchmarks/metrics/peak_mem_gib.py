"""The device's peak allocated memory [GiB] from set-up's start to the
window's end: torch.cuda.max_memory_allocated() after
reset_peak_memory_stats() before the engine was made."""


def read(art):
    if not art.get("peak_bytes"):
        return None
    return art["peak_bytes"] / 2**30
