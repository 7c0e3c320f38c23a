"""The 95th percentile of the host's wall milliseconds between consecutive
PRINTE lines of the traced window (pstep steps apart), with the number of
intervals beside it (`n`)."""
import statistics


def read(art):
    t = art.get("printe_times") or []
    gaps = [1e3 * (b - a) for a, b in zip(t, t[1:])]
    if len(gaps) < 2:
        return None
    return statistics.quantiles(gaps, n=20)[-1], {"n": len(gaps)}
