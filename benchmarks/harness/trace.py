"""What a traced run reads besides the program's own counters: its host
reads, counted, and a profiled sub-window's device time.

`HostReads` is a count-mode copy of rxmd_tpu_torch/parallel/dryrun.py's
`HostReadGuard(count=True)`: while entered it counts each way a tensor
reaches the host (`Tensor.item`, `__bool__`, `__int__`, `__float__`,
`__index__`, `tolist`, `numpy`, `cpu`, `nonzero`, `masked_select`; torch's
`nonzero`, `masked_select`, `argwhere`, `unique`, one-argument
`torch.where`; indexing with a boolean mask) and refuses nothing.

`profiled(fn)` runs fn() under torch.profiler (CPU and CUDA activity) and
sums the trace's raw events: the union of the device's busy intervals, each
kernel's seconds and launches by name, and the idle gaps between device
work by the innermost host operation that spans each.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class HostReads:
    """Counts host reads while entered (`n`)."""

    def __init__(self):
        self.n = 0
        self._saved = []

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        T = torch.Tensor

        def counted(orig):
            def f(*a, **k):
                self.n += 1
                return orig(*a, **k)
            return f

        def masked(orig):
            def f(t, idx, *v):
                if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in (idx if isinstance(idx, tuple) else (idx,))):
                    self.n += 1
                return orig(t, idx, *v)
            return f

        def where1(orig):
            def f(*a, **k):
                if len(a) + len(k) == 1:
                    self.n += 1
                return orig(*a, **k)
            return f

        for name in ("item", "__bool__", "__int__", "__float__",
                     "__index__", "tolist", "numpy", "cpu", "nonzero",
                     "masked_select"):
            self._patch(T, name, counted)
        for name in ("nonzero", "masked_select", "argwhere", "unique"):
            self._patch(torch, name, counted)
        self._patch(T, "__getitem__", masked)
        self._patch(T, "__setitem__", masked)
        self._patch(torch, "where", where1)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []


def _union(iv):
    """Merged (start, end) intervals of an (m, 2) array."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def profiled(fn, top=10, min_gap_s=5e-6, gaps_named=2000):
    """fn() under torch.profiler: dict(busy_s, window_s, by_name {kernel:
    (seconds, launches)}, device_ops [[name, s]], idle_gaps [[host op,
    s]]).  The window is the host's wall from fn()'s start to a
    synchronize after it; busy_s the union of the device's intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    by, dev, host, names = {}, [], [], []
    for ev in prof.profiler.kineto_results.events():
        a, d = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            sec, calls = by.get(ev.name(), (0.0, 0))
            by[ev.name()] = (sec + d * 1e-9, calls + 1)
            dev.append((a, a + d))
        elif ev.device_type() == DeviceType.CPU and d > 0:
            host.append((a, a + d))
            names.append(ev.name())
    busy = _union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    gaps = np.stack([busy[:-1, 1], busy[1:, 0]], 1) if len(busy) > 1 \
        else np.zeros((0, 2))
    glen = (gaps[:, 1] - gaps[:, 0]) * 1e-9
    keep = np.argsort(-glen)[:gaps_named]
    keep = keep[glen[keep] >= min_gap_s]
    hv = np.asarray(host, dtype=np.float64).reshape(-1, 2)
    idle = {}
    for g in keep:
        mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
        over = np.nonzero((hv[:, 0] <= mid) & (hv[:, 1] >= mid))[0]
        name = ("no host operation" if len(over) == 0 else
                names[over[np.argmin(hv[over, 1] - hv[over, 0])]])
        idle[name] = idle.get(name, 0.0) + float(glen[g])
    if len(busy):
        edge = window - float(busy[-1, 1] - busy[0, 0]) * 1e-9
        idle["window edges (before the first and after the last device "
             "operation)"] = max(edge, 0.0)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        busy_s=busy_s, window_s=window, by_name=by,
        device_ops=[[k[:120], s] for k, (s, _) in sorted(
            by.items(), key=lambda kv: -kv[1][0])[:top]],
        idle_gaps=[[k[:120], s] for k, s in rank(idle)])
