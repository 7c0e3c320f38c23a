#!/usr/bin/env python3
"""Time forms of the QEq apply on one CUDA card, in turns, on the engine's
own list (rxmd_tpu_torch, the CHON deck replicated --mc, float32):

    python3 scripts/qeq_apply_forms.py [--mc 4 4 3] [--reps 50]

The forms (scripts/qeq_apply_forms.cu, built here with nvcc for sm_90a):
the port's kernel (ops/pairsweep.qeq_apply, 16 lanes a row, 4 record
pairs a lane before the first gather; with q and without); the same loop
at 8, 16 or 32 lanes a row and 2, 4 or 8 record pairs; the records alone,
no gather (the list's stream); the (n, 2) state and q staged into each
block's shared memory; and the port's kernel on the list compacted (no
gaps between the rows).  Each form's rows
are held against qeq_apply_plain (3e-4 of max, as chip_smoke.py), but the
records alone's.  Prints us per launch, device time (chip_smoke.graph_ms:
--reps launches captured into one CUDA graph, its replay timed by CUDA
events; each form twice, in the order given and then back), the bytes
bound and torch.sparse.mm over the same list (timed eagerly), with
nvidia-smi's name and power limit.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as c                            # noqa: E402
from rxmd_tpu_torch.ops import pairsweep as ps    # noqa: E402

SRC = os.path.join(REPO, "scripts", "qeq_apply_forms.cu")
LIB = os.path.join(REPO, "build", "rxmd_tpu_torch", "libqeq_apply_forms.so")


def build():
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    subprocess.run([ps._nvcc(), *ps._NVCC_FLAGS, "-o", LIB, SRC], check=True)
    lib = ctypes.CDLL(LIB)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.apply_form.argtypes = [ci] + [vp] * 7 + [ci] * 5 + [vp]
    lib.apply_form.restype = ci
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mc", nargs=3, type=int, default=(4, 4, 3))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qeq_apply_forms: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    e = c.make_engine(tuple(args.mc), "cuda")
    e._rebuild(e.state)
    s = e.state
    ops = e._make_pair_ops(s.pos, s.H, s.types, e._slotmap)
    walk, n = ops.walk, s.n
    lst = ps.qeq_build(e.pairk, walk, ops.qeq_planes(), e._qeq_fn, ops.own,
                       n, e._qcap)
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((n, 2), device="cuda", generator=gen)
    q = torch.randn(n, device="cuda", generator=gen) * 0.2
    ref = ps.qeq_apply_plain(lst, walk, X, q)
    T, cap = walk.tslot.shape[0], lst.rec.shape[0]
    live = c.live_records(lst)
    E = live.shape[0]
    # the list compacted: rows back to back
    dense = lst._replace(
        start=(torch.cumsum(lst.count, 0) - lst.count).to(torch.int32),
        rec=lst.rec[live].contiguous())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty((3, n), device="cuda")

    def form(k, blocks=0):
        def run():
            err = lib.apply_form(k, lst.start.data_ptr(),
                                 lst.count.data_ptr(), lst.rec.data_ptr(),
                                 walk.trow.data_ptr(), X.data_ptr(),
                                 q.data_ptr(), out.data_ptr(), T, n, cap, n,
                                 blocks,
                                 torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"form {k}: CUDA error {err}")
            return out
        return run

    forms = {"port": lambda: ps.qeq_apply(lst, walk, X, q),
             "port, no q": lambda: ps.qeq_apply(lst, walk, X)}
    forms["port, compacted list"] = lambda: ps.qeq_apply(dense, walk, X, q)
    forms["L32 U4"] = form(0)
    forms["L32 U2"] = form(1)
    forms["L32 U8"] = form(2)
    forms["L16 U4"] = form(3)
    forms["L8 U4"] = form(7)
    forms["records alone"] = form(4)
    forms["shared memory L32, 2 blocks/SM"] = form(5, 2 * sms)
    forms["shared memory L16, 2 blocks/SM"] = form(6, 2 * sms)
    for name, fn in forms.items():
        got = fn().clone()
        torch.cuda.synchronize()
        if name == "records alone":
            continue
        rows = 2 if name == "port, no q" else 3
        c.check_qeq_rows(f"form {name}", got[:rows], ref[:rows])
    times = {k: [] for k in forms}
    for name in list(forms) + list(forms)[::-1]:
        times[name].append(c.graph_ms(forms[name], args.reps) * 1e3)
    nbytes = 8 * T + 8 * E + 4 * T + 4 * 3 * n + 4 * 3 * n
    bms, _ = c.bound(nbytes, E * c.OPS_QEQ_APPLY)
    lib_ms = c.library_apply_ms(lst, walk, X, live)
    smi = c.nvidia_smi()
    print(f"qeq_apply forms, {n} atoms, {E} entries in {T} rows "
          f"({8 * E / 1e6:.1f} MB of records), bytes bound "
          f"{bms * 1e3:.2f} us | {smi}")
    for name, ts in times.items():
        print(f"  {name}: {ts[0]:.2f}, {ts[1]:.2f} us "
              f"({bms * 1e3 / min(ts):.1%} of the bound)")
    if lib_ms is not None:
        print(f"  torch.sparse.mm over the same list: {lib_ms * 1e3:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
