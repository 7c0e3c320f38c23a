"""A cell on several cards: one process per card, each a rank of one
process group, started and watched by the benchmark's own process (the
launcher).

`launch(chips, command, deadline, t0)` starts `chips` copies of
`command`, each in a session of its own, with the port's launch variables
(RXMD_COORDINATOR on a free local port, RXMD_NUM_PROCESSES,
RXMD_PROCESS_ID: rank r takes card r) and the launcher's start and process
id.  Their standard output and error go to files under TMPDIR.  Once every
rank has exited 0 it writes the other ranks' standard error, then rank
0's (whose last lines are its checks), and returns rank 0's last line of
standard output, for the launcher to print unchanged.  If a rank exits
otherwise, or the deadline passes first, it kills every rank's session,
waits for them, writes the end of each rank's standard error and returns
non-zero without a result line: a rank that dies inside a collective
leaves the others waiting in it, and nothing else would end them.

The deadline: `--seconds` plus a set-up allowance, SETUP_ALLOWANCE_S.  A
run must end within 360 s, so a group that hangs is ended by the launcher,
not cut by its caller, while a sound run (set-up with a checkout's first
build of the port's kernels, the window, a traced sub-window, the gathers
and the reference on rank 0) has room.

A rank (`is_rank()`) dies with its launcher (`die_with_launcher`) and
counts its set-up from the launcher's start (`start_time()`).  The
launcher counts the cards with libcuda (`cards()`) and imports no
torch: its ranks' set-up starts the sooner.
"""
from __future__ import annotations

import ctypes
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

ENV_T0 = "RXMD_BENCH_T0"              # the launcher's start, CLOCK_MONOTONIC
ENV_LAUNCHER = "RXMD_BENCH_LAUNCHER"  # the launcher's process id
SETUP_ALLOWANCE_S = 300.0
PR_SET_PDEATHSIG = 1


class Ended(Exception):
    """The launcher was asked to end (SIGTERM, SIGINT)."""


def deadline_s(seconds):
    return seconds + SETUP_ALLOWANCE_S


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cards():
    """The CUDA cards this process sees, as libcuda counts them (which
    honours CUDA_VISIBLE_DEVICES), without importing torch; 0 without
    libcuda."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    n = ctypes.c_int(0)
    if cuda.cuInit(0) != 0 or cuda.cuDeviceGetCount(ctypes.byref(n)) != 0:
        return 0
    return n.value


def is_rank():
    return ENV_T0 in os.environ


def start_time():
    """The launcher's start on this process's time.perf_counter."""
    ago = time.clock_gettime(time.CLOCK_MONOTONIC) - float(os.environ[ENV_T0])
    return time.perf_counter() - ago


def die_with_launcher():
    """Have the kernel kill this rank when its launcher ends (Linux)."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    if os.getppid() != int(os.environ[ENV_LAUNCHER]):
        os._exit(1)                     # the launcher ended before the call


def _tail(fh, limit):
    fh.flush()
    fh.seek(0, os.SEEK_END)
    size = fh.tell()
    fh.seek(max(size - limit, 0))
    return fh.read().decode(errors="replace")


def _kill(procs):
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for p in procs:
        p.wait()


def launch(chips, command, deadline, t0):
    """Run `command` as `chips` ranks (module docstring): (exit code, rank
    0's result line or None).  `t0`: the launcher's start on its
    time.perf_counter; `deadline` in seconds from it."""
    start = time.clock_gettime(time.CLOCK_MONOTONIC) - (time.perf_counter()
                                                        - t0)
    env = dict(os.environ, RXMD_COORDINATOR=f"127.0.0.1:{free_port()}",
               RXMD_NUM_PROCESSES=str(chips))
    env.update({ENV_T0: repr(start), ENV_LAUNCHER: str(os.getpid())})
    ends = {signal.SIGTERM: None, signal.SIGINT: None}

    def end(signum, frame):
        raise Ended(signal.Signals(signum).name)
    for sig in ends:
        ends[sig] = signal.signal(sig, end)
    outs = [tempfile.TemporaryFile() for _ in range(chips)]
    errs = [tempfile.TemporaryFile() for _ in range(chips)]
    procs, failed, why = [], None, None
    try:
        for r in range(chips):
            procs.append(subprocess.Popen(
                command, env=dict(env, RXMD_PROCESS_ID=str(r)),
                stdin=subprocess.DEVNULL, stdout=outs[r], stderr=errs[r],
                start_new_session=True))
            print(f"launch: rank {r} pid {procs[-1].pid}", file=sys.stderr)
        stop_at = t0 + deadline
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                why = f"rank {failed} exited with code {codes[failed]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() >= stop_at:
                why = (f"the ranks were not done {deadline:.0f} s after the "
                       f"launcher's start (ranks still running: "
                       f"{[r for r, c in enumerate(codes) if c is None]})")
                break
            time.sleep(0.05)
    except Ended as e:
        why = f"the launcher was ended ({e})"
    finally:
        _kill(procs)
        for sig, old in ends.items():
            signal.signal(sig, old)
    try:
        if why is None:
            for r in range(1, chips):
                sys.stderr.write(_tail(errs[r], 4000))
            sys.stderr.write(_tail(errs[0], 1 << 20))
            sys.stderr.flush()
            lines = _tail(outs[0], 1 << 20).strip().splitlines()
            if not lines:
                print("launch: rank 0 printed no result", file=sys.stderr)
                return 1, None
            return 0, lines[-1]
        for r in range(chips):
            if r != failed:
                sys.stderr.write(f"--- rank {r}, the end of its standard "
                                 "error:\n" + _tail(errs[r], 1500) + "\n")
        if failed is not None:
            sys.stderr.write(f"--- rank {failed}, the end of its standard "
                             "error:\n" + _tail(errs[failed], 4000) + "\n")
        print(f"launch: {why}; every rank was killed, no result",
              file=sys.stderr, flush=True)
        code = procs[failed].returncode if failed is not None else 124
        return (code if code and code > 0 else 1), None
    finally:
        for fh in outs + errs:
            fh.close()
