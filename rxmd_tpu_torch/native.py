"""The port's native libraries: the sources of csrc/ (the CUDA kernels of
ops/ and device marks of utils/timers.py with nvcc, io/traj.py's writer
with the host C++ compiler), each built at its first use into
build/rxmd_tpu_torch/ (keyed by a hash of the source, the host compiler
and the flags) and loaded by ctypes, and the checks their wrappers make: a
CUDA tensor goes to the kernel and a CPU tensor to the plain PyTorch
version (`device_kind`), and a tensor of another dtype, shape or device,
or a strided one, is refused before any launch (`check`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rxmd_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O2", "-fPIC", "-shared"]


def source(name):
    """The path of csrc/`name`."""
    return os.path.join(_PKG, "csrc", name)


def nvcc():
    """nvcc on the PATH, else under $CUDA_HOME (/usr/local/cuda)."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = shutil.which("nvcc") or (cand if os.path.exists(cand) else None)
    if path is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from csrc/ at first use")
    return path


def build(src: str, force: bool = False, verbose: bool = False, cxx=None):
    """Compile `src` (a source with a plain C interface) with nvcc, or with
    the host C++ compiler `cxx` (its command as a list), into BUILD_DIR
    unless that library exists or `force`: (its path, seconds compiling,
    nvcc's messages: with `verbose`, -Xptxas -v's registers, shared memory
    and spills of each kernel, which leaves the binary as it is)."""
    flags = NVCC_FLAGS if cxx is None else CXX_FLAGS
    with open(src, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join((cxx or []) + flags)
                             .encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{key.hexdigest()[:16]}.so")
    if os.path.exists(so) and not force:
        return so, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    flags = flags + (["-Xptxas", "-v"] if verbose else [])
    what = "nvcc" if cxx is None else f"C++ compiler {cxx}"
    t0 = time.perf_counter()
    try:
        res = subprocess.run([*(cxx or [nvcc()]), *flags, "-o", tmp, src],
                             capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"{what} failed on {src}: {err}") from err
    if res.returncode != 0:
        raise RuntimeError(f"{what} failed on {src}:\n{res.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, res.stderr


def load(src, error_string, **argtypes):
    """The library built from `src`, loaded: each function of `argtypes`
    (name -> its argument types) returns an error code, and a call that
    returns one raises with the message of the function `error_string`."""
    lib = ctypes.CDLL(build(src)[0])
    message = getattr(lib, error_string)
    message.argtypes, message.restype = [ctypes.c_int], ctypes.c_char_p

    def raise_on(err, fn, args):
        if err:
            raise RuntimeError(f"{fn.__name__} launch failed: "
                               f"{message(err).decode()}")
        return err
    for name, args in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype, fn.errcheck = args, ctypes.c_int, raise_on
    return lib


def check(what, t, dtype, shape, device):
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        got = "" if t.is_contiguous() else ", strided"
        raise ValueError(f"{what}: takes a contiguous {str(dtype)[6:]} "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{str(t.dtype)[6:]} {tuple(t.shape)} on {t.device}"
                         f"{got}")


def device_kind(t, what):
    """'cuda' or 'cpu' for a wrapper's branch; any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} kernel for device {t.device}")
    return t.device.type


def stream(device):
    """`device`'s current CUDA stream, as a launch takes it."""
    return torch.cuda.current_stream(device).cuda_stream
