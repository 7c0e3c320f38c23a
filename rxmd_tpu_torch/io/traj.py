"""Trajectory writers: .xyz, .pdb, .bnd — reference-format compatible
(counterpart of rxmd_tpu.io.traj).

Single-process file writers replacing the reference's MPI-IO shared-file
machinery (ref: fileio.F90:27-355).  Each writer copies the state to host
memory once and formats there; the bytes are rxmd_tpu's for the same state.

`write_xyz` formats its rows in C++, as rxmd_tpu does through
native/libtrajio.so: the port's copy of that source, csrc/trajio.cpp, is
built at first use with the host C++ compiler ($CXX, else g++) into
build/rxmd_tpu_torch/ and loaded by ctypes.  A failed build or load raises
with the compiler's message, and so does a failed write; nothing falls back
to the Python formatting, which stays as `write_xyz_plain`.  The two agree
byte for byte but where C and Python format differently: a negative NaN
(glibc "-nan", Python "nan"), a name longer than 3 characters (C cuts it
to 3) and a type outside the name table (C takes type 0).  `write_pdb` and
`write_bnd` are Python, as rxmd_tpu's are.
"""
from __future__ import annotations

import ctypes
import os
import shlex

import numpy as np

from .. import native
from ..system import State
from . import host

_SRC = native.source("trajio.cpp")
_lib = None


def build():
    """Compile csrc/trajio.cpp with the host C++ compiler ($CXX, split as a
    shell would, else g++) unless built (native.build); returns the
    library's path.  Raises with the compiler's message if it fails."""
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    return native.build(_SRC, cxx=cxx)[0]


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.trajio_write_xyz.argtypes = [ctypes.c_char_p, ctypes.c_int, i64,
                                         vp, vp, vp, vp, vp, vp, i64]
        lib.trajio_write_xyz.restype = ctypes.c_int
        _lib = lib
    return _lib


def cell_params(H):
    H = host(H)
    la, lb, lc = np.linalg.norm(H, axis=0)
    cosg = H[:, 0] @ H[:, 1] / (la * lb)
    cosb = H[:, 0] @ H[:, 2] / (la * lc)
    cosa = H[:, 1] @ H[:, 2] / (lb * lc)
    return (la, lb, lc, np.degrees(np.arccos(np.clip(cosa, -1, 1))),
            np.degrees(np.arccos(np.clip(cosb, -1, 1))),
            np.degrees(np.arccos(np.clip(cosg, -1, 1))))


def _xyz_columns(state: State):
    """The cell parameters and the per-atom columns of an .xyz frame, on
    the host: float64 positions and charges, int32 types and gids."""
    c = lambda x, dt: np.ascontiguousarray(host(x), dt)
    return (cell_params(state.H), c(state.pos, np.float64),
            c(state.q, np.float64), c(state.types, np.int32),
            c(state.gid, np.int32))


def write_xyz(path: str, state: State, atom_names, append=False):
    """Reference .xyz format (ref: fileio.F90:241-339): natoms / cell line /
    'name x y z q gid' rows, formatted by csrc/trajio.cpp (see the module
    docstring) with rxmd_tpu's arguments (rxmd_tpu/io/traj.py:56-69)."""
    cell, pos, q, types, gid = _xyz_columns(state)
    names = np.zeros((len(atom_names), 3), np.int8)
    for i, s in enumerate(atom_names):
        names[i] = np.frombuffer(s.encode()[:3].ljust(3), np.int8)
    cell = np.asarray(cell, np.float64)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = _library().trajio_write_xyz(
        os.fsencode(path), int(append), state.n, ptr(cell), ptr(pos), ptr(q),
        ptr(types), ptr(gid), ptr(names), len(atom_names))
    if rc != 0:
        raise OSError(f"trajio_write_xyz could not write {path} (rc {rc})")


def write_xyz_plain(path: str, state: State, atom_names, append=False):
    """write_xyz's frame formatted in Python (rxmd_tpu's Python path)."""
    (la, lb, lc, al, be, ga), pos, q, types, gid = _xyz_columns(state)
    with open(path, "a" if append else "w") as fh:
        fh.write(f"{state.n:9d}\n")
        fh.write(f"{la:12.5f}{lb:12.5f}{lc:12.5f}{al:8.3f}{be:8.3f}{ga:8.3f}\n")
        for i in range(state.n):
            fh.write(f"{atom_names[types[i]]:<3s}"
                     f"{pos[i, 0]:12.5f}{pos[i, 1]:12.5f}{pos[i, 2]:12.5f}"
                     f"{q[i]:8.3f}{gid[i]:9d}\n")


def write_pdb(path: str, state: State, atom_names):
    """Reference .pdb format (ref: fileio.F90:151-232): the B-factor column
    carries the charge (the reference overwrites tt with q, fileio.F90:212)."""
    pos = host(state.pos)
    q = host(state.q)
    types = host(state.types)
    gid = host(state.gid)
    with open(path, "w") as fh:
        for i in range(state.n):
            fh.write(f"{'ATOM  ':6s}{0:5d} {atom_names[types[i]]:>2s}"
                     f"{gid[i]:12d}    "
                     f"{pos[i, 0]:8.3f}{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}"
                     f"{q[i]:6.2f}{0.0:6.2f}\n")


def write_bnd(path: str, state: State, bond_gid, bond_bo, bond_count):
    """Reference .bnd format (ref: fileio.F90:27-148): per atom one line
    'gid x y z type nbonds [gid bo]...', bonds with BO > 0.3 only.

    bond_gid: (N, K) int global ids of bonded partners (-1 pad)
    bond_bo:  (N, K) bond orders
    bond_count: (N,) number of listed bonds
    """
    pos = host(state.pos)
    types = host(state.types)
    gid = host(state.gid)
    bond_gid = host(bond_gid)
    bond_bo = host(bond_bo)
    bond_count = host(bond_count)
    with open(path, "w") as fh:
        for i in range(state.n):
            nb = int(bond_count[i])
            line = (f"{gid[i]:012d} "
                    f"{pos[i, 0]:12.3f}{pos[i, 1]:12.3f}{pos[i, 2]:12.3f} "
                    f"{types[i] + 1:3d}{nb:3d}")
            for k in range(nb):
                line += f" {int(bond_gid[i, k]):012d}{bond_bo[i, k]:6.3f}"
            fh.write(line.strip() + "\n")


def read_xyz_frames(path: str, name_to_type=None):
    """Iterate frames of a (possibly concatenated) reference .xyz file.
    Yields dicts with pos, q, gid, types/names, cell."""
    with open(path) as fh:
        while True:
            head = fh.readline()
            if not head.strip():
                return
            n = int(head.split()[0])
            cell = tuple(float(x) for x in fh.readline().split()[:6])
            names, pos, q, gid = [], [], [], []
            for _ in range(n):
                tok = fh.readline().split()
                names.append(tok[0])
                pos.append([float(tok[1]), float(tok[2]), float(tok[3])])
                q.append(float(tok[4]) if len(tok) > 4 else 0.0)
                gid.append(int(tok[5]) if len(tok) > 5 else 0)
            out = {"names": names, "pos": np.array(pos), "q": np.array(q),
                   "gid": np.array(gid), "cell": cell}
            if name_to_type is not None:
                out["types"] = np.array([name_to_type[s] for s in names],
                                        np.int32)
            yield out
