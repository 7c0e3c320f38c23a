"""Trajectory writers: .xyz, .pdb, .bnd — reference-format compatible
(counterpart of rxmd_tpu.io.traj, its Python formatting path).

Single-process file writers replacing the reference's MPI-IO shared-file
machinery (ref: fileio.F90:27-355).  Each writer copies the state to host
memory once and formats there; the bytes are rxmd_tpu's for the same state.
"""
from __future__ import annotations

import numpy as np

from ..system import State
from . import host


def cell_params(H):
    H = host(H)
    la, lb, lc = np.linalg.norm(H, axis=0)
    cosg = H[:, 0] @ H[:, 1] / (la * lb)
    cosb = H[:, 0] @ H[:, 2] / (la * lc)
    cosa = H[:, 1] @ H[:, 2] / (lb * lc)
    return (la, lb, lc, np.degrees(np.arccos(np.clip(cosa, -1, 1))),
            np.degrees(np.arccos(np.clip(cosb, -1, 1))),
            np.degrees(np.arccos(np.clip(cosg, -1, 1))))


def write_xyz(path: str, state: State, atom_names, append=False):
    """Reference .xyz format (ref: fileio.F90:241-339): natoms / cell line /
    'name x y z q gid' rows."""
    la, lb, lc, al, be, ga = cell_params(state.H)
    pos = host(state.pos).astype(np.float64)
    q = host(state.q).astype(np.float64)
    types = host(state.types).astype(np.int32)
    gid = host(state.gid).astype(np.int32)
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
