"""Reference-compatible binary configuration files (rxff.bin), the
counterpart of rxmd_tpu.io.refbin.

Format (ref: fileio.F90:444-653 and geninit.F90:539-578):
  int32 header: nprocs, vprocs(3), natoms-per-rank[nprocs], current_step
  6 float64: lata, latb, latc, lalpha, lbeta, lgamma
  per-rank contiguous slabs of 10 float64 per atom:
    pos_norm(3), v(3), q, atype, qsfp, qsfv
atype encodes the 1-based type in the integer part and the global atom id as
fractional part * 1e-13 (ref: geninit.F90:459, decoded by l2g main.F90:582).
"""
from __future__ import annotations

import numpy as np
import torch

from ..system import State, box_matrix, make_state
from . import host


def decode_atype(atype):
    """-> (0-based type, global id) (ref: main.F90:582-593)."""
    ity = np.rint(atype).astype(np.int64)
    gid = np.rint((atype - ity) * 1e13).astype(np.int64)
    return (ity - 1).astype(np.int32), gid.astype(np.int32)


def encode_atype(types0, gid):
    return (np.asarray(types0, np.float64) + 1.0
            + np.asarray(gid, np.float64) * 1e-13)


def read_rxff_bin(path: str, dtype=torch.float64, device="cpu"):
    """Read a reference rxff.bin into a State (all ranks concatenated)."""
    with open(path, "rb") as fh:
        head = np.fromfile(fh, np.int32, 4)
        nprocs = int(head[0])
        vprocs = tuple(int(x) for x in head[1:4])
        counts = np.fromfile(fh, np.int32, nprocs)
        step = int(np.fromfile(fh, np.int32, 1)[0])
        cell = np.fromfile(fh, np.float64, 6)
        n = int(counts.sum())
        body = np.fromfile(fh, np.float64, n * 10).reshape(n, 10)
    H = box_matrix(*cell)
    pos = body[:, 0:3] @ H.T                       # normalized -> real
    # per-rank slabs store LOCAL normalized coords (the rank origin OBOX is
    # subtracted both by geninit, geninit.F90:509-515, and by WriteBIN's
    # xu2xs, main.F90:596-616); add it back.  Rank id is x-fastest:
    # myid = ix + iy*vx + iz*vx*vy (ref: init.F90:74-76, geninit.F90:499).
    if nprocs > 1:
        off = 0
        for k in range(nprocs):
            ix = k % vprocs[0]
            iy = (k // vprocs[0]) % vprocs[1]
            iz = k // (vprocs[0] * vprocs[1])
            c = int(counts[k])
            obox = np.array([ix / vprocs[0], iy / vprocs[1],
                             iz / vprocs[2]])
            pos[off:off + c] = (body[off:off + c, 0:3] + obox) @ H.T
            off += c
    types0, gid = decode_atype(body[:, 7])
    st = make_state(pos, types0, H, vel=body[:, 3:6], q=body[:, 6],
                    qsfp=body[:, 8], qsfv=body[:, 9], gid=gid, step=step,
                    dtype=dtype, device=device)
    return st, {"nprocs": nprocs, "vprocs": vprocs, "counts": counts,
                "cell": tuple(cell)}


def box_cell(H):
    """(la, lb, lc, alpha, beta, gamma) of a box matrix, as the header of
    rxff.bin holds them."""
    H = host(H)
    la, lb, lc = np.linalg.norm(H, axis=0)
    cosg = H[:, 0] @ H[:, 1] / (la * lb)
    cosb = H[:, 0] @ H[:, 2] / (la * lc)
    cosa = H[:, 1] @ H[:, 2] / (lb * lc)
    return (la, lb, lc, np.degrees(np.arccos(cosa)),
            np.degrees(np.arccos(cosb)), np.degrees(np.arccos(cosg)))


def write_rxff_bin(path: str, state: State, cell=None, vprocs=(1, 1, 1),
                   step=None):
    """Write a State as a reference rxff.bin.

    With vprocs != (1,1,1), atoms are binned into the rank grid and written
    as per-rank slabs with LOCAL normalized coordinates, exactly like the
    reference's WriteBIN (fileio.F90:587-643) — so the reference can
    restart at that processor layout (it requires the file's layout to
    match, fileio.F90:492).  Rank order is x-fastest (init.F90:74-76).
    """
    H = host(state.H)
    if cell is None:
        cell = box_cell(H)
    n = state.n
    Hi = np.linalg.inv(H)
    frac = (host(state.pos) @ Hi.T) % 1.0
    body = np.zeros((n, 10))
    body[:, 0:3] = frac
    body[:, 3:6] = host(state.vel)
    body[:, 6] = host(state.q)
    body[:, 7] = encode_atype(host(state.types), host(state.gid))
    body[:, 8] = host(state.qsfp)
    body[:, 9] = host(state.qsfv)
    step = int(state.step) if step is None else step

    vprocs = tuple(int(v) for v in vprocs)
    nprocs = int(np.prod(vprocs))
    if nprocs > 1:
        vp = np.asarray(vprocs)
        cellidx = np.minimum((frac * vp).astype(int), vp - 1)
        rank = (cellidx[:, 0] + cellidx[:, 1] * vprocs[0]
                + cellidx[:, 2] * vprocs[0] * vprocs[1])
        order = np.argsort(rank, kind="stable")
        body = body[order]
        rank = rank[order]
        counts = np.bincount(rank, minlength=nprocs).astype(np.int32)
        # subtract each rank's origin (the xu2xs convention)
        obox = (cellidx[order].astype(np.float64) / vp)
        body[:, 0:3] -= obox
    else:
        counts = np.array([n], np.int32)

    with open(path, "wb") as fh:
        np.array([nprocs, *vprocs], np.int32).tofile(fh)
        counts.tofile(fh)
        np.array([step], np.int32).tofile(fh)
        np.asarray(cell, np.float64).tofile(fh)
        body.astype(np.float64).tofile(fh)
