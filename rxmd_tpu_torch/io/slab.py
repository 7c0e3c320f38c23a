"""Parallel output without gathering positions: every process writes only
its own residents (counterpart of rxmd_tpu.io.slab).

The reference writes its trajectory and restart files as MPI-IO shared
files at per-rank offsets from an MPI_Scan (ref: fileio.F90:81-95,
587-643).  Here each rank of the sharded engine writes its residents into
one shared file at precomputed byte offsets, between barriers.

  * `write_xyz_slab`: fixed-width xyz records indexed by global atom id,
    atom g's record at `header + g*XYZ_REC`: no offsets to exchange, and
    the bytes are those of traj.write_xyz of the gathered state;
  * `write_bin_slab`: the reference rxff.bin with one slab per domain,
    rank order x fastest, local normalized coordinates; the only traffic
    is the per-domain atom counts (the MPI_Scan analog).  The bytes are
    those of refbin.write_rxff_bin(gathered state, vprocs=mesh) whenever
    every atom lies in its own domain, as after a rebuild's migration.
"""
from __future__ import annotations

import numpy as np
import torch

from .refbin import box_cell, encode_atype
from .traj import cell_params

XYZ_REC = 57        # bytes: name(3) + 3*12 coords + 8 q + 9 gid + newline


def _residents(engine):
    """This rank's residents as float64/int numpy arrays in gid order,
    rounded through the engine's dtype as the gathered state is."""
    from ..parallel.engine import host_positions
    s = engine.sstate
    valid = s.valid.cpu().numpy()
    gid = s.gid.cpu().numpy()[valid]
    order = np.argsort(gid, kind="stable")
    H = engine.Hg.cpu().numpy()

    def field(x):
        return x.cpu().numpy()[valid][order]

    pos = host_positions(field(s.frac), H)
    # the gathered State holds the engine's dtype: round through it
    pos = torch.as_tensor(pos).to(engine.dtype).double().numpy()
    return dict(gid=gid[order], pos=pos, types=field(s.types),
                **{k: field(getattr(s, k)).astype(np.float64)
                   for k in ("vel", "q", "qsfp", "qsfv")})


def write_xyz_slab(path, engine):
    """Write the sharded state as .xyz: each rank writes its residents'
    records at `header + gid*XYZ_REC` (a collective)."""
    comm = engine.comm
    n = engine.n
    la, lb, lc, al, be, ga = cell_params(engine.Hg)
    header = (f"{n:9d}\n"
              f"{la:12.5f}{lb:12.5f}{lc:12.5f}"
              f"{al:8.3f}{be:8.3f}{ga:8.3f}\n").encode()
    if comm.rank == 0:
        with open(path, "wb") as fh:
            fh.write(header)
            fh.truncate(len(header) + n * XYZ_REC)
    comm.barrier()
    r = _residents(engine)
    names = engine.ff.atom_names
    gid = r["gid"]
    if len(gid):
        rec = b"".join(
            (f"{names[t]:<3s}{p[0]:12.5f}{p[1]:12.5f}{p[2]:12.5f}"
             f"{qk:8.3f}{g:9d}\n").encode()
            for t, p, qk, g in zip(r["types"], r["pos"], r["q"], gid))
        # contiguous gid runs coalesce into few writes
        runs = np.flatnonzero(np.diff(gid) != 1)
        starts = np.concatenate([[0], runs + 1])
        ends = np.concatenate([runs + 1, [len(gid)]])
        with open(path, "r+b") as fh:
            for a, b in zip(starts, ends):
                fh.seek(len(header) + int(gid[a]) * XYZ_REC)
                fh.write(rec[a * XYZ_REC:b * XYZ_REC])
    comm.barrier()


def write_bin_slab(path, engine, step=None):
    """Write the sharded state as a reference rxff.bin, one slab per domain
    (ref: fileio.F90:587-643), rank order x fastest (init.F90:74-76); a
    collective whose only traffic is the per-domain counts."""
    comm = engine.comm
    nx, ny, nz = engine.mesh_shape
    ndev = nx * ny * nz
    H = engine.Hg.cpu().numpy()
    Hi = np.linalg.inv(H)
    step = engine.step_count if step is None else step
    r = _residents(engine)
    cnt = len(r["gid"])
    # the gathered writer's arithmetic on these rows: fractional
    # coordinates from the positions, less the domain's origin
    frac = (r["pos"] @ Hi.T) % 1.0
    ix, iy, iz = comm.coords
    body = np.zeros((cnt, 10))
    body[:, 0:3] = frac - np.array([ix / nx, iy / ny, iz / nz])
    body[:, 3:6] = r["vel"]
    body[:, 6] = r["q"]
    body[:, 7] = encode_atype(r["types"], r["gid"])
    body[:, 8] = r["qsfp"]
    body[:, 9] = r["qsfv"]

    # the MPI_Scan analog: every domain's count; reference rank
    # ix + iy*nx + iz*nx*ny of domain d = (ix*ny + iy)*nz + iz
    counts = comm.all_gather(torch.tensor(
        [cnt], device=engine.device)).reshape(-1).cpu().numpy()
    rank_of = np.array([
        (d // (ny * nz)) + ((d // nz) % ny) * nx + (d % nz) * nx * ny
        for d in range(ndev)])
    by_rank = np.zeros(ndev, np.int32)
    by_rank[rank_of] = counts
    head = 4 * (4 + ndev + 1) + 8 * 6
    offset = head + 80 * int(by_rank[:rank_of[comm.rank]].sum())
    if comm.rank == 0:
        with open(path, "wb") as fh:
            np.array([ndev, nx, ny, nz], np.int32).tofile(fh)
            by_rank.tofile(fh)
            np.array([step], np.int32).tofile(fh)
            np.asarray(box_cell(H), np.float64).tofile(fh)
            fh.truncate(head + 80 * int(counts.sum()))
    comm.barrier()
    if cnt:
        with open(path, "r+b") as fh:
            fh.seek(offset)
            body.astype(np.float64).tofile(fh)
    comm.barrier()
