"""Simulation state and box utilities (counterpart of rxmd_tpu.system).

The state is a dataclass of tensors on one device.  Integer metadata
(atom type, global id) is int64, the index type torch's gathers and
scatters take; the step counter is a host-side int.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def box_matrix(la, lb, lc, alpha, beta, gamma):
    """H-matrix with lattice vectors as columns (ref: init.F90:610-633)."""
    lal, lbe, lga = (np.deg2rad(x) for x in (alpha, beta, gamma))
    hh1 = lc * (np.cos(lal) - np.cos(lbe) * np.cos(lga)) / np.sin(lga)
    hh2 = lc * np.sqrt(
        1.0 - np.cos(lal) ** 2 - np.cos(lbe) ** 2 - np.cos(lga) ** 2
        + 2 * np.cos(lal) * np.cos(lbe) * np.cos(lga)) / np.sin(lga)
    H = np.zeros((3, 3))
    H[:, 0] = [la, 0.0, 0.0]
    H[:, 1] = [lb * np.cos(lga), lb * np.sin(lga), 0.0]
    H[:, 2] = [lc * np.cos(lbe), hh1, hh2]
    return H


_FLOAT_FIELDS = ("pos", "vel", "q", "qsfp", "qsfv", "H", "spos")


@dataclasses.dataclass
class State:
    """Per-atom dynamical state plus the periodic box."""

    pos: torch.Tensor     # (N, 3) real coordinates [A]
    vel: torch.Tensor     # (N, 3) velocities [A / internal-time]
    q: torch.Tensor       # (N,) charges [e]
    qsfp: torch.Tensor    # (N,) extended-Lagrangian fictitious charge
    qsfv: torch.Tensor    # (N,) its velocity
    types: torch.Tensor   # (N,) int64 atom type (0-based)
    gid: torch.Tensor     # (N,) int64 global atom id
    H: torch.Tensor       # (3, 3) box matrix, columns = lattice vectors
    step: int             # current MD step
    spos: torch.Tensor    # (N, 3) PQEq shell displacement from core
                          # (ref: module.F90:286; zeros unless PQEq)

    @property
    def n(self):
        return self.pos.shape[0]

    @property
    def device(self):
        return self.pos.device

    def astype(self, dtype):
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dtype) for k in _FLOAT_FIELDS})

    def to(self, device):
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self) if f.name != "step"})


def make_state(pos, types, H, vel=None, q=None, qsfp=None, qsfv=None,
               gid=None, step=0, spos=None, dtype=torch.float64,
               device="cpu"):
    def f(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    pos = f(pos)
    n = pos.shape[0]
    z = torch.zeros((n,), dtype=dtype, device=device)
    z3 = torch.zeros((n, 3), dtype=dtype, device=device)
    i64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64,
                                    device=device)
    return State(
        pos=pos,
        vel=z3 if vel is None else f(vel),
        q=z if q is None else f(q),
        qsfp=z.clone() if qsfp is None else f(qsfp),
        qsfv=z.clone() if qsfv is None else f(qsfv),
        types=i64(types),
        gid=(torch.arange(n, device=device) if gid is None else i64(gid)),
        H=f(H),
        step=int(step),
        spos=z3.clone() if spos is None else f(spos),
    )


def state_from_numpy(d: dict, dtype=torch.float64, device="cpu") -> State:
    """State from a dict of numpy arrays keyed by the State field names
    (e.g. ``{k: np.asarray(v) for k, v in vars(jax_state).items()}``)."""
    return make_state(d["pos"], d["types"], d["H"], vel=d.get("vel"),
                      q=d.get("q"), qsfp=d.get("qsfp"), qsfv=d.get("qsfv"),
                      gid=d.get("gid"), step=int(np.asarray(d.get("step", 0))),
                      spos=d.get("spos"), dtype=dtype, device=device)


def read_geninit_xyz(path: str, name_to_type: dict):
    """Read a geninit-style input cell (ref: init/geninit.F90:360-444).

    Format: natoms + comment / "la lb lc alpha beta gamma" / element + three
    fractional coordinates per line.  Returns (frac (N,3), types (N,),
    (la,lb,lc,alpha,beta,gamma)).
    """
    with open(path) as fh:
        first = fh.readline().split()
        n = int(first[0])
        cell = tuple(float(x) for x in fh.readline().split()[:6])
        frac = np.zeros((n, 3))
        types = np.zeros(n, dtype=np.int64)
        for i in range(n):
            tok = fh.readline().split()
            types[i] = name_to_type[tok[0]]
            frac[i] = [float(tok[1]), float(tok[2]), float(tok[3])]
    return frac, types, cell


def replicate(frac, types, cell, mc=(1, 1, 1)):
    """Replicate a unit cell mc times per axis (ref: geninit.F90:446-478).

    Returns fractional coords in the supercell and the supercell parameters.
    """
    la, lb, lc, al, be, ga = cell
    mc = np.asarray(mc)
    out_frac = []
    out_types = []
    for ix in range(mc[0]):
        for iy in range(mc[1]):
            for iz in range(mc[2]):
                out_frac.append((frac + np.array([ix, iy, iz])) / mc)
                out_types.append(types)
    frac_s = np.concatenate(out_frac) % 1.0
    types_s = np.concatenate(out_types)
    cell_s = (la * mc[0], lb * mc[1], lc * mc[2], al, be, ga)
    return frac_s, types_s, cell_s


def from_cellfile(path, name_to_type, mc=(1, 1, 1), dtype=torch.float64,
                  device="cpu"):
    """Build a State from a geninit input cell, optionally replicated."""
    frac, types, cell = read_geninit_xyz(path, name_to_type)
    frac, types, cell = replicate(frac, types, cell, mc)
    H = box_matrix(*cell)
    pos = frac @ H.T
    return make_state(pos, types, H, dtype=dtype, device=device)
