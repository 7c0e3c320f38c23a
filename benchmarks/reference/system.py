"""The deck's box and cell file: the geninit reader, the replication and
the box matrix."""
from __future__ import annotations

import numpy as np


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
