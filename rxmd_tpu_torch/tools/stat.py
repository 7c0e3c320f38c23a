"""Post-run structural analysis over .xyz trajectory frames (a numpy copy
of rxmd_tpu.tools.stat).

Re-implements util/stat (ref: util/stat/{main,stat,voxels}.f90): partial pair
distribution functions g_ab(r), coordination numbers n_ab(r), neutron-weighted
total G(r), structure factor S(q) via the Fourier-Bessel transform of g(r)-1
(ref: stat.f90:136-287), and bond-angle distributions.  Vectorized NumPy;
orthogonal cells with minimum-image + explicit image expansion for r beyond
L/2.
"""
from __future__ import annotations

import numpy as np

# coherent neutron scattering lengths [fm] for common elements
# (the reference reads these from its NSD table)
NEUTRON_B = {"H": -3.739, "C": 6.646, "N": 9.36, "O": 5.803, "S": 2.847,
             "Si": 4.149, "Al": 3.449, "Mo": 6.715, "Fe": 9.45, "X": 0.0}


def pair_distances(pos, box, rcut):
    """All pair distances < rcut under periodic boundary conditions.
    Returns (i, j, r) arrays with i<j (orthogonal box)."""
    box = np.asarray(box)
    nimg = np.ceil(rcut / box).astype(int)
    shifts = np.array(np.meshgrid(*[np.arange(-k, k + 1) for k in nimg],
                                  indexing="ij")).reshape(3, -1).T
    ii, jj, rr = [], [], []
    n = len(pos)
    for s in shifts:
        off = s * box
        d = pos[:, None, :] - (pos[None, :, :] + off)
        r = np.sqrt((d * d).sum(-1))
        if (s == 0).all():
            iu, ju = np.triu_indices(n, 1)
            m = r[iu, ju] < rcut
            ii.append(iu[m]); jj.append(ju[m]); rr.append(r[iu, ju][m])
        else:
            iu, ju = np.nonzero(r < rcut)
            m = iu <= ju           # count each image pair once
            ii.append(iu[m]); jj.append(ju[m]); rr.append(r[iu, ju][m])
    return np.concatenate(ii), np.concatenate(jj), np.concatenate(rr)


class PairAnalysis:
    """Accumulates g(r)/n(r)/S(q) over frames (ref: analysis_context,
    stat.f90:291-345)."""

    def __init__(self, names, rcut=10.0, dr=0.05, qmax=20.0, dq=0.05):
        self.names = list(names)
        self.nt = len(self.names)
        self.rcut = rcut
        self.dr = dr
        self.nbin = int(rcut / dr)
        self.hist = np.zeros((self.nt, self.nt, self.nbin))
        self.qs = np.arange(dq, qmax, dq)
        self.frames = 0
        self.natoms_per_type = np.zeros(self.nt)
        self.volume = 0.0
        self.natoms = 0

    def add_frame(self, pos, types, box):
        i, j, r = pair_distances(np.asarray(pos), box, self.rcut)
        ti, tj = types[i], types[j]
        k = np.minimum((r / self.dr).astype(int), self.nbin - 1)
        for a in range(self.nt):
            for b in range(self.nt):
                m = (ti == a) & (tj == b)
                np.add.at(self.hist[a, b], k[m], 1.0)
        self.frames += 1
        self.natoms = len(pos)
        self.volume = float(np.prod(box))
        self.natoms_per_type = np.bincount(types, minlength=self.nt).astype(
            float)

    def results(self):
        """-> dict with r, gr (nt,nt,nbin), nr, Gnr, q, Snq."""
        nt, nbin = self.nt, self.nbin
        r = (np.arange(nbin) + 1) * self.dr
        rho = self.natoms / self.volume
        conc = self.natoms_per_type / self.natoms
        # directed pair counts: unordered histogram counted for both orders
        cnt = self.hist + self.hist.transpose(1, 0, 2)
        gr = np.zeros_like(cnt)
        nr = np.zeros_like(cnt)
        for a in range(nt):
            na = max(self.natoms_per_type[a], 1)
            for b in range(nt):
                shell = 4 * np.pi * r * r * self.dr * rho * conc[b]
                gr[a, b] = cnt[a, b] / (shell * na * max(self.frames, 1))
                nr[a, b] = np.cumsum(cnt[a, b]) / (na * max(self.frames, 1))
        bl = np.array([NEUTRON_B.get(s, 0.0) for s in self.names])
        denom = (bl * conc).sum() ** 2
        Gnr = np.einsum("abk,a,b,a,b->k", gr, conc, conc, bl, bl) / max(
            denom, 1e-30)
        # S(q) via sin(qr)/(qr) integral of (g-1) (ref: stat.f90:221-235)
        q = self.qs
        integ = np.zeros((nt, nt, len(q)))
        for a in range(nt):
            for b in range(nt):
                h = gr[a, b] - 1.0
                integ[a, b] = (r[None, :] ** 2 * h[None, :]
                               * np.sinc(q[:, None] * r[None, :] / np.pi)
                               ).sum(1) * self.dr
        sq = np.eye(nt)[:, :, None] + 4 * np.pi * rho * np.sqrt(
            np.outer(conc, conc))[:, :, None] * integ
        Snq = np.einsum("abk,a,b,a,b->k", sq - np.eye(nt)[:, :, None], conc,
                        conc, bl, bl) / max(denom, 1e-30) + 1.0
        return {"r": r, "gr": gr, "nr": nr, "Gnr": Gnr, "q": q, "sq": sq,
                "Snq": Snq}

    def save(self, gr_path="gr.dat", sq_path="sq.dat"):
        """Write gr.dat / sq.dat in the reference's column layout
        (ref: stat.f90:146-287)."""
        res = self.results()
        nt = self.nt
        with open(gr_path, "w") as fh:
            fh.write(" distance")
            for a in range(nt):
                for b in range(nt):
                    fh.write(f" {self.names[a]}-{self.names[b]}(gr)".rjust(13))
            for a in range(nt):
                for b in range(nt):
                    fh.write(f" {self.names[a]}-{self.names[b]}(nr)".rjust(13))
            fh.write("  Gnr\n")
            for k in range(self.nbin):
                fh.write(f"{res['r'][k]:12.5f}")
                for a in range(nt):
                    for b in range(nt):
                        fh.write(f"{res['gr'][a, b, k]:12.5f} ")
                for a in range(nt):
                    for b in range(nt):
                        fh.write(f"{res['nr'][a, b, k]:12.5f} ")
                fh.write(f"{res['Gnr'][k]:12.5f}\n")
        with open(sq_path, "w") as fh:
            fh.write(" wave_number  Snq\n")
            for k, qv in enumerate(res["q"]):
                fh.write(f"{qv:12.5f}{res['Snq'][k]:12.5f}\n")
        return res


def bond_angle_distribution(pos, types, box, rcuts, nbins=180):
    """Bond-angle distributions per (i,j,k) type triple with per-pair bond
    cutoffs `rcuts[(a,b)]` (ref: main.f90 angle part).  Returns dict
    {(a,b,c): histogram over [0,180] degrees} with central atom b."""
    pos = np.asarray(pos)
    i, j, r = pair_distances(pos, box, max(rcuts.values()))
    # build bonded pairs subject to per-type cutoffs (both directions)
    keep = r < np.array([rcuts.get((types[a], types[b]), 0.0)
                         for a, b in zip(i, j)])
    bi = np.concatenate([i[keep], j[keep]])
    bj = np.concatenate([j[keep], i[keep]])
    hists = {}
    order = np.argsort(bi, kind="stable")
    bi, bj = bi[order], bj[order]
    starts = np.searchsorted(bi, np.arange(len(pos) + 1))
    box = np.asarray(box)
    for c in range(len(pos)):
        nb = bj[starts[c]:starts[c + 1]]
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                d1 = pos[nb[x]] - pos[c]
                d2 = pos[nb[y]] - pos[c]
                d1 -= box * np.round(d1 / box)
                d2 -= box * np.round(d2 / box)
                cosv = d1 @ d2 / np.sqrt((d1 @ d1) * (d2 @ d2))
                ang = np.degrees(np.arccos(np.clip(cosv, -1, 1)))
                key = (types[nb[x]], types[c], types[nb[y]])
                key = key if key[0] <= key[2] else key[::-1]
                h = hists.setdefault(key, np.zeros(nbins))
                h[min(int(ang / 180.0 * nbins), nbins - 1)] += 1
    return hists
