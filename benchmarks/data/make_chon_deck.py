"""Write tests/data/chon168.xyz: 24 H2C=N-NO2 molecules in the RDX cell.

The cell holds RDX's composition (C24 H48 N48 O48, 168 atoms) in the RDX
orthorhombic cell 13.182 x 11.574 x 10.709 A.  Molecules sit on a jittered
3 x 4 x 2 lattice with random orientations.  Until no intermolecular
distance (minimum image) is below 2.0 A, one molecule of the closest
contact is redrawn, and the redraw is kept if it does not shorten that
molecule's own closest contact.  Output is the
geninit format read by ``system.read_geninit_xyz``: natoms + comment,
"la lb lc alpha beta gamma", then element and fractional coordinates.

    python tests/data/make_chon_deck.py [--seed 2] [--out PATH]
"""
import argparse
import os

import numpy as np

CELL = np.array([13.182, 11.574, 10.709])
LATTICE = (3, 4, 2)
MIN_DIST = 2.0


def molecule():
    """Planar H2C=N-NO2 centred on its centroid: elements and (7, 3) A."""
    c = np.zeros(3)
    n1 = np.array([1.28, 0.0, 0.0])                       # C=N
    h1 = 1.08 * np.array([np.cos(2.094), np.sin(2.094), 0.0])
    h2 = 1.08 * np.array([np.cos(2.094), -np.sin(2.094), 0.0])
    a = np.deg2rad(-62.0)
    n2 = n1 + 1.40 * np.array([np.cos(a), np.sin(a), 0.0])  # N-N
    back = (n1 - n2) / np.linalg.norm(n1 - n2)

    def rot(v, t):
        ct, st = np.cos(t), np.sin(t)
        return np.array([ct * v[0] - st * v[1], st * v[0] + ct * v[1], 0.0])

    o1 = n2 + 1.22 * rot(back, np.deg2rad(120.0))         # N-O
    o2 = n2 + 1.22 * rot(back, np.deg2rad(-120.0))
    xyz = np.stack([c, h1, h2, n1, n2, o1, o2])
    return ["C", "H", "H", "N", "N", "O", "O"], xyz - xyz.mean(axis=0)


def random_rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def min_image_dist(a, b):
    d = a[:, None, :] - b[None, :, :]
    d -= CELL * np.round(d / CELL)
    return np.sqrt((d * d).sum(-1)).min()


def build(seed, max_redraws=50000):
    rng = np.random.default_rng(seed)
    names, mol = molecule()
    spacing = CELL / np.array(LATTICE)
    sites = [(np.array([i, j, k]) + 0.5) * spacing
             for i in range(LATTICE[0]) for j in range(LATTICE[1])
             for k in range(LATTICE[2])]

    def draw(site):
        jitter = rng.uniform(-0.3, 0.3, size=3)
        return (mol @ random_rotation(rng).T + site + jitter) % CELL

    placed = [draw(s) for s in sites]
    nm = len(placed)
    dist = np.full((nm, nm), np.inf)
    for a in range(nm):
        for b in range(a + 1, nm):
            dist[a, b] = dist[b, a] = min_image_dist(placed[a], placed[b])
    for _ in range(max_redraws):
        if dist.min() >= MIN_DIST:
            return names * nm, np.concatenate(placed) / CELL
        a, b = np.unravel_index(dist.argmin(), dist.shape)
        k = a if rng.random() < 0.5 else b
        new = draw(sites[k])
        row = np.array([min_image_dist(new, placed[j]) if j != k else np.inf
                        for j in range(nm)])
        if row.min() >= dist[k].min():
            placed[k] = new
            dist[k] = row
            dist[:, k] = row
    raise RuntimeError("no placement found; try another seed")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--out", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "chon168.xyz"))
    args = p.parse_args()
    names, frac = build(args.seed)
    with open(args.out, "w") as fh:
        fh.write(f"{len(names)} synthetic H2C=N-NO2 x24 in the RDX cell "
                 f"(make_chon_deck.py --seed {args.seed})\n")
        fh.write(" ".join(f"{x:.4f}" for x in CELL) + " 90.0 90.0 90.0\n")
        for name, f in zip(names, frac):
            fh.write(f"{name} {f[0]:.8f} {f[1]:.8f} {f[2]:.8f}\n")


if __name__ == "__main__":
    main()
