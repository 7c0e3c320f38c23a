"""Bond lifetime analysis over .bnd trajectory frames (a copy of
rxmd_tpu.tools.bondlifetime).

    python -m rxmd_tpu_torch.tools.bondlifetime ["DAT/*.bnd"] [threshold]

Re-implements util/script/BondLifeTime.cpp (ref: BondLifeTime.cpp:1-120):
reads a sequence of .bnd files, averages the presence of each (gid_i, gid_j)
bond over frames, and prints bonds whose occupancy exceeds a threshold.
"""
from __future__ import annotations

import collections
import glob
import sys


def read_bnd(path):
    """-> list of (gid, type, [(gid_j, bo), ...]) per atom."""
    out = []
    with open(path) as fh:
        for line in fh:
            tok = line.split()
            if len(tok) < 6:
                continue
            gid = int(tok[0])
            ity = int(tok[4])
            nb = int(tok[5])
            bonds = []
            for k in range(nb):
                bonds.append((int(tok[6 + 2 * k]), float(tok[7 + 2 * k])))
            out.append((gid, ity, bonds))
    return out


def bond_lifetime(paths, threshold=0.5):
    """Fraction of frames each unordered bond exists; returns
    {(gi, gj): occupancy} filtered by threshold."""
    counts = collections.Counter()
    nframes = 0
    for p in paths:
        nframes += 1
        for gid, _, bonds in read_bnd(p):
            for gj, _bo in bonds:
                key = (min(gid, gj), max(gid, gj))
                counts[key] += 1
    # each bond is listed from both endpoints -> two counts per frame
    return {k: v / (2.0 * nframes) for k, v in counts.items()
            if v / (2.0 * nframes) >= threshold}, nframes


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pattern = argv[0] if argv else "DAT/*.bnd"
    thr = float(argv[1]) if len(argv) > 1 else 0.5
    paths = sorted(glob.glob(pattern))
    if not paths:
        print(f"no .bnd files match {pattern}")
        return 1
    life, nframes = bond_lifetime(paths, thr)
    print(f"# {len(paths)} frames, {len(life)} bonds with occupancy >= {thr}")
    for (gi, gj), occ in sorted(life.items()):
        print(f"{gi:12d} {gj:12d} {occ:8.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
