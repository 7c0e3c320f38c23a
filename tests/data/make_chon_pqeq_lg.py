"""Write tests/data/pqeq_chon.par and tests/data/ffield_chon_synth_lg.

Both are synthetic: parameters chosen within published ranges, not a
published set, for the CHON deck of ffield_chon_synth (types C, H, O, N in
that order).

* pqeq_chon.par: PQEq core/shell parameters (Naserifar, Brooks, Goddard &
  Oppenheim, J. Chem. Phys. 146, 124117 (2017)) in the reference's
  pqeq1.par layout: an NPARMS line, then one row per type in the
  ffield's order: name, P, X0 [eV], J0 [eV], Z, Rc [A], Rs [A],
  Ks [kcal/mol/A^2].
* ffield_chon_synth_lg: ffield_chon_synth in the ReaxFF-lg layout (Liu,
  Liu, Zybin & Goddard, J. Phys. Chem. A 115, 11016 (2011)): rcore2,
  ecore2 and acore2 in columns 6-8 of each atom's 4th line, a 5th atom
  line with C_lg [kcal/mol A^6] and Re_lg [A], and a 7th column (C_lg of
  the pair, the geometric mean of the two atoms') on each off-diagonal
  line.

    python tests/data/make_chon_pqeq_lg.py
"""
import os

HERE = os.path.dirname(os.path.abspath(__file__))
TYPES = ("C", "H", "O", "N")

# name: (X0, J0, Z, Rc, Rs, Ks)
PQEQ = {
    "C": (5.50813, 9.81186, 1.0, 0.759, 0.759, 198.84054),
    "H": (4.72484, 15.57338, 1.0, 0.371, 0.371, 2037.20061),
    "O": (8.74120, 13.36400, 1.0, 0.669, 0.669, 414.70000),
    "N": (6.89890, 11.76000, 1.0, 0.716, 0.716, 304.80000),
}
# name: (rcore2 [A], ecore2 [kcal/mol], acore2, C_lg, Re_lg [A])
LG = {
    "C": (1.4000, 0.0700, 7.0000, 1150.0000, 1.9000),
    "H": (1.1000, 0.0400, 6.0000, 40.0000, 1.4500),
    "O": (1.3000, 0.0800, 7.5000, 320.0000, 1.7500),
    "N": (1.3500, 0.0750, 7.2000, 425.0000, 1.8500),
}


def write_pqeq(path):
    with open(path, "w") as fh:
        fh.write("# Synthetic PQEq parameters for the CHON test deck (NOT a "
                 "published set; values within the ranges of Naserifar et "
                 "al., JCP 146, 124117 (2017))\n")
        fh.write("# name P X0 J0 Z Rc Rs Ks  (make_chon_pqeq_lg.py)\n")
        fh.write(f"NPARMS {len(TYPES)}\n")
        for name in TYPES:
            x0, j0, z, rc, rs, ks = PQEQ[name]
            fh.write(f"{name:<3s} 1 {x0:10.5f} {j0:10.5f} {z:8.4f} "
                     f"{rc:8.4f} {rs:8.4f} {ks:12.5f}\n")


def _fields(vals):
    return "   " + "".join(f"{v:9.4f}" for v in vals)


def write_lg(src, path):
    with open(src) as fh:
        lines = fh.read().splitlines()
    out = ["Synthetic CHON ReaxFF-lg parameters for tests (NOT a published "
           "parameterisation; ffield_chon_synth with LG terms within the "
           "ranges of Liu et al., JPCA 115, 11016 (2011))"]
    k = 1
    while "Nr of atoms" not in lines[k]:
        out.append(lines[k])
        k += 1
    out.extend(lines[k:k + 4])          # count line and 3 comment lines
    k += 4
    for _ in TYPES:
        block = lines[k:k + 4]
        name = block[0][1:3].strip()
        rcore2, ecore2, acore2, clg, relg = LG[name]
        body = block[3][3:]
        vals = [float(body[j * 9:(j + 1) * 9]) for j in range(5)]
        out.extend(block[:3])
        out.append(_fields(vals + [rcore2, ecore2, acore2]))
        out.append(_fields([clg, relg]))
        k += 4
    while "Nr of off-diagonal" not in lines[k]:
        out.append(lines[k])
        k += 1
    nod = int(lines[k][:3])
    out.append(lines[k])
    k += 1
    for line in lines[k:k + nod]:
        i, j = int(line[0:3]) - 1, int(line[3:6]) - 1
        cij = (LG[TYPES[i]][3] * LG[TYPES[j]][3]) ** 0.5
        out.append(line + f"{cij:9.4f}")
    out.extend(lines[k + nod:])
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def main():
    write_pqeq(os.path.join(HERE, "pqeq_chon.par"))
    write_lg(os.path.join(HERE, "ffield_chon_synth"),
             os.path.join(HERE, "ffield_chon_synth_lg"))


if __name__ == "__main__":
    main()
