"""ReaxFF force-field file ("ffield") ingestion and parameter derivation.

Parses the Adri-van-Duin-format parameter file exactly as the reference does
(ref: src/param.F90:2-375, fixed formats at param.F90:344-351), derives the
combined two-body constants (cBOp*, switch flags, mixing rules), the
bond-order cutoff radii (ref: init.F90:363-418) and the tabulated nonbonded
kernels (ref: init.F90:421-522).

Everything here is plain NumPy executed once at setup time; the results are
immutable numpy arrays that get closed over (as compile-time constants) or
passed as device arrays into the jitted compute functions.

Type indices are 0-based throughout this package.  Bond/angle/torsion/hbond
interaction tables map type tuples to a 0-based interaction index, with -1
meaning "no interaction defined".
"""
from __future__ import annotations

import dataclasses
import numpy as np

from . import units


def _fw_floats(line: str, skip: int, width: int = 9, count: int = 10):
    """Fixed-width float fields, mirroring Fortran '(Nx, 10f9.4)' reads.

    Returns up to `count` floats; missing/blank fields yield 0.0.
    """
    body = line[skip:]
    out = []
    for k in range(count):
        field = body[k * width:(k + 1) * width]
        if not field.strip():
            out.append(0.0)
        else:
            out.append(float(field))
    return out


def _leading_int(line: str, width: int = 3) -> int:
    return int(line[:width])


@dataclasses.dataclass
class ForceField:
    """All ReaxFF parameters in derived, simulation-ready form."""

    header: str
    nso: int                      # number of atom types
    nboty: int                    # number of 2-body interaction types
    atom_names: list

    # --- general (vpar) scalars actually used downstream
    vpar1: float                  # pboc1 (overcoordination correction #1)
    vpar2: float                  # pboc2
    vpar30: float                 # BO'sigma energy/force split constant
    pvdW1: float

    # --- per-type arrays, shape (nso,)
    rat: np.ndarray               # sigma-bond radius r0s contribution
    rapt: np.ndarray              # pi-bond radius
    vnq: np.ndarray               # double-pi radius
    Val: np.ndarray
    Valboc: np.ndarray
    Vale: np.ndarray
    Valangle: np.ndarray
    Valval: np.ndarray
    mass: np.ndarray
    plp1: np.ndarray
    plp2: np.ndarray
    nlpopt: np.ndarray
    povun2: np.ndarray
    povun3: np.ndarray
    povun4: np.ndarray
    povun5: np.ndarray
    povun6: np.ndarray
    povun7: np.ndarray
    povun8: np.ndarray
    pval3: np.ndarray
    pval5: np.ndarray
    chi: np.ndarray               # eV
    eta: np.ndarray               # eV, already doubled (ref: param.F90:361)
    gam: np.ndarray

    # --- per-pair-of-types arrays, shape (nso, nso)
    r0s: np.ndarray
    r0p: np.ndarray
    r0pp: np.ndarray
    rvdW: np.ndarray
    Dij: np.ndarray
    alpij: np.ndarray
    gamW: np.ndarray
    gamij: np.ndarray             # (gam_i*gam_j)^(-3/2)

    # --- bond-type tables
    inxn2: np.ndarray             # (nso,nso) -> bond type index, -1 if none
    Desig: np.ndarray             # (nboty,)
    Depi: np.ndarray
    Depipi: np.ndarray
    pbe1: np.ndarray
    pbe2: np.ndarray
    pbo1: np.ndarray
    pbo2: np.ndarray
    pbo3: np.ndarray
    pbo4: np.ndarray
    pbo5: np.ndarray
    pbo6: np.ndarray
    povun1: np.ndarray
    ovc: np.ndarray
    v13cor: np.ndarray
    pboc3: np.ndarray
    pboc4: np.ndarray
    pboc5: np.ndarray
    # derived bond constants (ref: param.F90:220-261)
    cBOp1: np.ndarray
    cBOp3: np.ndarray
    cBOp5: np.ndarray
    pbo2h: np.ndarray
    pbo4h: np.ndarray
    pbo6h: np.ndarray
    switch: np.ndarray            # (nboty, 3) in {0.,1.}

    # --- valence-angle types
    nvaty: int
    inxn3: np.ndarray             # (nso,nso,nso) -> angle type, -1 if none
    theta00: np.ndarray           # radians
    pval1: np.ndarray
    pval2: np.ndarray
    pval4: np.ndarray
    pval6: np.ndarray
    pval7: np.ndarray
    pval8: np.ndarray
    pval9: np.ndarray
    pval10: np.ndarray
    ppen1: np.ndarray
    ppen2: np.ndarray
    ppen3: np.ndarray
    ppen4: np.ndarray
    pcoa1: np.ndarray
    pcoa2: np.ndarray
    pcoa3: np.ndarray
    pcoa4: np.ndarray

    # --- torsion types
    ntoty: int
    inxn4: np.ndarray             # (nso,nso,nso,nso) -> torsion type, -1
    V1: np.ndarray
    V2: np.ndarray
    V3: np.ndarray
    ptor1: np.ndarray
    ptor2: np.ndarray
    ptor3: np.ndarray
    ptor4: np.ndarray
    pcot1: np.ndarray
    pcot2: np.ndarray

    # --- hydrogen-bond types
    nhbty: int
    inxn3hb: np.ndarray           # (nso,nso,nso) -> hbond type, -1 (directional)
    r0hb: np.ndarray
    phb1: np.ndarray
    phb2: np.ndarray
    phb3: np.ndarray

    # --- cutoffs (filled by finalize())
    cutoff_vpar30: float = 0.0
    rc: np.ndarray = None         # (nboty,) sigma-bond cutoff radii
    rc2: np.ndarray = None
    maxrc: float = 0.0

    # --- LG dispersion extension (None unless parsed with lg=True)
    is_lg: bool = False
    C_lg: np.ndarray = None       # (nso, nso)
    Re_lg: np.ndarray = None      # (nso,)
    rcore: np.ndarray = None      # (nso, nso)
    ecore: np.ndarray = None
    acore: np.ndarray = None

    @property
    def name_to_type(self):
        return {n.strip(): i for i, n in enumerate(self.atom_names)}


def parse_ffield(path: str, lg: bool = False) -> ForceField:
    """Parse an ffield file (ref: param.F90:2-375)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    it = iter(lines)
    header = next(it).strip()

    npar = int(next(it).split()[0])
    vpar = np.zeros(npar + 1)  # 1-based like the reference
    for i in range(1, npar + 1):
        vpar[i] = float(next(it)[:10])  # format f10.4 (param.F90:347)

    pvdW1 = vpar[29]
    vpar30 = vpar[30]

    nso = _leading_int(next(it))
    for _ in range(3):
        next(it)  # 3 comment lines (param.F90:98-100)

    names = []
    rat = np.zeros(nso); Val = np.zeros(nso); mass = np.zeros(nso)
    rvdw1 = np.zeros(nso); eps = np.zeros(nso); gam = np.zeros(nso)
    rapt = np.zeros(nso); Vale = np.zeros(nso)
    alf = np.zeros(nso); vop = np.zeros(nso); Valboc = np.zeros(nso)
    povun5 = np.zeros(nso); chi = np.zeros(nso); eta = np.zeros(nso)
    vnq = np.zeros(nso); plp2 = np.zeros(nso)
    bo131 = np.zeros(nso); bo132 = np.zeros(nso); bo133 = np.zeros(nso)
    povun2 = np.zeros(nso); pval3 = np.zeros(nso); Valval = np.zeros(nso)
    pval5 = np.zeros(nso)
    rcore2 = np.zeros(nso); ecore2 = np.zeros(nso); acore2 = np.zeros(nso)
    C_lg_d = np.zeros(nso); Re_lg = np.zeros(nso)

    for i in range(nso):
        l1 = next(it)
        names.append(l1[1:3].strip())
        v = _fw_floats(l1, 3)
        rat[i], Val[i], mass[i], rvdw1[i], eps[i], gam[i], rapt[i], Vale[i] = v[:8]
        v = _fw_floats(next(it), 3)
        alf[i], vop[i], Valboc[i], povun5[i], _, chi[i], eta[i], _ = v[:8]
        v = _fw_floats(next(it), 3)
        vnq[i], plp2[i], _, bo131[i], bo132[i], bo133[i], _, _ = v[:8]
        v = _fw_floats(next(it), 3)
        if lg:
            (povun2[i], pval3[i], _, Valval[i], pval5[i],
             rcore2[i], ecore2[i], acore2[i]) = v[:8]
            v5 = _fw_floats(next(it), 3)
            C_lg_d[i], Re_lg[i] = v5[:2]
        else:
            povun2[i], pval3[i], _, Valval[i], pval5[i] = v[:5]

    # "update for Mo" (ref: param.F90:117-119)
    upd = (mass < 21.0) & (Valboc != Valval)
    Valboc = np.where(upd, Valval, Valboc)

    nlpopt = 0.5 * (Vale - Val)
    Valangle = Valboc.copy()

    # default combination rules (ref: param.F90:126-148)
    r0s = 0.5 * (rat[:, None] + rat[None, :])
    r0p = 0.5 * (rapt[:, None] + rapt[None, :])
    r0pp = 0.5 * (vnq[:, None] + vnq[None, :])
    rvdW = np.sqrt(4.0 * rvdw1[:, None] * rvdw1[None, :])
    Dij = np.sqrt(eps[:, None] * eps[None, :])
    alpij = np.sqrt(alf[:, None] * alf[None, :])
    gamW = np.sqrt(vop[:, None] * vop[None, :])
    gamij = (gam[:, None] * gam[None, :]) ** (-1.5)
    C_lg = np.sqrt(C_lg_d[:, None] * C_lg_d[None, :]) if lg else None
    rcore = np.sqrt(rcore2[:, None] * rcore2[None, :]) if lg else None
    ecore = np.sqrt(ecore2[:, None] * ecore2[None, :]) if lg else None
    acore = np.sqrt(acore2[:, None] * acore2[None, :]) if lg else None

    # --- bond section (ref: param.F90:151-190)
    nboty = _leading_int(next(it))
    next(it)  # skip one comment line
    inxn2 = -np.ones((nso, nso), dtype=np.int32)
    Desig = np.zeros(nboty); Depi = np.zeros(nboty); Depipi = np.zeros(nboty)
    pbe1 = np.zeros(nboty); pbe2 = np.zeros(nboty)
    pbo1 = np.zeros(nboty); pbo2 = np.zeros(nboty); pbo3 = np.zeros(nboty)
    pbo4 = np.zeros(nboty); pbo5 = np.zeros(nboty); pbo6 = np.zeros(nboty)
    povun1 = np.zeros(nboty); ovc = np.zeros(nboty); v13cor = np.zeros(nboty)
    for b in range(nboty):
        l1 = next(it)
        ta, tb = int(l1[0:3]) - 1, int(l1[3:6]) - 1
        v = _fw_floats(l1, 6, count=8)
        Desig[b], Depi[b], Depipi[b], pbe1[b], pbo5[b], v13cor[b], pbo6[b], povun1[b] = v
        v = _fw_floats(next(it), 6, count=8)
        pbe2[b], pbo3[b], pbo4[b], _bom, pbo1[b], pbo2[b], ovc[b], _ = v
        inxn2[ta, tb] = b
        inxn2[tb, ta] = b

    # pboc combination (ref: param.F90:181-190): note bo132->pboc3, bo131->pboc4
    pboc3 = np.zeros(nboty); pboc4 = np.zeros(nboty); pboc5 = np.zeros(nboty)
    for i in range(nso):
        for j in range(nso):
            b = inxn2[i, j]
            if b >= 0:
                pboc3[b] = np.sqrt(bo132[i] * bo132[j])
                pboc4[b] = np.sqrt(bo131[i] * bo131[j])
                pboc5[b] = np.sqrt(bo133[i] * bo133[j])

    # --- off-diagonal overrides (ref: param.F90:194-217)
    nodmty = _leading_int(next(it))
    for _ in range(nodmty):
        l1 = next(it)
        i, j = int(l1[0:3]) - 1, int(l1[3:6]) - 1
        v = _fw_floats(l1, 6, count=7 if lg else 6)
        deodmh, rodmh, godmh, rsig, rpi, rpi2 = v[:6]
        if lg:
            C_lg[i, j] = C_lg[j, i] = v[6]
        if rsig > 0.0:
            r0s[i, j] = r0s[j, i] = rsig
        if rpi > 0.0:
            r0p[i, j] = r0p[j, i] = rpi
        if rpi2 > 0.0:
            r0pp[i, j] = r0pp[j, i] = rpi2
        if rodmh > 0.0:
            rvdW[i, j] = rvdW[j, i] = 2.0 * rodmh
        if deodmh > 0.0:
            Dij[i, j] = Dij[j, i] = deodmh
        if godmh > 0.0:
            alpij[i, j] = alpij[j, i] = godmh

    # --- derived two-body constants (ref: param.F90:220-261)
    cBOp1 = np.zeros(nboty); cBOp3 = np.zeros(nboty); cBOp5 = np.zeros(nboty)
    switch = np.zeros((nboty, 3))
    for i in range(nso):
        for j in range(nso):
            b = inxn2[i, j]
            if b < 0:
                continue
            if rat[i] > 0.0 and rat[j] > 0.0:
                switch[b, 0] = 1.0
            if rapt[i] > 0.0 and rapt[j] > 0.0:
                switch[b, 1] = 1.0
            if vnq[i] > 0.0 and vnq[j] > 0.0:
                switch[b, 2] = 1.0
            cBOp1[b] = pbo1[b] / r0s[i, j] ** pbo2[b] if r0s[i, j] > 0 else 0.0
            cBOp3[b] = pbo3[b] / r0p[i, j] ** pbo4[b] if r0p[i, j] > 0 else 0.0
            cBOp5[b] = pbo5[b] / r0pp[i, j] ** pbo6[b] if r0pp[i, j] > 0 else 0.0
    pbo2h, pbo4h, pbo6h = 0.5 * pbo2, 0.5 * pbo4, 0.5 * pbo6

    # --- valence angles (ref: param.F90:264-293)
    nvaty = _leading_int(next(it))
    inxn3 = -np.ones((nso, nso, nso), dtype=np.int32)
    theta00 = np.zeros(nvaty); pval1 = np.zeros(nvaty); pval2 = np.zeros(nvaty)
    pcoa1 = np.zeros(nvaty); pval7 = np.zeros(nvaty); ppen1 = np.zeros(nvaty)
    pval4 = np.zeros(nvaty)
    for a in range(nvaty):
        l1 = next(it)
        i1, i2, i3 = int(l1[0:3]) - 1, int(l1[3:6]) - 1, int(l1[6:9]) - 1
        v = _fw_floats(l1, 9, count=7)
        theta00[a], pval1[a], pval2[a], pcoa1[a], pval7[a], ppen1[a], pval4[a] = v
        inxn3[i1, i2, i3] = a
        inxn3[i3, i2, i1] = a
    pval6 = np.full(nvaty, vpar[15]); pval8 = np.full(nvaty, vpar[34])
    pval9 = np.full(nvaty, vpar[17]); pval10 = np.full(nvaty, vpar[18])
    ppen2 = np.full(nvaty, vpar[20]); ppen3 = np.full(nvaty, vpar[21])
    ppen4 = np.full(nvaty, vpar[22])
    pcoa2 = np.full(nvaty, vpar[3]); pcoa3 = np.full(nvaty, vpar[39])
    pcoa4 = np.full(nvaty, vpar[31])
    theta00 = theta00 * np.pi / 180.0

    # --- torsions (ref: param.F90:296-327)
    ntoty = _leading_int(next(it))
    inxn4 = -np.ones((nso, nso, nso, nso), dtype=np.int32)
    V1 = np.zeros(ntoty); V2 = np.zeros(ntoty); V3 = np.zeros(ntoty)
    ptor1 = np.zeros(ntoty); pcot1 = np.zeros(ntoty)
    for t in range(ntoty):
        l1 = next(it)
        i1, i2 = int(l1[0:3]), int(l1[3:6])
        i3, i4 = int(l1[6:9]), int(l1[9:12])
        v = _fw_floats(l1, 12, count=5)
        V1[t], V2[t], V3[t], ptor1[t], pcot1[t] = v
        if i1 == 0:
            # wildcard: applies to all i1,i4 not already set (param.F90:304-314)
            for a in range(nso):
                for d in range(nso):
                    if inxn4[a, i2 - 1, i3 - 1, d] < 0 and inxn4[a, i3 - 1, i2 - 1, d] < 0:
                        inxn4[a, i2 - 1, i3 - 1, d] = t
                        inxn4[d, i2 - 1, i3 - 1, a] = t
                        inxn4[a, i3 - 1, i2 - 1, d] = t
                        inxn4[d, i3 - 1, i2 - 1, a] = t
        else:
            a, b_, c, d = i1 - 1, i2 - 1, i3 - 1, i4 - 1
            inxn4[a, b_, c, d] = t
            inxn4[d, b_, c, a] = t
            inxn4[a, c, b_, d] = t
            inxn4[d, c, b_, a] = t
    ptor2 = np.full(ntoty, vpar[24]); ptor3 = np.full(ntoty, vpar[25])
    ptor4 = np.full(ntoty, vpar[26]); pcot2 = np.full(ntoty, vpar[28])

    # --- hydrogen bonds (ref: param.F90:330-337), directional table
    nhbty = _leading_int(next(it))
    inxn3hb = -np.ones((nso, nso, nso), dtype=np.int32)
    r0hb = np.zeros(nhbty); phb1 = np.zeros(nhbty); phb2 = np.zeros(nhbty)
    phb3 = np.zeros(nhbty)
    for h in range(nhbty):
        l1 = next(it)
        i1, i2, i3 = int(l1[0:3]) - 1, int(l1[3:6]) - 1, int(l1[6:9]) - 1
        v = _fw_floats(l1, 9, count=4)
        r0hb[h], phb1[h], phb2[h], phb3[h] = v
        inxn3hb[i1, i2, i3] = h

    # eta convention: our definition is 2x the file value (ref: param.F90:361)
    eta = eta * 2.0

    ff = ForceField(
        header=header, nso=nso, nboty=nboty, atom_names=names,
        vpar1=vpar[1], vpar2=vpar[2], vpar30=vpar30, pvdW1=pvdW1,
        rat=rat, rapt=rapt, vnq=vnq, Val=Val, Valboc=Valboc, Vale=Vale,
        Valangle=Valangle, Valval=Valval, mass=mass,
        plp1=np.full(nso, vpar[16]), plp2=plp2, nlpopt=nlpopt,
        povun2=povun2, povun3=np.full(nso, vpar[33]),
        povun4=np.full(nso, vpar[32]), povun5=povun5,
        povun6=np.full(nso, vpar[7]), povun7=np.full(nso, vpar[9]),
        povun8=np.full(nso, vpar[10]),
        pval3=pval3, pval5=pval5, chi=chi, eta=eta, gam=gam,
        r0s=r0s, r0p=r0p, r0pp=r0pp, rvdW=rvdW, Dij=Dij, alpij=alpij,
        gamW=gamW, gamij=gamij,
        inxn2=inxn2, Desig=Desig, Depi=Depi, Depipi=Depipi,
        pbe1=pbe1, pbe2=pbe2, pbo1=pbo1, pbo2=pbo2, pbo3=pbo3, pbo4=pbo4,
        pbo5=pbo5, pbo6=pbo6, povun1=povun1, ovc=ovc, v13cor=v13cor,
        pboc3=pboc3, pboc4=pboc4, pboc5=pboc5,
        cBOp1=cBOp1, cBOp3=cBOp3, cBOp5=cBOp5,
        pbo2h=pbo2h, pbo4h=pbo4h, pbo6h=pbo6h, switch=switch,
        nvaty=nvaty, inxn3=inxn3, theta00=theta00, pval1=pval1, pval2=pval2,
        pval4=pval4, pval6=pval6, pval7=pval7, pval8=pval8, pval9=pval9,
        pval10=pval10, ppen1=ppen1, ppen2=ppen2, ppen3=ppen3, ppen4=ppen4,
        pcoa1=pcoa1, pcoa2=pcoa2, pcoa3=pcoa3, pcoa4=pcoa4,
        ntoty=ntoty, inxn4=inxn4, V1=V1, V2=V2, V3=V3,
        ptor1=ptor1, ptor2=ptor2, ptor3=ptor3, ptor4=ptor4,
        pcot1=pcot1, pcot2=pcot2,
        nhbty=nhbty, inxn3hb=inxn3hb, r0hb=r0hb, phb1=phb1, phb2=phb2,
        phb3=phb3,
        is_lg=lg, C_lg=C_lg, Re_lg=Re_lg, rcore=rcore, ecore=ecore,
        acore=acore,
    )
    _finalize_cutoffs(ff)
    return ff


def _finalize_cutoffs(ff: ForceField, natoms_per_type=None):
    """Sigma-bond cutoff radii by incremental scan (ref: init.F90:363-418)."""
    ff.cutoff_vpar30 = units.CUTOF2_BO * ff.vpar30
    rc = np.zeros(ff.nboty)
    for i in range(ff.nso):
        for j in range(i, ff.nso):
            b = ff.inxn2[i, j]
            if b < 0:
                continue
            dr = 1.0
            bosig = 1.0
            while bosig > units.MINBOSIG:
                dr += 0.01
                bosig = np.exp(ff.pbo1[b] * (dr / ff.r0s[i, j]) ** ff.pbo2[b])
            rc[b] = dr
    if natoms_per_type is not None:
        # zero out cutoffs for absent types (ref: init.F90:404-413)
        for i in range(ff.nso):
            if natoms_per_type[i] == 0:
                for j in range(ff.nso):
                    for b in (ff.inxn2[i, j], ff.inxn2[j, i]):
                        if b >= 0:
                            rc[b] = 0.0
    ff.rc = rc
    ff.rc2 = rc * rc
    ff.maxrc = rc.max()


def effective_maxrc(ff: ForceField, types: np.ndarray) -> float:
    """Max bond cutoff considering only atom types present (ref: init.F90:404-416)."""
    present = np.bincount(types, minlength=ff.nso) > 0
    best = 0.0
    for i in range(ff.nso):
        for j in range(ff.nso):
            b = ff.inxn2[i, j]
            if b >= 0 and present[i] and present[j]:
                best = max(best, ff.rc[b])
    return best


def build_tables(ff: ForceField, rctap: float = units.RCTAP0,
                 ntable: int = units.NTABLE):
    """Tabulated nonbonded kernels on an r^2 grid (ref: init.F90:421-522).

    Returns dict with arrays of shape (nboty, ntable+1):
      evdw, devdw   : van der Waals energy and dE/dr / r
      eclmb, declmb : Coulomb kernel (kcal, per unit q_i q_j) and derivative
      eclmb_qeq     : QEq hessian kernel (eV)
    Index k corresponds to r^2 = k * UDR with UDR = rctap^2 / ntable; entry 0
    is synthesized (the reference never reads below index 1).
    """
    ctap = np.array(units.taper_coeffs(rctap))
    udr = rctap * rctap / ntable
    k = np.arange(ntable + 1, dtype=np.float64)
    dr2 = np.maximum(udr * k, 1e-12)
    dr1 = np.sqrt(dr2)
    dr3 = dr1 * dr2
    dr4 = dr2 * dr2
    dr5 = dr1 * dr4
    dr6 = dr2 * dr4
    dr7 = dr1 * dr6
    Tap = ctap[7] * dr7 + ctap[6] * dr6 + ctap[5] * dr5 + ctap[4] * dr4 + ctap[0]
    dTap = 7 * ctap[7] * dr5 + 6 * ctap[6] * dr4 + 5 * ctap[5] * dr3 + 4 * ctap[4] * dr2

    nb = ff.nboty
    evdw = np.zeros((nb, ntable + 1))
    devdw = np.zeros((nb, ntable + 1))
    eclmb = np.zeros((nb, ntable + 1))
    declmb = np.zeros((nb, ntable + 1))
    eclmb_qeq = np.zeros((nb, ntable + 1))

    pvdW1 = ff.pvdW1
    pvdW1h = 0.5 * pvdW1
    pvdW1inv = 1.0 / pvdW1

    for i in range(ff.nso):
        for j in range(i, ff.nso):
            b = ff.inxn2[i, j]
            if b < 0:
                continue
            gamWij = ff.gamW[i, j]
            alphaij = ff.alpij[i, j]
            Dij0 = ff.Dij[i, j]
            rvdW0 = ff.rvdW[i, j]
            gamwinvp = (1.0 / gamWij) ** pvdW1

            rij_vd1 = dr2 ** pvdW1h
            fn13 = (rij_vd1 + gamwinvp) ** pvdW1inv
            exp1 = np.exp(alphaij * (1.0 - fn13 / rvdW0))
            exp2 = np.sqrt(exp1)
            dr3gamij = (dr3 + ff.gamij[i, j]) ** (-1.0 / 3.0)

            evdw[b] = Tap * Dij0 * (exp1 - 2.0 * exp2)
            eclmb[b] = Tap * units.CCLMB0 * dr3gamij
            eclmb_qeq[b] = Tap * units.CCLMB0_QEQ * dr3gamij

            dfn13 = ((rij_vd1 + gamwinvp) ** (pvdW1inv - 1.0)) * (dr2 ** (pvdW1h - 1.0))
            devdw[b] = Dij0 * (dTap * (exp1 - 2.0 * exp2)
                               - Tap * (alphaij / rvdW0) * (exp1 - exp2) * dfn13)
            declmb[b] = units.CCLMB0 * dr3gamij * (dTap - (dr3gamij ** 3) * Tap * dr1)

            if ff.is_lg and i < 4 and j < 4:
                # LG dispersion + inner-core repulsion (ref: init.F90:496-514)
                dr_lg = 2.0 * np.sqrt(ff.Re_lg[i] * ff.Re_lg[j])
                dr6_lg = dr_lg ** 6
                Elg = -ff.C_lg[i, j] / (dr6 + dr6_lg)
                E_core = ff.ecore[i, j] * np.exp(
                    ff.acore[i, j] * (1.0 - dr1 / ff.rcore[i, j]))
                dElg = ff.C_lg[i, j] * (6.0 * dr5) / (dr6 + dr6_lg) ** 2 / dr1
                dE_core = -ff.acore[i, j] * E_core / ff.rcore[i, j] / dr1
                evdw[b] = evdw[b] + Tap * (Elg + E_core)
                devdw[b] = devdw[b] + dTap * Elg + Tap * dElg + dTap * E_core + Tap * dE_core

    return {
        "evdw": evdw, "devdw": devdw,
        "eclmb": eclmb, "declmb": declmb,
        "eclmb_qeq": eclmb_qeq,
        "udr": udr, "udri": 1.0 / udr, "rctap": rctap, "rctap2": rctap * rctap,
        "ctap": ctap,
    }
