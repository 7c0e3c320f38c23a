"""Run configuration: rxmd.in-compatible parser + CLI overrides.

Mirrors the reference's three config layers (ref: cmdline.F90:239-381):
the key-value `rxmd.in` file, command-line overrides, and defaults.
Unknown keys are a hard error, like the reference (cmdline.F90:294-296).
"""
from __future__ import annotations

import argparse
import dataclasses


def _f(tok: str) -> float:
    """Parse a Fortran-style float literal (1.d-7 etc.)."""
    return float(tok.lower().replace("d", "e"))


def _b(tok: str) -> bool:
    return tok.strip(".").lower().startswith("t")


@dataclasses.dataclass
class RunConfig:
    # MD control (ref: cmdline.F90:255-297 keys)
    mdmode: int = 1
    dt_fs: float = 0.25          # <dt> in fs
    ntime_step: int = 100
    treq: float = 300.0          # target temperature [K]
    vsfact: float = 1.0
    sstep: int = 100
    fstep: int = 100             # trajectory output interval
    pstep: int = 10              # print interval
    is_binary: bool = False
    is_bondfile: bool = False
    is_pdb: bool = False
    is_xyz: bool = False
    vprocs: tuple = (1, 1, 1)
    # QEq
    isQEq: int = 1
    NMAXQEq: int = 500
    QEq_tol: float = 1e-7
    qstep: int = 1
    qeq_dense_max: int = 8192    # fold the QEq hessian into a dense (N,N)
                                 # MXU matvec when N <= this (single-device
                                 # full-CG only); 0 forces the ELL path,
                                 # matching the sharded engine's summation
                                 # order exactly
    # extended Lagrangian
    Lex_fqs: float = 1.0
    Lex_k: float = 2.0
    # structural optimizer
    ftol: float = 1e-6
    # electric field
    isEfield: bool = False
    eFieldDir: int = 0           # 0-based axis
    eFieldStrength: float = 0.0
    # PQEq
    isPQEq: bool = False
    pqeq_parm_path: str = ""
    # paths
    ffield_path: str = "ffield"
    data_dir: str = "DAT"
    # engine knobs (new; no reference analog)
    dtype: str = "float64"       # validation default; use float32 on TPU
    kb_cap: int = 0              # 0 = auto-size from first neighbor build
    knb_cap: int = 0
    nbr_skin: float = 0.4        # Verlet skin [A] added to list cutoffs.
                                 # The drift monitor rebuilds lists when
                                 # max displacement exceeds skin/2 (~32
                                 # steps at 300K, dt 0.25 fs).  With the
                                 # dense minimum-image fast path the pair
                                 # kernels no longer scale with the skin,
                                 # so a wider skin mainly buys fewer
                                 # rebuilds (a rebuild costs ~6 steps)
    rebuild_every: int = 40      # neighbor-list rebuild cadence CAP [steps];
                                 # the drift monitor usually triggers first
    term_slack: float = 0.1      # many-body list cache: BO-gate thresholds
                                 # are multiplied by this at list build so
                                 # near-threshold interactions stay listed
                                 # while BOs drift between rebuilds
    term_margin: float = 0.0     # [A] geometric margin past the sigma-bond
                                 # cutoff for list candidates (bonds that
                                 # could form before the next rebuild).
                                 # 0 (default): new-bond crossings are
                                 # picked up at the next rebuild; the
                                 # transient omission is bounded by
                                 # ~1e-4 kcal/mol/atom (a leg entering rc
                                 # has BO <~ 1e-3 for the <=rebuild_every
                                 # steps it can stay unlisted).  >0 lists
                                 # candidate bonds geometrically — exact
                                 # under drift<margin/2 but inflates the
                                 # torsion capacity ~10-20x.
    term_cache: bool = True      # cache angle/torsion lists on the rebuild
                                 # cadence (False = reference per-step
                                 # enumeration semantics, bit-exact)
    pair_kernel: bool = None     # cell-column pair sweep (ops/pairsweep)
                                 # as the nonbond + QEq engine.  The port
                                 # has no other pair engine: None and True
                                 # both select the sweep (its CUDA kernels
                                 # on a CUDA device, its plain PyTorch
                                 # version on the CPU); False raises
                                 # NotImplementedError in md.Engine.
    block_steps: int = 10        # rxmd_tpu: MD steps fused into one
                                 # dispatched XLA program (lax.scan).  The
                                 # port accepts it and steps one at a time;
                                 # K steps captured in one CUDA graph is
                                 # ROADMAP item 1.2.
    dense_direct_max: int = 12288
                                 # dense minimum-image fast path for the
                                 # QEq hessian + nonbond kernels (no
                                 # neighbor gathers; one-hot MXU params,
                                 # (n,n) MXU matvecs).  Used in f32
                                 # closed-form production when the box is
                                 # orthogonal with min(L) > 2*rctap and
                                 # n <= this cap.  O(n^2) memory: the two
                                 # (n,n) QEq matrices cost 2*4*n^2 bytes
                                 # (1.2 GB at the 12288 default); measured
                                 # on v5e the dense path still beats the
                                 # gather-bound ELL path at 10.7k atoms
                                 # (SCALING.md).  0 disables.
    list_chunk: int = 4096       # row-chunk size for the torsion/hbond
                                 # list builds (lax.map over center-row
                                 # blocks; bit-identical output).  Bounds
                                 # the builds' peak HBM/compile footprint
                                 # so production N compiles on the TPU —
                                 # the one-shot build crashes the compile
                                 # service at N >= 16.8k (SCALING.md).
                                 # Applied when n > this value; 0 never
                                 # chunks.
    nonbond_closed_form: bool = None
                                 # None (auto): closed-form vdW/Coulomb/QEq
                                 # kernels in float32 production (VPU math,
                                 # no 58 MB table gathers per sweep), the
                                 # reference's interpolation tables in
                                 # float64 validation (bit-parity with the
                                 # golden trace).  True/False forces.
    tighten_lists: bool = False  # per-step compaction of skinned lists to
                                 # the true cutoffs: saves ~1.4x in term
                                 # shapes but costs two top_k sorts per step
                                 # (energy kernels re-check cutoffs either
                                 # way, so results are identical)
    spring_const: float = 0.0
    spring_types: tuple = ()
    # run-profile file (ref: saveRunProfile/RunProfilePath module.F90:271-273)
    save_run_profile: bool = False
    run_profile_path: str = "profile.dat"


def parse_rxmd_in(path: str, cfg: RunConfig = None) -> RunConfig:
    cfg = cfg or RunConfig()
    with open(path) as fh:
        for raw in fh:
            line = raw.split("<")[0].strip()  # strip trailing <key> hints
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            key, a = tok[0], tok[1:]
            if key == "mdmode":
                cfg.mdmode = int(a[0])
            elif key == "time":
                cfg.dt_fs = _f(a[0]); cfg.ntime_step = int(a[1])
            elif key == "temperature":
                cfg.treq = _f(a[0]); cfg.vsfact = _f(a[1]); cfg.sstep = int(a[2])
            elif key == "io_step":
                cfg.fstep = int(a[0]); cfg.pstep = int(a[1])
            elif key == "io_type":
                cfg.is_binary, cfg.is_bondfile = _b(a[0]), _b(a[1])
                cfg.is_pdb, cfg.is_xyz = _b(a[2]), _b(a[3])
            elif key == "processors":
                cfg.vprocs = (int(a[0]), int(a[1]), int(a[2]))
            elif key == "QEq":
                cfg.isQEq = int(a[0]); cfg.NMAXQEq = int(a[1])
                cfg.QEq_tol = _f(a[2]); cfg.qstep = int(a[3])
            elif key == "exL":
                cfg.Lex_fqs = _f(a[0]); cfg.Lex_k = _f(a[1])
            elif key == "CG_tol":
                cfg.ftol = _f(a[0])
            elif key == "efield":
                cfg.isEfield = True
                cfg.eFieldDir = int(a[0]) - 1
                cfg.eFieldStrength = _f(a[1])
            elif key == "PQEqParm":
                cfg.isPQEq = True
                cfg.pqeq_parm_path = a[0]
            else:
                raise ValueError(f"unknown rxmd.in key: {key!r} "
                                 "(ref: cmdline.F90:294-296)")
    return cfg


def cli_parser() -> argparse.ArgumentParser:
    """CLI overrides mirroring the reference flags (ref: cmdline.F90:83-163)."""
    p = argparse.ArgumentParser(prog="rxmd-tpu")
    p.add_argument("--rxmdin", default="rxmd.in")
    p.add_argument("--ffield", default=None)
    p.add_argument("--outDir", default=None)
    p.add_argument("--run_from_xyz", default=None)
    p.add_argument("--mc", nargs=3, type=int, default=None,
                   help="replicate the --run_from_xyz cell (geninit -mc)")
    p.add_argument("--mdmode", type=int, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--ntime_step", type=int, default=None)
    p.add_argument("--treq", type=float, default=None)
    p.add_argument("--vsfact", type=float, default=None)
    p.add_argument("--sstep", type=int, default=None)
    p.add_argument("--fstep", type=int, default=None)
    p.add_argument("--pstep", type=int, default=None)
    p.add_argument("--isQEq", type=int, default=None)
    p.add_argument("--NMAXQEq", type=int, default=None)
    p.add_argument("--QEq_tol", type=float, default=None)
    p.add_argument("--qstep", type=int, default=None)
    p.add_argument("--pqeq", default=None)
    p.add_argument("--lg", action="store_true")
    p.add_argument("--efield", nargs=2, default=None)
    p.add_argument("--spring", nargs="+", default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--vprocs", nargs=3, type=int, default=None)
    p.add_argument("--isBinary", action="store_true")
    p.add_argument("--isBondFile", action="store_true")
    p.add_argument("--isPDB", action="store_true")
    p.add_argument("--isXYZ", action="store_true")
    p.add_argument("--saveRunProfile", action="store_true")
    p.add_argument("--RunProfilePath", default=None)
    return p


def apply_cli(cfg: RunConfig, args) -> RunConfig:
    m = {"mdmode": "mdmode", "dt": "dt_fs", "ntime_step": "ntime_step",
         "treq": "treq", "vsfact": "vsfact", "sstep": "sstep",
         "fstep": "fstep", "pstep": "pstep", "isQEq": "isQEq",
         "NMAXQEq": "NMAXQEq", "QEq_tol": "QEq_tol", "qstep": "qstep",
         "ffield": "ffield_path", "outDir": "data_dir", "dtype": "dtype"}
    for src, dst in m.items():
        v = getattr(args, src, None)
        if v is not None:
            setattr(cfg, dst, v)
    if getattr(args, "pqeq", None):
        cfg.isPQEq = True
        cfg.pqeq_parm_path = args.pqeq
    if getattr(args, "efield", None):
        cfg.isEfield = True
        cfg.eFieldDir = int(args.efield[0]) - 1
        cfg.eFieldStrength = _f(args.efield[1])
    if getattr(args, "spring", None):
        cfg.spring_const = _f(args.spring[0])
        cfg.spring_types = tuple(int(t) - 1 for t in args.spring[1:])
    if getattr(args, "vprocs", None):
        cfg.vprocs = tuple(args.vprocs)
    for flag, dst in (("isBinary", "is_binary"), ("isBondFile", "is_bondfile"),
                      ("isPDB", "is_pdb"), ("isXYZ", "is_xyz"),
                      ("saveRunProfile", "save_run_profile")):
        if getattr(args, flag, False):
            setattr(cfg, dst, True)
    if getattr(args, "RunProfilePath", None):
        cfg.run_profile_path = args.RunProfilePath
    return cfg
