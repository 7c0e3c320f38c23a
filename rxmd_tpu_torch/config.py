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
    qeq_dense_max: int = 8192    # pair-list engine, full CG only: fold the
                                 # QEq hessian into a dense (N, N) matrix
                                 # once per solve when N <= this, each CG
                                 # matvec a matmul (4 N^2 bytes in float32);
                                 # 0 keeps the per-iteration list gathers
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
    dtype: str = "float64"       # float64 runs the table pair-list engine
                                 # (any device); float32 the closed-form
                                 # pair sweep, whose CUDA kernels are
                                 # float32
    kb_cap: int = 0              # 0 = auto-size from first neighbor build
    knb_cap: int = 0
    nbr_skin: float = 0.4        # Verlet skin [A] added to list cutoffs.
                                 # The drift monitor rebuilds lists when
                                 # max displacement exceeds skin/2 (~32
                                 # steps at 300K, dt 0.25 fs)
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
    term_cache: bool = True      # cache angle/torsion/hbond lists on the
                                 # rebuild cadence (False = enumerate them
                                 # in every energy call with exact gates,
                                 # the reference's per-step semantics)
    pair_kernel: bool = None     # the cell-column pair sweep (ops/pairsweep,
                                 # CUDA kernels on a card, their plain
                                 # versions on the CPU) as the nonbond +
                                 # QEq engine.  It takes the closed form,
                                 # an orthogonal box, cached term lists and
                                 # no tighten_lists.  None: the sweep where
                                 # it can run, else the dense forms or the
                                 # pair list (md.Engine.pair_engine says
                                 # which); True: the sweep, raising where
                                 # it cannot run; False: never the sweep.
    block_steps: int = 10        # MD steps per block dispatch, as
                                 # rxmd_tpu's lax.scan blocks: blocks end on
                                 # print/write/thermostat/rebuild boundaries
                                 # and within the drift budget (md.Engine.
                                 # run); one CUDA graph on a card for the
                                 # sweep engine.  1 disables.
    dense_direct_max: int = 12288
                                 # the dense minimum-image engine for the
                                 # QEq hessian and nonbond ((n, n) pair
                                 # matrices, no neighbor list), taken off
                                 # the sweep with the closed form, an
                                 # orthogonal box with min(L) > 2*rctap
                                 # and n <= this cap.  O(n^2) memory: each
                                 # (n, n) float32 matrix is 4 n^2 bytes
                                 # (260 MB at 8,064 atoms), and the nonbond
                                 # holds a few tens of them.  0 disables.
    list_chunk: int = 4096       # rxmd_tpu: row-chunk size of its torsion/
                                 # hbond list builds; the port accepts it
                                 # and builds in one piece.
    nonbond_closed_form: bool = None
                                 # None: the closed-form vdW/Coulomb/QEq
                                 # kernels in float32, the reference's
                                 # interpolation tables in float64 (which
                                 # run on the pair list; they part from
                                 # the closed form by the tables' own
                                 # interpolation error, ~2e-3 kcal/mol
                                 # per atom).  True/False forces.
    tighten_lists: bool = False  # filter the skinned neighbor lists to the
                                 # true cutoffs every step (capacities
                                 # kb_t/knb_t; implies uncached term
                                 # lists); the energy kernels re-check the
                                 # cutoffs either way, so results are the
                                 # same
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
