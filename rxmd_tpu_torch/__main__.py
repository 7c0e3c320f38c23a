"""Command-line program: the `rxmd` executable equivalent on one device (the
single-device path of rxmd_tpu's `python -m rxmd_tpu`).

Usage (mirrors the reference, ref: main.F90:2-114, cmdline.F90):

    python -m rxmd_tpu_torch [--rxmdin rxmd.in] [--ffield ffield] \
        [--run_from_xyz cell.xyz [--mc 1 1 1]] [--outDir DAT] \
        [--dtype float32] [overrides...]

Reads the rxmd.in deck, takes the input configuration from --run_from_xyz,
else DAT/rxff.npz (native checkpoint), else DAT/rxff.bin (reference
format), runs the MD loop (or the CG optimizer for mdmode 10) on a CUDA
card with PRINTE-format output and trajectory frames, and writes the final
rxff.npz and rxff.bin.  The default --dtype float64 runs the reference's
interpolation tables over the pair list; --dtype float32 runs the
closed-form pair sweep and its CUDA kernels (md.Engine.pair_engine).
`PQEqParm` in rxmd.in (or --pqeq) runs PQEq and --lg reads a ReaxFF-lg
force field; both run on the pair list (LG also on the dense forms), and
the summary's first line names what ran.
"""
import os
import sys

import numpy as np
import torch


def main(argv=None, device=None):
    """Run the program; returns the exit code.  `device` is where the
    engine runs: None means "cuda" (which needs a card: without one the
    engine raises; it never moves to the CPU by itself)."""
    from . import config, ffield, md, system
    from .io import checkpoint, refbin
    if os.environ.get("RXMD_COORDINATOR"):
        raise NotImplementedError(
            "RXMD_COORDINATOR is set: a multi-process run needs the sharded "
            "engine, which rxmd_tpu_torch does not have")
    args = config.cli_parser().parse_args(argv)
    cfg = config.RunConfig()
    if os.path.exists(args.rxmdin):
        cfg = config.parse_rxmd_in(args.rxmdin, cfg)
    cfg = config.apply_cli(cfg, args)
    nvp = int(np.prod(cfg.vprocs))
    if nvp > 1:
        raise NotImplementedError(
            f"processors {tuple(cfg.vprocs)} ({nvp} domains) needs the "
            "sharded engine, which rxmd_tpu_torch does not have; run "
            "processors 1 1 1")
    device = torch.device("cuda" if device is None else device)

    ff = ffield.parse_ffield(cfg.ffield_path, lg=args.lg)

    dtype = getattr(torch, cfg.dtype)
    npz = os.path.join(cfg.data_dir, "rxff.npz")
    rbin = os.path.join(cfg.data_dir, "rxff.bin")
    if args.run_from_xyz:
        mc = tuple(args.mc) if args.mc else (1, 1, 1)
        st = system.from_cellfile(args.run_from_xyz, ff.name_to_type,
                                  mc=mc, dtype=dtype)
    elif os.path.exists(npz):
        st = checkpoint.load(npz, dtype)
    elif os.path.exists(rbin):
        st, _ = refbin.read_rxff_bin(rbin, dtype)
    else:
        print("ERROR: no input configuration "
              "(DAT/rxff.bin, DAT/rxff.npz or --run_from_xyz)",
              file=sys.stderr)
        return 1

    eng = md.Engine(ff, st, cfg, dtype=dtype, device=device)
    print("-" * 64)
    print(f"{'parameter set:':>30s} {ff.header}")
    print(f"{'time step[fs]:':>30s} {cfg.dt_fs:10.2e}")
    print(f"{'MDMODE CURRENTSTEP NTIMESTPE:':>30s} {cfg.mdmode} "
          f"{int(st.step)} {cfg.ntime_step}")
    print(f"{'isQEq,QEq_tol,NMAXQEq,qstep:':>30s} {cfg.isQEq} "
          f"{cfg.QEq_tol:.1e} {cfg.NMAXQEq} {cfg.qstep}")
    print(f"{'NATOMS:':>30s} {st.n}")
    print(f"{'neighbor caps kb/knb:':>30s} {eng.kb}/{eng.knb} "
          f"caps {eng.caps}")
    print("-" * 64)
    print("nstep  TE  PE  KE: 1-Ebond 2-(Elnpr,Eover,Eunder) "
          "3-(Eval,Epen,Ecoa) 4-(Etors,Econj) 5-Ehbond "
          "6-(Evdw,EClmb,Echarge)")

    os.makedirs(cfg.data_dir, exist_ok=True)

    if cfg.mdmode == 10:
        # structural optimization instead of MD (ref: main.F90:25, cg.F90)
        from . import opt
        opt.conjugate_gradient(eng, ftol=cfg.ftol)
        checkpoint.save(npz, eng.state)
        refbin.write_rxff_bin(rbin, eng.state)
        print("structural optimization finished")
        return 0

    def writer(state, comps):
        eng.write_frame(os.path.join(cfg.data_dir, f"{int(state.step):09d}"))

    eng.run(cfg.ntime_step,
            writer=writer if (cfg.is_xyz or cfg.is_pdb or cfg.is_bondfile
                              or cfg.is_binary) else None)
    checkpoint.save(npz, eng.state)
    refbin.write_rxff_bin(rbin, eng.state)
    # per-phase timing / occupancy / memory report (ref: FinalizeMD
    # main.F90:128-186)
    for line in eng.summary():
        print(line)
    print("rxmd-tpu successfully finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
