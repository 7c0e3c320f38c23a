"""Command-line program: the `rxmd` executable equivalent (rxmd_tpu's
`python -m rxmd_tpu`).

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

`processors nx ny nz` (or --vprocs) with nx*ny*nz > 1 runs the sharded
engine, one process per domain, each launched with the same arguments
and RXMD_COORDINATOR=host:port RXMD_NUM_PROCESSES=nx*ny*nz
RXMD_PROCESS_ID=0..n-1 (each process on card rank % device_count, NCCL;
with device="cpu", gloo).  Rank 0 alone prints and writes the
checkpoint; xyz and bin frames are written by every rank into one file
(io/slab.py), pdb and bnd frames by rank 0 from the gathered state.
"""
import os
import sys

import numpy as np
import torch


def main(argv=None, device=None):
    """Run the program; returns the exit code.  `device` is where the
    engine runs: None means "cuda" (which needs a card: without one the
    engine raises; it never moves to the CPU by itself)."""
    from . import config
    from .parallel import comm
    args = config.cli_parser().parse_args(argv)
    cfg = config.RunConfig()
    if os.path.exists(args.rxmdin):
        cfg = config.parse_rxmd_in(args.rxmdin, cfg)
    cfg = config.apply_cli(cfg, args)
    device = torch.device("cuda" if device is None else device)
    nvp = int(np.prod(cfg.vprocs))
    sharded = nvp > 1
    # the multi-process launch (the MPI world, ref: main.F90:10)
    joined = comm.init_from_env(device) is not None
    try:
        if joined:
            if comm.world()[1] != nvp:
                raise RuntimeError(
                    f"processors {tuple(cfg.vprocs)} makes {nvp} domain(s) "
                    f"but {comm.world()[1]} processes were launched: launch "
                    f"one process per domain, RXMD_NUM_PROCESSES={nvp} with "
                    f"RXMD_PROCESS_ID=0..{nvp - 1}")
            sharded = True
        elif sharded:
            raise RuntimeError(
                f"processors {tuple(cfg.vprocs)} makes {nvp} domains: "
                f"launch {nvp} processes of this command, each with "
                f"RXMD_COORDINATOR=host:port RXMD_NUM_PROCESSES={nvp} "
                f"RXMD_PROCESS_ID=0..{nvp - 1}")
        return _run(args, cfg, device, sharded)
    finally:
        if joined:
            comm.destroy()


def _run(args, cfg, device, sharded):
    from . import ffield, md, system
    from .io import checkpoint, refbin
    from .parallel import comm

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

    p0 = comm.world()[0] == 0
    out = sys.stdout if p0 else open(os.devnull, "w")
    say = lambda *a: print(*a, file=out)
    try:
        if sharded:
            from .parallel.engine import ShardedEngine
            eng = ShardedEngine(ff, st, cfg, mesh_shape=cfg.vprocs,
                                dtype=dtype, device=device)
        else:
            eng = md.Engine(ff, st, cfg, dtype=dtype, device=device)
        # the engine's copy: under mdmode 0 it runs (and the header names)
        # isQEq=1, and the caller's RunConfig keeps its own
        cfg = eng.cfg
        say("-" * 64)
        say(f"{'parameter set:':>30s} {ff.header}")
        say(f"{'time step[fs]:':>30s} {cfg.dt_fs:10.2e}")
        say(f"{'MDMODE CURRENTSTEP NTIMESTPE:':>30s} {cfg.mdmode} "
            f"{int(st.step)} {cfg.ntime_step}")
        say(f"{'isQEq,QEq_tol,NMAXQEq,qstep:':>30s} {cfg.isQEq} "
            f"{cfg.QEq_tol:.1e} {cfg.NMAXQEq} {cfg.qstep}")
        say(f"{'NATOMS:':>30s} {st.n}")
        if sharded:
            say(f"{'req proc arrangement:':>30s} {tuple(cfg.vprocs)} "
                f"ncap {eng.ncap} bcap {eng.bcap}")
        say(f"{'neighbor caps kb/knb:':>30s} {eng.kb}/{eng.knb} "
            f"caps {eng.caps}")
        say("-" * 64)
        say("nstep  TE  PE  KE: 1-Ebond 2-(Elnpr,Eover,Eunder) "
            "3-(Eval,Epen,Ecoa) 4-(Etors,Econj) 5-Ehbond "
            "6-(Evdw,EClmb,Echarge)")

        if p0:
            os.makedirs(cfg.data_dir, exist_ok=True)
        if sharded:
            eng.comm.barrier()

        def final_state():
            return eng.to_state() if sharded else eng.state

        if cfg.mdmode == 10:
            # structural optimization instead of MD (ref: main.F90:25,
            # cg.F90)
            from . import opt
            opt.conjugate_gradient(eng, ftol=cfg.ftol, log=say)
            fin = final_state()
            if p0:
                checkpoint.save(npz, fin)
                refbin.write_rxff_bin(rbin, fin)
            say("structural optimization finished")
            return 0

        frames = cfg.is_xyz or cfg.is_pdb or cfg.is_bondfile \
            or cfg.is_binary
        # pdb and bnd need the gathered state; xyz and bin have slab
        # writers (the MPI-IO analog, fileio.F90:81-95)
        need_gather = cfg.is_pdb or cfg.is_bondfile

        def writer(e):
            base = os.path.join(cfg.data_dir, f"{e.step_count:09d}")
            if not need_gather:
                e.write_frame_slab(base)
            else:
                stg = e.to_state()
                if p0:
                    e.write_frame(base, st=stg)

        def md_writer(state, comps):
            eng.write_frame(os.path.join(cfg.data_dir,
                                         f"{int(state.step):09d}"))

        eng.run(cfg.ntime_step, log=say,
                writer=(writer if sharded else md_writer) if frames else None)
        fin = final_state()
        if p0:
            checkpoint.save(npz, fin)
            refbin.write_rxff_bin(rbin, fin)
        # per-phase timing / occupancy / memory report (ref: FinalizeMD
        # main.F90:128-186)
        for line in eng.summary():
            say(line)
        say("rxmd-tpu successfully finished")
        return 0
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    sys.exit(main())
