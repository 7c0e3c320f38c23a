"""geninit — initial-configuration generator (ref: init/geninit.F90:307-589),
the counterpart of rxmd_tpu.tools.geninit.

Reads a unit-cell xyz (element names + fractional coords), replicates it
mc(1:3) times, and writes DAT/rxff.bin (reference format, readable by both
packages) plus a native DAT/rxff.npz and a debug geninit.xyz.

CLI mirrors the reference flags:
    python -m rxmd_tpu_torch.tools.geninit -i input.xyz -f ffield -o DAT/ \
        -mc 1 1 1 [-vprocs 1 1 1]
"""
import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="geninit")
    p.add_argument("-i", "--inputxyz", default="input.xyz")
    p.add_argument("-f", "--ffield", default="ffield")
    p.add_argument("-o", "--outdir", default="DAT")
    p.add_argument("-mc", nargs=3, type=int, default=[1, 1, 1])
    p.add_argument("-vprocs", "-v", nargs=3, type=int, default=[1, 1, 1])
    p.add_argument("--lg", action="store_true")
    args = p.parse_args(argv)

    from .. import ffield, system
    from ..io import checkpoint, refbin, traj

    ff = ffield.parse_ffield(args.ffield, lg=args.lg)
    st = system.from_cellfile(args.inputxyz, ff.name_to_type,
                              mc=tuple(args.mc))
    os.makedirs(args.outdir, exist_ok=True)
    refbin.write_rxff_bin(os.path.join(args.outdir, "rxff.bin"), st,
                          vprocs=tuple(args.vprocs))
    checkpoint.save(os.path.join(args.outdir, "rxff.npz"), st)
    traj.write_xyz(os.path.join(args.outdir, "geninit.xyz"), st,
                   ff.atom_names)
    print(f"geninit: {st.n} atoms ({'x'.join(map(str, args.mc))} cells) "
          f"-> {args.outdir}/rxff.bin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
