"""Figures + csv conversion for stat output (the analysis plotting tool; a
copy of rxmd_tpu.tools.plot).

Re-implements the reference's plotting/convert scripts
(ref: util/stat/plot.py:1-152, util/script/csv.py:1-16) against the column
layouts written by `rxmd_tpu_torch.tools.stat.PairAnalysis.save` and
`bond_angle_distribution`:

  * gr.dat  -> gr.png   small multiples: one panel per type pair, g_ab(r)
               and running coordination n_ab(r); plus Gnr.png (neutron G(r))
  * sq.dat  -> snq.png  neutron-weighted structure factor S_n(q)
  * ba-*.dat -> <stem>.png  bond-angle distributions, one panel per triple
  * `to_csv` converts any whitespace table to `<file>.csv` (csv.py parity)

CLI:  python -m rxmd_tpu_torch.tools.plot [dir ...]
      python -m rxmd_tpu_torch.tools.plot --csv file ...

matplotlib is imported only by the figure functions; `read_table`,
`to_csv` and `write_ba_dat` need numpy alone.
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

# fixed categorical hue order (validated palette; assigned in order, never
# cycled — panels with >8 series fold into small multiples instead)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300",
          "#4a3aa7", "#e34948"]
_INK = "#3a3a38"       # text/axes ink (neutral; marks carry the color)
_GRID = "#d9d8d2"


def _style(ax, xlabel, ylabel):
    ax.grid(True, color=_GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(_INK)
    ax.tick_params(colors=_INK, labelsize=9)
    ax.set_xlabel(xlabel, color=_INK, fontsize=10)
    ax.set_ylabel(ylabel, color=_INK, fontsize=10)


def read_table(path):
    """Whitespace-delimited table with one header line -> (names, (n, c))."""
    with open(path) as fh:
        header = fh.readline().split()
        rows = [[float(x) for x in ln.split()] for ln in fh
                if ln.strip()]
    dat = np.asarray(rows)
    return header, dat


def to_csv(path, out=None):
    """Whitespace table -> comma-separated (ref: util/script/csv.py)."""
    out = out or path + ".csv"
    with open(path) as fh, open(out, "w") as oh:
        for line in fh:
            oh.write(",".join(line.split()) + "\n")
    return out


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def gr_plot(dirname=".", fname="gr.dat"):
    """Pair-distribution panels: one per type pair (g(r) + n(r), two fixed
    hues) and the neutron-weighted total G(r)."""
    path = os.path.join(dirname, fname)
    if not os.path.exists(path):
        return []
    plt = _plt()
    names, dat = read_table(path)
    r = dat[:, 0]
    grcols = [k for k, c in enumerate(names) if c.endswith("(gr)")]
    nrcols = {c[:-4]: k for k, c in enumerate(names) if c.endswith("(nr)")}
    npan = len(grcols)
    ncol = int(np.ceil(np.sqrt(npan))) or 1
    nrow = -(-npan // ncol) if npan else 1
    fig, axes = plt.subplots(nrow, ncol, figsize=(4.2 * ncol, 3.2 * nrow),
                             squeeze=False)
    for p, k in enumerate(grcols):
        ax = axes[p // ncol][p % ncol]
        pair = names[k][:-4]
        ax.plot(r, dat[:, k], color=SERIES[0], lw=2, label="g(r)")
        if pair in nrcols:
            ax.plot(r, dat[:, nrcols[pair]], color=SERIES[1], lw=2,
                    label="n(r)")
        ax.set_ylim(0, 6)
        ax.set_title(pair, color=_INK, fontsize=11)
        _style(ax, "r [Å]", "")
        ax.legend(frameon=False, fontsize=9, labelcolor=_INK)
    for p in range(npan, nrow * ncol):
        axes[p // ncol][p % ncol].axis("off")
    out1 = os.path.join(dirname, "gr.png")
    fig.tight_layout()
    fig.savefig(out1, dpi=120, bbox_inches="tight")
    plt.close(fig)

    outs = [out1]
    if "Gnr" in names:
        fig, ax = plt.subplots(figsize=(5.5, 3.6))
        ax.plot(r, dat[:, names.index("Gnr")], color=SERIES[0], lw=2)
        ax.set_title("neutron-weighted G(r)", color=_INK, fontsize=11)
        _style(ax, "r [Å]", "G(r)")
        out2 = os.path.join(dirname, "Gnr.png")
        fig.savefig(out2, dpi=120, bbox_inches="tight")
        plt.close(fig)
        outs.append(out2)
    return outs


def sq_plot(dirname=".", fname="sq.dat"):
    """Neutron-weighted structure factor S_n(q) (ref: sq_plot)."""
    path = os.path.join(dirname, fname)
    if not os.path.exists(path):
        return []
    plt = _plt()
    names, dat = read_table(path)
    fig, ax = plt.subplots(figsize=(5.5, 3.6))
    ax.plot(dat[:, 0], dat[:, 1], color=SERIES[0], lw=2)
    ax.set_title("S$_n$(q)", color=_INK, fontsize=11)
    _style(ax, "q [Å$^{-1}$]", "S(q)")
    out = os.path.join(dirname, "snq.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return [out]


def ba_plot(dirname="."):
    """Bond-angle distribution panels from ba-*.dat files (columns:
    angle_deg then one column per type triple)."""
    outs = []
    plt = _plt()
    for path in sorted(glob.glob(os.path.join(dirname, "ba-*.dat"))):
        names, dat = read_table(path)
        ang = dat[:, 0]
        series = names[1:]
        npan = len(series)
        ncol = int(np.ceil(np.sqrt(npan))) or 1
        nrow = -(-npan // ncol) if npan else 1
        fig, axes = plt.subplots(nrow, ncol,
                                 figsize=(4.2 * ncol, 3.0 * nrow),
                                 squeeze=False)
        for p, nm in enumerate(series):
            ax = axes[p // ncol][p % ncol]
            ax.plot(ang, dat[:, p + 1], color=SERIES[0], lw=2)
            ax.set_xlim(0, 180)
            ax.set_xticks((0, 30, 60, 90, 120, 150, 180))
            ax.set_title(nm, color=_INK, fontsize=11)
            _style(ax, "angle [deg]", "")
        for p in range(npan, nrow * ncol):
            axes[p // ncol][p % ncol].axis("off")
        out = path[:-4] + ".png"
        fig.tight_layout()
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        outs.append(out)
    return outs


def write_ba_dat(hists, names, path, nbins=180):
    """Write bond-angle histograms (from
    `stat.bond_angle_distribution`) in the reference's ba-*.dat layout."""
    ang = (np.arange(nbins) + 0.5) * (180.0 / nbins)
    keys = sorted(hists.keys())
    with open(path, "w") as fh:
        fh.write("angle " + " ".join(
            f"{names[a]}-{names[b]}-{names[c]}" for a, b, c in keys) + "\n")
        for k in range(nbins):
            fh.write(f"{ang[k]:10.3f} " + " ".join(
                f"{hists[key][k]:12.5f}" for key in keys) + "\n")
    return path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "--csv":
        for path in argv[1:]:
            print(to_csv(path))
        return
    dirs = argv or ["."]
    for d in dirs:
        for out in gr_plot(d) + sq_plot(d) + ba_plot(d):
            print(out)


if __name__ == "__main__":
    main()
