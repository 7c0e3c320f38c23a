"""The system under test: rxmd_tpu_torch's md.Engine on the cell's deck,
handed the inputs that deck.py made.  The engine's settings are the deck's
rxmd.in, then the configuration's `run_config`, then the traffic mix's
(RunConfig field names).  The configuration declares the pair engine
that its settings select (`engine`); the engine is refused where the port
chose another.  The port's kernels build into build/ of this checkout, a
fixed directory that every run of a cell finds again."""
from __future__ import annotations

import dataclasses
import os

import torch

from .spec import ROOT, data_path

BUILD_DIR = os.path.join(ROOT, "build", "rxmd_tpu_torch")


def settings(config, traffic, inputs, device):
    """(ForceField, RunConfig, State) of the cell, the port's kernels
    building into BUILD_DIR."""
    from rxmd_tpu_torch import config as rconfig
    from rxmd_tpu_torch import ffield, system
    from rxmd_tpu_torch.io import traj
    from rxmd_tpu_torch.ops import pairsweep
    pairsweep._BUILD_DIR = traj._BUILD_DIR = BUILD_DIR
    deck = config["deck"]
    cfg = rconfig.parse_rxmd_in(data_path(deck["rxmd_in"]))
    cfg = dataclasses.replace(cfg, ffield_path=data_path(deck["ffield"]),
                              **config["run_config"], **traffic["run_config"])
    ff = ffield.parse_ffield(cfg.ffield_path)
    st = system.make_state(inputs.pos, inputs.types, inputs.H,
                           vel=inputs.vel, dtype=getattr(torch, cfg.dtype),
                           device=device)
    return ff, cfg, st


def engine(config, traffic, inputs, device):
    from rxmd_tpu_torch import md
    ff, cfg, st = settings(config, traffic, inputs, device)
    eng = md.Engine(ff, st, cfg, device=device)
    if eng.pair_engine != config["engine"]:
        raise RuntimeError(
            f"{config['name']} declares the pair engine "
            f"{config['engine']!r}; its settings gave {eng.pair_engine!r}")
    return eng


def snapshot(eng, **extra):
    """The engine's state, forces and PE components as float64 numpy."""
    s = eng.state
    host = lambda t: t.detach().double().cpu().numpy()
    return dict(pos=host(s.pos), vel=host(s.vel), q=host(s.q),
                qsfp=host(s.qsfp), force=host(eng.force),
                comps=host(eng.comps), step=int(s.step), **extra)


def bond_sums(eng):
    """Each atom's summed bond order over the port's bond table (the .bnd
    writer's, every bond order above 0) at the engine's state."""
    _, bos, _ = eng.bond_table(bo_cutoff=0.0)
    return bos.double().sum(dim=1).cpu().numpy()
