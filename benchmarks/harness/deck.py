"""The cell's inputs, made from the configuration, the traffic mix and the
seed: the deck's positions, types and box (the cell file replicated), the
start velocities drawn from the Maxwell-Boltzmann distribution, and for a
relaxation the start positions rattled.  The same seed gives the same
inputs; every seed gives the same atoms, box and work, in another state."""
from __future__ import annotations

import dataclasses

import numpy as np

from reference import evaluate as ref
from reference import units

from .spec import data_path


@dataclasses.dataclass
class Inputs:
    ff: object            # the reference's ForceField (masses, names)
    pos: np.ndarray       # (n, 3) [A]
    vel: np.ndarray       # (n, 3) [A / internal time unit]
    types: np.ndarray     # (n,) int64
    H: np.ndarray         # (3, 3) lattice vectors as columns


def maxwell_boltzmann(rng, masses, temp):
    """Velocities at temperature `temp` [K]: each component normal with
    variance kT/m, the centre-of-mass momentum removed, scaled so that
    the kinetic temperature is `temp` exactly (ref: INITVELOCITY
    init.F90:292-360, in the units of reference/units.py)."""
    v = rng.normal(size=(len(masses), 3)) / np.sqrt(masses)[:, None]
    v -= (masses[:, None] * v).sum(0) / masses.sum()
    ke = 0.5 * np.sum(masses * np.sum(v * v, axis=1)) / len(masses)
    return v * np.sqrt(temp / (ke * units.UTEMP))


def make(config, traffic, seed):
    deck = config["deck"]
    ff, pos, types, H = ref.load_deck(data_path(deck["cell"]),
                                      data_path(deck["ffield"]),
                                      tuple(deck["replicate"]))
    rng = np.random.default_rng(int(seed))
    draw = traffic["draw"]
    vel = np.zeros_like(pos)
    if draw.get("temperature_K"):
        vel = maxwell_boltzmann(rng, ff.mass[types], draw["temperature_K"])
    if draw.get("rattle_A"):
        pos = pos + rng.normal(scale=draw["rattle_A"], size=pos.shape)
    return Inputs(ff=ff, pos=pos, vel=vel, types=types, H=H)
