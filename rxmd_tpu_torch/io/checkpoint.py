"""Native checkpoint/restore (counterpart of rxmd_tpu.io.checkpoint).

Carries exactly the reference's restart payload (ref: fileio.F90:558-653):
positions, velocities, charges, types, global ids, the extended-Lagrangian
charge state qsfp/qsfv (so QEq warm restart is exact), the step counter,
the box and the PQEq shell displacements `spos` (zeros unless PQEq) — as a
compressed npz.  The file is rxmd_tpu's (types and ids int32): either
package restarts from the other's; a file without `spos` loads zeros.
"""
from __future__ import annotations

import numpy as np
import torch

from ..system import State, make_state
from . import host


def save(path: str, state: State):
    pos = host(state.pos)
    np.savez_compressed(
        path,
        pos=pos, vel=host(state.vel), q=host(state.q),
        qsfp=host(state.qsfp), qsfv=host(state.qsfv),
        types=host(state.types).astype(np.int32),
        gid=host(state.gid).astype(np.int32), H=host(state.H),
        step=int(state.step), spos=host(state.spos))


def load(path: str, dtype=torch.float64, device="cpu") -> State:
    with np.load(path) as z:
        return make_state(z["pos"], z["types"], z["H"], vel=z["vel"],
                          q=z["q"], qsfp=z["qsfp"], qsfv=z["qsfv"],
                          gid=z["gid"], step=int(z["step"]),
                          spos=z["spos"] if "spos" in z else None,
                          dtype=dtype, device=device)
