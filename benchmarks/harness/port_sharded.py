"""The system under test on several cards: rxmd_tpu_torch's ShardedEngine,
one process per domain of the configuration's `mesh`, each on its own card,
handed the inputs that deck.py made (every rank makes the same from the
seed).  Its settings are port.py's.  The sharded engine runs the pair list
(Engine.pair_engine "ell"); a configuration that declares another engine
is refused.

`join` enters the launch's process group through the port's own launch
variables (RXMD_COORDINATOR, RXMD_NUM_PROCESSES, RXMD_PROCESS_ID: harness/
launch.py sets them) and opens a gloo group beside it for the harness's
own collectives (the window's stop, the gathers), which leave the port's
NCCL streams alone.  A process that no launcher started runs mesh
(1, 1, 1) with no group.  `snapshot` gathers the domains' rows to rank 0
in global-id order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import port


def join(device):
    """(this rank's device, the harness's group or None)."""
    from rxmd_tpu_torch.parallel import comm
    device = torch.device(device)
    dev = comm.init_from_env(device.type)
    if dev is None:
        return device, None
    return dev, dist.new_group(backend="gloo")


def leave():
    from rxmd_tpu_torch.parallel import comm
    comm.destroy()


def rank(group):
    return 0 if group is None else dist.get_rank()


def gather(obj, group):
    """Every rank's `obj` in rank order on rank 0; None on the others."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size() if rank(group) == 0 else None
    dist.gather_object(obj, out, dst=0, group=group)
    return out


def barrier(group):
    if group is not None:
        dist.barrier(group=group)


def stop(mine, group):
    """Rank 0's `mine` on every rank, by one all-reduce."""
    if group is None:
        return mine
    flag = torch.tensor([int(mine and rank(group) == 0)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag[0])


def engine(config, traffic, inputs, device):
    from rxmd_tpu_torch.parallel.engine import ShardedEngine
    if config["engine"] != "ell":
        raise RuntimeError(
            f"{config['name']} declares the pair engine "
            f"{config['engine']!r}; the sharded engine runs the pair list "
            "('ell')")
    ff, cfg, st = port.settings(config, traffic, inputs, device)
    return ShardedEngine(ff, st, cfg, mesh_shape=tuple(config["mesh"]),
                         device=device)


def snapshot(eng, group, bonds=False):
    """port.snapshot's fields over the whole mesh on rank 0 (None on the
    others): each domain's residents gathered, in global-id order, as
    float64 numpy; positions from the domains' fractional coordinates;
    with `bonds`, each atom's summed bond order (`bo_sum`)."""
    s = eng.sstate
    mine = s.valid
    host = lambda t: t[mine].detach().double().cpu().numpy()
    rows = dict(gid=s.gid[mine].cpu().numpy(), frac=host(s.frac),
                vel=host(s.vel), q=host(s.q), qsfp=host(s.qsfp),
                force=host(eng.force))
    if bonds:
        rows["bo_sum"] = host(bond_sums(eng))
    parts = gather(rows, group)
    if parts is None:
        return None
    cat = {k: np.concatenate([p[k] for p in parts]) for k in rows}
    order = np.argsort(cat["gid"], kind="stable")
    if not np.array_equal(cat["gid"][order], np.arange(eng.n)):
        raise RuntimeError("the domains' residents are not every atom once")
    H = eng.Hg.detach().double().cpu().numpy()
    return dict(pos=cat["frac"][order] @ H.T,
                **{k: cat[k][order] for k in rows if k not in ("gid", "frac")},
                comps=eng.comps.detach().double().cpu().numpy(),
                step=int(eng.step_count))


def bond_sums(eng):
    """Each of this domain's rows' summed bond order (every bond order above
    0, as the port's bond table keeps them), (ncap,): reax.bond_order over
    the domain's rows at the engine's positions, its ghosts refreshed
    through the last rebuild's halo plan, on the rebuild's bonded lists, as
    the engine's own step computes them.  The refresh is a collective:
    every rank calls it.  Each domain reads only its own rows, so no card
    holds the whole deck's lists."""
    from rxmd_tpu_torch import reax
    from rxmd_tpu_torch.parallel import halo
    b, s = eng._block, eng.sstate
    frac = halo.apply_plan(b.plan, s.frac, eng.spec, eng.comm, True)[b.keep]
    bo = reax.bond_order((frac - eng.mylo) @ eng.Hg.T, eng.Hg, b.tex, b.img,
                         b.nbrs, eng.ffd)
    bo0 = bo.bo[..., 0]
    return torch.where(bo.mask & (bo0 > 0), bo0, 0.0).sum(dim=1)[:eng.ncap]
