"""The tensorized round engine with the process axis split over ranks.

The port of the JAX package's ``core/engine/sharded.py``.  JAX runs the
round body unmodified under ``jax.jit`` with the state sharded on the
process axis and lets XLA insert the collectives; here the rows are
split over the ranks of a ``torch.distributed`` group
(``core.vecsim.shard.mesh``: gloo on the CPU, NCCL on cards, one card a
rank), each rank keeping ``n / world`` rows of every plane, and a round
exchanges exactly what it reads from other ranks' rows:

  * after phase 4, ``delivered`` of every row (phase 5 reads the pong
    targets' ping columns; phases 6 and 7 read the senders' rows);
  * after phase 5, the link slots of every row (the senders' targets,
    delays, activity, gates and flush rounds), packed into one gather.

Each rank then scatters every sender's values into the rows it owns and
drops the rest, so the exchange is an all-gather and an owner-local
scatter-min; int32 min commutes, so the result is byte-equal to one
device's.  The process axis is padded to a multiple of the rank count
with inert rows (no links, never targeted), as in JAX.
"""

from __future__ import annotations

import numpy as np

from ...backend import resolve_device
from ..vecsim.shard.mesh import ShardGroup, resolve_world
from .state import EngineConfig, Schedule
from .step import initial_state, make_step

__all__ = ["run_engine_sharded", "pad_instance"]


def pad_instance(cfg: EngineConfig, adj0: np.ndarray, delay0: np.ndarray,
                 n_devices: int):
    """Pad the process axis to a multiple of the device count with inert,
    link-less processes (they never send or receive)."""
    n = cfg.n
    n_pad = (-n) % n_devices
    if n_pad == 0:
        return cfg, adj0, delay0
    adj0 = np.concatenate([adj0, np.full((n_pad, cfg.k), -1, adj0.dtype)])
    delay0 = np.concatenate(
        [delay0, np.ones((n_pad, cfg.k), delay0.dtype)])
    cfg = EngineConfig(n=n + n_pad, k=cfg.k, rounds=cfg.rounds, mode=cfg.mode,
                       pong_delay=cfg.pong_delay, always_gate=cfg.always_gate)
    return cfg, adj0, delay0


def run_engine_sharded(cfg: EngineConfig, sched: Schedule, adj0, delay0,
                       device=None, devices=None):
    """``run_engine``'s contract with the process rows split over the
    ranks of the process group (``devices`` of them; None: the group's
    size, 1 without a group).  Every rank returns the whole padded
    ``delivered`` (N padded, M) as numpy; rows ``n:`` are the padding."""
    dev = resolve_device(device)
    rank, world = resolve_world(devices, dev)
    cfg, adj0, delay0 = pad_instance(cfg, np.asarray(adj0),
                                     np.asarray(delay0), world)
    n_loc = cfg.n // world
    group = ShardGroup(rank, world, dev, rank * n_loc)
    rows = slice(group.off, group.off + n_loc)
    state = initial_state(cfg, sched, adj0, delay0, dev, rows)
    gather = None if world == 1 else (
        lambda t: group.gather_rows(t, everywhere=True))
    step = make_step(cfg, sched, dev, off=group.off, n_loc=n_loc,
                     gather=gather)
    for t in range(cfg.rounds):
        state = step(state, t)
    return group.gather_rows(state[1], everywhere=True).cpu().numpy()
