"""repro_torch.core.vecsim.shard — the sharded streaming engine.

The windowed engine (``vecsim.stream``) keeps memory at O(N·W) however
many messages flow, but its process axis must fit one device.  This
package splits that axis over ``torch.distributed`` ranks — the port of
the JAX package's ``repro.core.vecsim.shard``, which splits it over a
device mesh: each rank owns an ``N/world`` row block of every plane, and
the only cross-rank traffic is the per-round frontier exchange (a ring
of each link slot's contribution plane, applied owner-locally by the
``ring_apply`` kernel after the ``slot_frontier`` kernel builds it), the
pong query ring, and sums of the stats and retirement aggregates.
Topology-quiescent segments of runs without live gating take a
bit-packed int16 fast body instead.

A sharded run's delivered matrix, series and ``NetStats`` equal the
windowed engine's byte for byte at every rank count.  On the card one
rank runs a card (NCCL); on the CPU ranks talk over gloo.

Modules:
  mesh     — the rank group, its collectives, and process-axis padding
  spanner  — the round bodies and retirement pieces on a row block
  driver   — ``execute_sharded``, ``ShardedStepper`` and the result type

Reachable from the front door as ``engine="sharded"``
(``repro_torch.api.run``, which also starts the ranks).
"""

from .driver import ShardedRunResult, ShardedStepper, execute_sharded
from .mesh import ShardGroup, pad_rows, resolve_world

__all__ = ["ShardedRunResult", "ShardedStepper", "execute_sharded",
           "ShardGroup", "resolve_world", "pad_rows"]
