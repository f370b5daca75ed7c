"""repro_torch.core.engine — the tensorized PC-broadcast round engine.

The port of the JAX package's ``repro.core.engine``: the event-driven
simulation as a bulk-synchronous round simulation over dense per-round
state (``state.py``), its numpy oracle (``ref.py``), the round body on
torch tensors (``step.py``) and the process axis split over ranks
(``sharded.py``).  The engine has no kernel of its own: its scatters and
gathers are plain tensor operations, as JAX's are ``jnp``.
"""

from .ref import analyze, run_ref
from .state import INF, EngineConfig, Schedule, build_state, random_instance
from .step import make_step, run_engine

__all__ = [
    "INF", "EngineConfig", "Schedule", "build_state", "random_instance",
    "analyze", "run_ref", "make_step", "run_engine",
]
