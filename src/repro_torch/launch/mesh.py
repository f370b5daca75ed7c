"""Device meshes.  Functions, never module-level constants: importing
this module touches no process group.

The port of the JAX package's ``launch/mesh.py``:

  * :func:`make_production_mesh` — the dry-run's meshes, JAX's
    ``(16, 16)`` ("data", "model") and, multi-pod, ``(2, 16, 16)``
    ("pod", "data", "model"), as a ``DeviceMesh`` over a *fake* process
    group of 256 or 512 ranks in this one process.  Its collectives move
    nothing; with ``meta`` tensors the dry-run traces a production step
    on one host.  It never touches the card.
  * :func:`make_local_mesh` — a ("data", "model") mesh over the ranks
    that exist: the default process group, NCCL on cards (one card a
    rank), gloo on the CPU.

The fake group is PyTorch's test backend
(``torch.testing._internal.distributed.fake_pg``), an internal module;
this file is the one place that imports it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "init_fake_group"]


def init_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (the default group; a fake group of another size is replaced).
    Raises if a real process group exists: the fake group must not meet
    the NCCL or gloo groups of a real run, so the dry-run runs in a
    process of its own."""
    if dist.is_initialized():
        if dist.get_backend() == "fake":
            if dist.get_world_size() == world:
                return
            dist.destroy_process_group()
        else:
            raise RuntimeError(
                "a process group is initialized already; the dry-run's "
                "fake group needs a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 ranks as (16 data x 16 model).  Multi-pod: 2 pods
    = 512 ranks as (2 pod x 16 data x 16 model).  Over a fake group (see
    :func:`init_fake_group`), for the dry-run only."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 1
    for s in shape:
        world *= s
    init_fake_group(world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A (data x model) mesh over the default process group's ranks
    (``data * model`` of them), on the card unless ``device="cpu"``
    (the group's backend must fit: NCCL for the card, gloo for the
    CPU).  Without a process group, ``data = model = 1`` starts a
    one-rank group of the right backend in this process."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..backend import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        if data * model != 1:
            raise RuntimeError(
                f"a ({data}, {model}) mesh needs {data * model} ranks; "
                "start them and initialize torch.distributed first")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
