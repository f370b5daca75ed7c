"""Multi-rank harness of the port's distribution tests (the sharded
round engine, the GPipe pipeline and the DTensor train cell): spawn
``world`` CPU ranks joined over gloo, run one function of this module on
every rank, and return rank 0's result.

The ranks import only ``repro_torch`` (the JAX references run in the
test process), so spawning costs one torch import a rank.  The process
group starts from a ``FileStore`` under the test's ``tmp_path``, so
parallel test workers never fight over a TCP port, and the join has a
deadline: a hung rank fails the test instead of stalling the suite.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time


def _worker(rank, world, store_path, fn_name, args, out_path):
    import torch
    import torch.distributed as dist

    # the ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = globals()[fn_name](rank, world, *args)
        if rank == 0:
            with open(out_path, "wb") as fh:
                pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def run_on_ranks(world, tmp_path, fn_name, args=(), timeout=300.0):
    """Rank 0's result of ``fn_name(rank, world, *args)`` (a function of
    this module) run on ``world`` spawned gloo ranks; raises if a rank
    fails or the deadline passes."""
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp_path), f"store_{fn_name}_{world}")
    out = os.path.join(str(tmp_path), f"out_{fn_name}_{world}.pkl")
    for path in (store, out):
        if os.path.exists(path):      # left by an earlier run
            os.remove(path)
    ctx = mp.start_processes(_worker,
                             args=(world, store, fn_name, args, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world} ranks did not finish in "
                               f"{timeout} s")
    with open(out, "rb") as fh:
        return pickle.load(fh)


def _gather(obj, world):
    """Every rank's ``obj``, in rank order (on every rank)."""
    import torch.distributed as dist
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


# ------------------------------------------------------------------ #
# the sharded round engine
# ------------------------------------------------------------------ #
def engine_cases(rank, world, cases):
    """``run_engine_sharded`` on each (cfg, sched, adj0, delay0)."""
    from repro_torch.core.engine.sharded import run_engine_sharded
    return [run_engine_sharded(cfg, sched, adj0, delay0, device="cpu")
            for cfg, sched, adj0, delay0 in cases]


# ------------------------------------------------------------------ #
# the GPipe pipeline
# ------------------------------------------------------------------ #
def pipeline_case(rank, world, params, mb):
    """The pipelined stack of tanh(x @ w + b) stages over ``world``
    stages: outputs and the gradients of mean(out ** 2), summed over the
    stages."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.pipeline import pipeline

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    piped = pipeline(lambda q, x: torch.tanh(x @ q["w"] + q["b"]), mesh)
    out = piped(p, torch.from_numpy(mb))
    (out ** 2).mean().backward()
    grads = {}
    for k, v in p.items():
        g = v.grad.clone()
        dist.all_reduce(g)
        grads[k] = g.numpy()
    return out.detach().numpy(), grads


# ------------------------------------------------------------------ #
# the DTensor train cell
# ------------------------------------------------------------------ #
def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def cell_cases(rank, world, cases):
    """Each case ``(name, cfg, jax_params, batch, options)``: the cell
    built by ``launch.dryrun.build_cell`` on a (2, world // 2) mesh from
    the JAX weights: the loss and gradients of the step's grad function
    and the parameters after one train step, as full numpy arrays; for
    MoE configs the routing integers of rank 0's batch rows.  A case
    ``("joint", ...)`` instead reports each rank's rows of a tensor
    split over ("data", "model") jointly; options ``{"decode": True}``
    a decode step instead (:func:`_decode_case`)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import from_jax_params
    from repro_torch.sharding.policy import placements, use_mesh
    from repro_torch.training.step import make_grad_fn

    mesh = make_local_mesh(2, world // 2, device="cpu")
    results = []
    for name, cfg, jparams, batch, opts in cases:
        if name == "joint":
            rows = torch.arange(4 * world * 3).reshape(4 * world, 3)
            d = distribute_tensor(rows, mesh, placements(
                (("data", "model"), None), mesh))
            results.append(_gather(d.to_local()[:, 0].tolist(), world))
            continue
        model = from_jax_params(cfg, jparams, device="cpu")
        if opts.get("decode"):
            results.append(_decode_case(model, cfg, batch, mesh))
            continue
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        b, s = tb["labels"].shape
        shape = ShapeSpec("cell", s, b, "train")
        fn, args, _, _ = build_cell(cfg, shape, mesh, remat="none",
                                    model=model, batch=tb, **opts)
        params, _, placed = args
        seen = []
        orig = moe.route

        def keep(p, cfg_, x, train):
            r = orig(p, cfg_, x, train)
            seen.append({k: getattr(r, k).numpy()
                         for k in ("idx", "order", "rank", "keep")})
            return r
        moe.route = keep
        try:
            with use_mesh(mesh), implicit_replication():
                (loss, _), grads = make_grad_fn(model)(params, placed)
            grads = {k: _full(g).numpy() for k, g in grads.items()}
            loss = float(_full(loss))
            _, _, metrics = fn(*args)
        finally:
            moe.route = orig
        results.append(dict(
            loss=loss, grads=grads,
            step_loss=float(_full(metrics["loss"])),
            params={k: _full(v).detach().numpy() for k, v in params.items()},
            routing=seen))
    return results


def _decode_case(model, cfg, batch, mesh):
    """One decode step of DTensor parameters and serving caches placed
    by ``cache_specs`` (a KV cache whose few heads do not divide the
    model axis is sequence-sharded) from the one-device prefill's
    caches, and the one-device decode step's logits, as numpy."""
    import numpy as np
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import _place_tree
    from repro_torch.launch.specs import (make_serving_inputs, param_specs,
                                          shapes_and_axes)
    from repro_torch.sharding.policy import distribute, use_mesh
    from repro_torch.training.step import bound

    tokens = torch.from_numpy(np.asarray(batch["tokens"]))[:, :8]
    b, s = tokens.shape
    with torch.no_grad():
        _, caches = model.prefill(tokens, pad_to=s + 4)
        copy = [[{k: tuple(t.clone() for t in v) for k, v in c.items()}
                 for c in stack] for stack in caches]
        want, _ = model.decode_step(tokens[:, -1], copy, s)
    _, (tspec, cspec, _) = make_serving_inputs(
        cfg, ShapeSpec("decode", s + 4, b, "decode"), mesh)
    shapes, axes = shapes_and_axes(model)
    params = distribute(shapes, param_specs(cfg, shapes, axes, mesh), mesh)
    with use_mesh(mesh), implicit_replication(), bound(model, params), \
            torch.no_grad():
        got, _ = model.decode_step(
            _place_tree(tokens[:, -1].contiguous(), tspec, mesh),
            _place_tree(caches, cspec, mesh), s)
    return dict(got=_full(got).numpy(), want=want.numpy())
