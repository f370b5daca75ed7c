"""The multi-pod dry-run.

The port of the JAX package's ``launch/dryrun.py``.  For every runnable
(arch x shape) cell and production mesh it builds the real step function
(:func:`build_cell`) with DTensor parameters, optimizer state and inputs
placed by the sharding policy, all on ``meta`` over a *fake* process
group of 256 or 512 ranks (``launch/mesh.py``), and runs it once in this
process.  Nothing is allocated and no collective moves a byte; where JAX
lowers and compiles, the port traces.

While the step runs, a dispatch mode (:class:`CellCounter`) sees what
one device would run — DTensor's own ops are let through to desugar
into local ops and collectives first — and counts:

  * flops, by ``FlopCounterMode``'s formulas on the local ops (the mode
    itself, on a DTensor program, counts each op's global flops, so it
    cannot give the per-device count; the scans' meta stand-ins carry
    the roofline's formulas, ``kernels/common.py``);
  * collectives, each as its wire bytes by the ring model
    (``roofline.wire_bytes``) from its result's bytes and its group's
    size;
  * bytes: the arguments' local shards, the peak of the live local
    tensors the step allocates on top of them (temporaries), and the
    bytes each op reads and writes (its tensor inputs and outputs, views
    excepted) — the traffic of the eager, unfused program, an upper
    bound on what a fused one moves.

Each cell gives one record: per-device argument, temporary and peak
bytes, counted flops, wire bytes by op, the three roofline terms on the
H100's numbers (``roofline.HW``), the bottleneck, ``model_flops`` and
``useful_ratio`` (model flops over counted per-device flops times the
devices).  These are estimates for a production H100 cluster, not
measurements.  JAX's unrolled layer-count variants have no counterpart:
they exist because XLA's cost analysis counts a scan body once, while
the superblock loop here is Python and every layer is counted.

Usage (the fake group needs a process of its own):
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out dry.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import weakref
from collections import defaultdict
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, get_arch, runnable_shapes
from ..models.transformer import Model
from ..sharding.policy import (distribute, mesh_shape, param_policy,
                               use_mesh)
from ..training.optimizer import AdamWConfig, OptState, init_opt_state
from ..training.step import (make_decode_step, make_prefill_step,
                             make_train_step)
from .mesh import make_production_mesh
from .roofline import dominant, model_flops, terms_from, wire_bytes
from .specs import (abstract_opt_state, make_batch, make_serving_inputs,
                    opt_specs, param_specs, shapes_and_axes)

__all__ = ["build_cell", "lower_compile", "CellCounter", "run_cell",
           "main"]


def _dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in shape if a in ("pod", "data")]))


def _place_tree(tree, spec_tree, mesh):
    """A nested list/dict/tuple of tensors placed by the matching specs."""
    from torch.distributed.tensor import distribute_tensor

    from ..sharding.policy import placements

    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements(spec_tree, mesh))
    if isinstance(tree, dict):
        return {k: _place_tree(v, spec_tree[k], mesh) for k, v in tree.items()}
    return type(tree)(_place_tree(v, s, mesh)
                      for v, s in zip(tree, spec_tree))


def build_cell(cfg, shape, mesh, *, remat: str = "dots",
               microbatch_seqs: int = 4, seq_shard: bool = False,
               model: Optional[Model] = None, batch=None,
               policy: Optional[str] = None,
               compute_policy: Optional[str] = None):
    """(step fn, placed args, in specs, out specs) of one cell.

    Without ``model`` everything is abstract: a ``Model`` on ``meta``,
    its parameters, the optimizer state and the inputs as meta DTensors
    on ``mesh``.  With ``model`` (real weights on the mesh's device
    type) and, for train and prefill cells, ``batch`` (a dict of the
    global tensors, the same on every rank) the cell runs for real.
    ``fn(*args)`` runs the step under the mesh (``use_mesh``), plain
    tensors made inside the model reading as replicated.  Train cells
    accumulate gradients over microbatches of ~``microbatch_seqs``
    sequences a device, as JAX's do.  ``policy`` overrides the
    parameters' policy (``param_policy(cfg)`` by default);
    ``compute_policy`` (e.g. "tp") reshards them to that policy once a
    step (``make_train_step``'s ``param_axes``)."""
    if model is None:
        model = Model(cfg, device="meta", remat=remat, seq_shard=seq_shard)
    shapes, axes = shapes_and_axes(model)
    pspec = param_specs(cfg, shapes, axes, mesh, policy)
    params = distribute(shapes, pspec, mesh)
    abstract = model.device.type == "meta"

    def run_under_mesh(fn):
        from torch.distributed.tensor.experimental import implicit_replication

        def run(*args):
            with use_mesh(mesh), implicit_replication():
                return fn(*args)
        return run

    if shape.kind == "train":
        master = cfg.param_dtype == "bfloat16"
        ospec = opt_specs(cfg, shapes, axes, mesh, master_weights=master)
        if abstract:
            batch, bspec = make_batch(cfg, shape, mesh)
            opt0 = abstract_opt_state(shapes, master)
        else:
            _, bspec = make_batch(cfg, shape, mesh)
            opt0 = init_opt_state(shapes, master)
        opt = OptState(m=distribute(opt0.m, ospec.m, mesh),
                       v=distribute(opt0.v, ospec.v, mesh),
                       step=opt0.step,
                       master=(distribute(opt0.master, ospec.master, mesh)
                               if master else None))
        per_dev = max(1, shape.global_batch // _dp_size(mesh))
        mb = max(1, per_dev // microbatch_seqs)
        step = make_train_step(
            model, AdamWConfig(master_weights=master), microbatches=mb,
            param_axes=axes if compute_policy else None,
            compute_policy=compute_policy)
        args = (params, opt, _place_tree(batch, bspec, mesh))
        return (run_under_mesh(step), args, (pspec, ospec, bspec),
                (pspec, ospec, None))

    if shape.kind == "prefill":
        if abstract:
            batch, bspec = make_batch(cfg, shape, mesh, with_labels=False)
        else:
            _, bspec = make_batch(cfg, shape, mesh, with_labels=False)
        prefill = make_prefill_step(model)
        return (run_under_mesh(prefill),
                (params, _place_tree(batch, bspec, mesh)), (pspec, bspec),
                None)

    (token, caches, _), (tspec, cspec, _) = make_serving_inputs(
        cfg, shape, mesh)
    decode = make_decode_step(model)
    # the step's position: the last slot of the s-long context
    cur = shape.seq_len - 1
    args = (params, _place_tree(token, tspec, mesh),
            _place_tree(caches, cspec, mesh), cur)
    return (run_under_mesh(decode), args, (pspec, tspec, cspec, None),
            (None, cspec))


# ------------------------------------------------------------------ #
# the per-device counter
# ------------------------------------------------------------------ #
def _c10d_ops():
    ops = torch.ops._c10d_functional
    return {ops.all_reduce.default: "all-reduce",
            ops.all_gather_into_tensor.default: "all-gather",
            ops.reduce_scatter_tensor.default: "reduce-scatter",
            ops.all_to_all_single.default: "all-to-all"}


class CellCounter(TorchDispatchMode):
    """What one device runs in a DTensor program: flops, collectives'
    wire bytes and live bytes (see the module's docstring)."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.wire: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.arg_bytes = 0
        self.live = 0
        self.peak = 0
        self._held: "weakref.WeakSet" = weakref.WeakSet()
        self._c10d = _c10d_ops()
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                st = _local(t).untyped_storage()
                if st not in self._held:
                    self._held.add(st)
                    self.arg_bytes += st.nbytes()

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._held:
                continue
            self._held.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # let DTensor desugar into local ops
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor)
               for a in tree_leaves((args, kwargs, out))):
            return out                # DTensor's sharding propagation
        packet = func._overloadpacket
        if not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        op = self._c10d.get(func)
        if op is not None:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            group = _resolve_process_group(args[-1]).size()
            self.wire[op] += wire_bytes(op, out.numel() * out.element_size(),
                                        group)
            self.calls[op] += 1
        self._track(out)
        return out


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def lower_compile(cfg, shape, mesh, *, remat: str = "dots",
                  seq_shard: bool = False, microbatch_seqs: int = 4,
                  compute_policy: Optional[str] = None):
    """Build the cell and run its step once under :class:`CellCounter`;
    returns the counter (JAX lowers and compiles here; the port
    traces on ``meta``)."""
    fn, args, _, _ = build_cell(cfg, shape, mesh, remat=remat,
                                seq_shard=seq_shard,
                                microbatch_seqs=microbatch_seqs,
                                compute_policy=compute_policy)
    counter = CellCounter(args)
    with counter:
        fn(*args)
    return counter


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             remat: str = "dots", bf16_params: bool = False,
             seq_shard: bool = False, verbose: bool = True,
             cfg=None, shape=None, mesh=None):
    """One cell's record (see the module's docstring).  ``cfg``,
    ``shape`` and ``mesh`` override the registry's and the production
    mesh (a reduced cell)."""
    cfg = cfg or get_arch(arch)
    if bf16_params:
        cfg = replace(cfg, param_dtype="bfloat16")
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = int(np.prod(mesh.shape))
    t0 = time.time()
    c = lower_compile(cfg, shape, mesh, remat=remat, seq_shard=seq_shard)
    wire = float(sum(c.wire.values()))
    terms = terms_from(c.flops * chips, c.bytes * chips, wire, chips)
    mf = model_flops(cfg, shape)
    rec = dict(
        arch=arch, shape=shape.name,
        mesh="x".join(str(s) for s in mesh.shape),
        policy=param_policy(cfg),
        trace_s=round(time.time() - t0, 1),
        argument_gb=c.arg_bytes / 1e9,
        temp_gb=c.peak / 1e9,
        peak_gb=(c.arg_bytes + c.peak) / 1e9,
        flops_per_device=c.flops,
        bytes_per_device=c.bytes,
        wire_bytes_per_device=wire,
        wire_by_op=dict(c.wire),
        collectives=dict(c.calls),
        terms=terms, bottleneck=dominant(terms),
        model_flops=mf,
        useful_ratio=mf / (c.flops * chips) if c.flops else float("nan"),
    )
    if verbose:
        t = rec["terms"]
        print(f"[{arch} x {shape.name} x {rec['mesh']}] traced in "
              f"{rec['trace_s']}s  args={rec['argument_gb']:.2f}GB "
              f"temp={rec['temp_gb']:.2f}GB peak={rec['peak_gb']:.2f}GB",
              flush=True)
        print(f"  flops/device={c.flops:.4g}  wire/device={wire:.4g}B "
              f"{dict(c.calls)}", flush=True)
        print(f"  roofline: compute={t['compute']*1e3:.2f}ms "
              f"memory={t['memory']*1e3:.2f}ms "
              f"collective={t['collective']*1e3:.2f}ms "
              f"-> {rec['bottleneck']} | useful={rec['useful_ratio']:.3f}",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in sorted(ARCHS):
            for shape in runnable_shapes(ARCHS[arch]):
                cells.append((arch, shape.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results, failures = [], []
    for mp in meshes:
        for arch, shape in cells:
            try:
                results.append(run_cell(arch, shape, mp, remat=args.remat,
                                        bf16_params=args.bf16_params,
                                        seq_shard=args.seq_shard))
            except Exception as e:  # noqa: BLE001 — report every failure
                failures.append((arch, shape, mp, repr(e)))
                print(f"FAILED [{arch} x {shape} x multi_pod={mp}]: {e!r}",
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records -> {args.out}")
    if failures:
        print(f"{len(failures)} FAILURES")
        sys.exit(1)
    print(f"dry-run OK: {len(results)} cells traced")


if __name__ == "__main__":
    main()
