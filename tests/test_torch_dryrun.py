"""The port's dry-run layer (``launch/{roofline,specs,dryrun}.py``)
against the JAX package's:

* ``model_flops`` equal to JAX's for every arch x shape (rel 1e-12);
* ``terms_from``/``dominant`` on the H100's ``HW``;
* ``wire_bytes`` equal to JAX's ``parse_collectives`` on the (op,
  result bytes, group) of ``tests/test_distribution.py``'s HLO snippet;
* ``input_specs``' shapes, dtypes and specs equal to JAX's for every
  runnable cell of a dense, an MoE and an encoder-decoder arch on the
  (16, 16) and (2, 16, 16) meshes (the stacked caches' leading axis
  dropped: the port keeps one a superblock);
* the reduced cell of JAX's ``test_reduced_production_cell_compiles``
  (yi-6b smoke at 2 layers, ``ShapeSpec("tiny_train", 64, 8,
  "train")``, ``remat="full"``) traced on a fake 2 x 4 group in a
  subprocess (the fake group needs a process of its own): flops and
  argument bytes above 0, an all-reduce or reduce-scatter counted, and
  ``useful_ratio`` finite (printed; no bound is set on it: the counter
  sees matrix products only, and remat and unhalved causal attention
  count extra).
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import runnable_shapes as jax_runnable
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs

from test_distribution import HLO_SNIPPET


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_model_flops_equal_jax(arch):
    for name in JAX_SHAPES:
        want = jroof.model_flops(JAX_ARCHS[arch], JAX_SHAPES[name])
        got = troof.model_flops(ARCHS[arch], SHAPES[name])
        assert got == pytest.approx(want, rel=1e-12), name


def test_terms_and_dominance_on_h100():
    hw = troof.HW
    assert (hw["peak_flops"], hw["hbm_bw"], hw["hbm_bytes"]) == \
        (989e12, 3.35e12, 80e9)
    t = troof.terms_from(flops=hw["peak_flops"] * 256,
                         bytes_hbm=hw["hbm_bw"] * 256,
                         wire_per_device=hw["link_bw"] / 2, chips=256)
    assert t["compute"] == pytest.approx(1.0)
    assert t["memory"] == pytest.approx(1.0)
    assert t["collective"] == pytest.approx(0.5)
    assert troof.dominant({"compute": 3, "memory": 2, "collective": 1}) == \
        "compute"
    assert troof.dominant(t) in ("compute", "memory")


def test_wire_bytes_equal_parse_collectives():
    want = jroof.parse_collectives(HLO_SNIPPET)
    # the snippet's collectives: (op, per-device result bytes, group)
    ops = [("all-reduce", 128 * 64 * 4, 4), ("all-gather", 16 * 512 * 2, 2),
           ("reduce-scatter", 32 * 4, 8), ("collective-permute", 8 * 4, 2)]
    total = 0.0
    for op, nbytes, group in ops:
        got = troof.wire_bytes(op, nbytes, group)
        assert got == pytest.approx(want[op]), op
        total += got
    assert total == pytest.approx(want["total"])
    assert troof.wire_bytes("all-to-all", 800, 4) == pytest.approx(600)
    assert troof.wire_bytes("all-reduce", 800, 1) == 0.0
    with pytest.raises(ValueError):
        troof.wire_bytes("broadcast", 8, 2)


def _dtype(x):
    return str(jnp.dtype(x.dtype)) if hasattr(x, "dtype") else None


def _leaves(jtree, ttree, jspec, tspec, stacked=False):
    """Pairs (JAX leaf, its spec, port leaf, its spec) of matching trees;
    a stacked JAX cache leaf pairs with each of the port's superblocks."""
    from jax.sharding import PartitionSpec
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _leaves(jtree[k], ttree[k], jspec[k], tspec[k], stacked)
    elif isinstance(ttree, (tuple, list)) and not isinstance(
            jspec, PartitionSpec):
        for a, b, c, d in zip(jtree, ttree, jspec, tspec):
            yield from _leaves(a, b, c, d, stacked)
    else:
        yield jtree, tuple(jspec), ttree, tspec


CELL_ARCHS = ["qwen3-8b", "qwen3-moe-235b-a22b", "whisper-small"]


@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model")),
                                  ((2, 16, 16), ("pod", "data", "model"))],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_input_specs_equal_jax(arch, mesh):
    sizes, names = mesh
    am, tm = AbstractMesh(sizes, names), dict(zip(names, sizes))
    for shape in jax_runnable(JAX_ARCHS[arch]):
        (jin, jsp) = jspecs.input_specs(JAX_ARCHS[arch], shape, am)
        (tin, tsp) = tspecs.input_specs(ARCHS[arch], SHAPES[shape.name], tm)
        if shape.kind != "decode":
            assert sorted(tin) == sorted(jin)
            for k in jin:
                assert tuple(tin[k].shape) == jin[k].shape, k
                assert str(tin[k].dtype).replace("torch.", "") == \
                    _dtype(jin[k]), k
                assert tin[k].device.type == "meta"
                assert tsp[k] == tuple(jsp[k]), k
            continue
        (jtok, jcaches, jcur), (jts, jcs, jcurs) = jin, jsp
        (ttok, tcaches, tcur), (tts, tcs, tcurs) = tin, tsp
        assert tuple(ttok.shape) == jtok.shape and tts == tuple(jts)
        assert tuple(tcur.shape) == jcur.shape == () and tcurs == ()
        assert len(tcaches) == len(jcaches)
        n = 0
        for s, (jstack, tstack) in enumerate(zip(jcaches, tcaches)):
            for r, block in enumerate(tstack):
                for jl, js, tl, ts in _leaves(jstack, block, jcs[s],
                                              tcs[s][r]):
                    assert tuple(tl.shape) == jl.shape[1:]
                    assert str(tl.dtype).replace("torch.", "") == _dtype(jl)
                    assert js[0] is None and ts == js[1:]
                    n += 1
        assert n > 0


SNIPPET = textwrap.dedent("""
    import json, math
    from dataclasses import replace
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import init_fake_group

    init_fake_group(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg = replace(get_arch("yi-6b").smoke(), num_layers=2)
    shape = ShapeSpec("tiny_train", 64, 8, "train")
    rec = run_cell("yi-6b", "tiny_train", False, remat="full", cfg=cfg,
                   shape=shape, mesh=mesh, verbose=False)
    print("RECORD " + json.dumps(rec))
""")


def test_reduced_cell_traces_on_a_fake_group():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", SNIPPET], cwd=root,
                         env=dict(os.environ, PYTHONPATH="src"),
                         capture_output=True, text=True, timeout=300)
    lines = [l for l in out.stdout.splitlines() if l.startswith("RECORD ")]
    assert lines, out.stdout[-2000:] + out.stderr[-3000:]
    rec = json.loads(lines[0][len("RECORD "):])
    assert rec["mesh"] == "2x4" and rec["policy"] == "tp"
    assert rec["flops_per_device"] > 0
    assert rec["argument_gb"] > 0 and rec["peak_gb"] >= rec["argument_gb"]
    assert rec["collectives"].get("all-reduce", 0) + \
        rec["collectives"].get("reduce-scatter", 0) > 0
    assert rec["wire_bytes_per_device"] > 0
    assert math.isfinite(rec["useful_ratio"]) and rec["useful_ratio"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    print(f"reduced cell: useful_ratio={rec['useful_ratio']:.4f}")
