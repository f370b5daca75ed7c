"""Import guard of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro`` — checked
statically over every module (the telemetry package ``repro_torch.obs``
with its graph metrics ``obs/graphs.py``, the exact event engine
``core/{base,types,events,rbroadcast,pcbroadcast,bounded,vector_clock,
overlay}.py``, the vector-clock engine ``core/vecsim/vc.py``, the
cross-validation ``core/vecsim/crossval.py``, the live serving package
``core/vecsim/live``, the sharded engine ``core/vecsim/shard`` and the
LM substrate's ``configs``, ``models``, ``kernels``, ``serving`` and
``launch``, its training path's ``training``, ``data``,
``checkpoint`` and ``runtime``, the distribution layer's ``sharding``
and the tensorized round engine ``core/engine`` included), and by
importing the port and
running a small windowed CPU run, a small live CPU run with telemetry, a
small sharded CPU run, a small CPU run cross-validated against the exact
engine, a small vector-clock run, a smoke-size LM serving run, two
launcher train steps with a checkpoint, a causal-gossip round, the
round engine on one device and on one rank of its sharded runner, the
policy's specs and a dry-run cell traced on a fake 2 x 2 group in a
child interpreter where both are blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    port = REPO / "src" / "repro_torch"
    files = sorted(port.rglob("*.py"))
    assert len(files) >= 30
    for package in ("obs", "core/vecsim/live", "core/vecsim/kernels",
                    "core/vecsim/shard", "api", "configs", "models",
                    "kernels", "kernels/rglru_scan", "kernels/ssd_scan",
                    "kernels/flash_attention", "serving", "launch",
                    "training", "data", "checkpoint", "runtime",
                    "sharding", "core/engine"):
        assert any(f.parent == port / package for f in files), package
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_module_of_the_port_imports_jax_or_repro():
    bad = [f"{path.relative_to(REPO)}:{line} imports {root}"
           for path in _port_files()
           for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, bad


_CHILD = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None        # any import of them now raises
import repro_torch
import repro_torch.api
import repro_torch.api.__main__
import repro_torch.obs
import repro_torch.core.vecsim.live
import repro_torch.core.vecsim.shard
from repro_torch.core.vecsim import execute_windowed, sustained_scenario
scn = sustained_scenario(1, 48, k=5, rate=2.0, messages=20, max_delay=2)
res = execute_windowed(scn, 16, device="cpu", seg_len=4, collect="full")
assert res.delivered_frac() == 1.0, res.delivered_frac()
from repro_torch.api import LiveSpec, ObsSpec, RunSpec, WindowSpec, run
rep = run(RunSpec(mode="live", device="cpu", n=48,
                  live=LiveSpec(rate=2.0, messages=30),
                  window=WindowSpec(window=16, seg_len=4),
                  obs=ObsSpec(provenance=1, audit="fail", spans=True)))
assert rep.live.delivered_frac == 1.0 and rep.extras["latency_hist_total"]
from repro_torch.core.vecsim.shard import execute_sharded
for scan in ("on", "off"):
    sh = execute_sharded(scn, 16, device="cpu", seg_len=4, collect="full",
                         scan=scan)
    assert (sh.delivered == res.delivered).all() and sh.stats == res.stats
from repro_torch.api import DynamicsSpec, MetricsSpec
rep = run(RunSpec(device="cpu", n=48, dynamics=DynamicsSpec(kind="churn"),
                  metrics=MetricsSpec(crossval=True, oracle=True)))
assert rep.crossval_ok is True and rep.oracle.ok
rep = run(RunSpec(device="cpu", n=48, protocol="vc",
                  metrics=MetricsSpec(crossval=True)))
assert rep.engine == "vec" and rep.crossval_ok is True
assert rep.extras["comparisons_per_delivery"] >= 1.0
import repro_torch.core
import repro_torch.core.vecsim.crossval
import repro_torch.core.vecsim.vc
import numpy as np
import repro_torch.launch.serve
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeConfig, ServingEngine
for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
    eng = ServingEngine(build_model(get_arch(arch).smoke(), device="cpu"),
                        ServeConfig(batch=2, max_len=32))
    for i in range(3):
        eng.submit(Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                           max_new_tokens=4))
    assert len(eng.run()) == 3
import tempfile
from dataclasses import replace
import repro_torch.launch.train as train_launcher
with tempfile.TemporaryDirectory() as d:
    loss = train_launcher.main(["--device", "cpu", "--steps", "2",
                                "--seq-len", "8", "--batch", "2",
                                "--ckpt-dir", d])
    assert np.isfinite(loss)
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.gossip import CausalGossipTrainer, GossipConfig
cfg = replace(get_arch("recurrentgemma-9b").smoke(), compute_dtype="float32",
              param_dtype="float32")
tr = CausalGossipTrainer(lambda: build_model(cfg, device="cpu"), 3,
                         GossipConfig(local_steps=1, compress_frac=0.1),
                         DataConfig(cfg.vocab_size, 8, 2))
tr.run_rounds(1)
rep = tr.causal_report()
assert rep.causal_ok and rep.n_broadcasts == 3, rep.summary()
assert all(len(p.applied) == 2 for p in tr.pods.values())
import repro_torch.sharding.pipeline
from repro_torch.core.engine import random_instance, run_engine, run_ref
from repro_torch.core.engine.sharded import run_engine_sharded
inst = random_instance(1, n=12, k=3, m_app=4, n_adds=2, n_rms=1, rounds=24)
d = run_engine(*inst, device="cpu")
assert (d == run_ref(inst[0], inst[1], inst[2].copy(), inst[3].copy())).all()
assert (run_engine_sharded(*inst, device="cpu") == d).all()
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import specs
from repro_torch.launch.roofline import model_flops
shapes, axes = specs.shapes_and_axes(get_arch("qwen3-moe-235b-a22b"))
sp = specs.param_specs(get_arch("qwen3-moe-235b-a22b"), shapes, axes,
                       {"data": 16, "model": 16})
assert sp["stacks.0.0.b0.moe.w_gate"] == ("model", "data", None), sp
assert model_flops(get_arch("qwen3-8b"), ShapeSpec("t", 64, 8, "train")) > 0
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import init_fake_group
init_fake_group(4)
rec = run_cell("yi-6b", "t", False, cfg=replace(get_arch("yi-6b").smoke(),
               num_layers=1), shape=ShapeSpec("t", 32, 4, "train"),
               mesh=init_device_mesh("cpu", (2, 2),
                                     mesh_dim_names=("data", "model")),
               verbose=False)
assert rec["flops_per_device"] > 0
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("PORT_OK")
"""


def test_port_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0 and "PORT_OK" in out.stdout, \
        out.stdout + out.stderr
