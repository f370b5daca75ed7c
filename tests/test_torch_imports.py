"""Import guard of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro`` — checked
statically over every module (the telemetry package ``repro_torch.obs``
and the live serving package ``core/vecsim/live`` included), and by
importing the port and running a small windowed CPU run and a small
live CPU run with telemetry in a child interpreter where both are
blocked."""

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
                    "api"):
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
