"""Import guard of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro`` — checked
statically over every module, and by importing the port and running a
small windowed CPU run in a child interpreter where both are blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
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
from repro_torch.core.vecsim import execute_windowed, sustained_scenario
scn = sustained_scenario(1, 48, k=5, rate=2.0, messages=20, max_delay=2)
res = execute_windowed(scn, 16, device="cpu", seg_len=4, collect="full")
assert res.delivered_frac() == 1.0, res.delivered_frac()
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
