"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At the first CUDA
use they are compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc`` per
source, all started together — and linked into one shared library,
which is loaded with :mod:`ctypes`.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, keyed
by a hash of the sources and flags, so a checkout builds it once and an
edited source builds anew.  Importing this module needs no compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_library", "find_nvcc", "CSRC",
           "BUILD_ROOT", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <checkout>/src/repro_torch/core/vecsim/kernels/_build.py -> <checkout>
BUILD_ROOT = Path(__file__).resolve().parents[5] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types; every entry point returns the
# cudaError_t of cudaGetLastError() after its launch.
_SIGNATURES = {
    "rt_fused_sweep": [_P] * 9 + [_I] * 4 + [_P],
    "rt_deliver_sweep": [_P] * 6 + [_I] * 3 + [_P],
    "rt_frontier_sweep": [_P] * 9 + [_I] * 4 + [_P],
    "rt_retire_reduce": [_P] * 9 + [_I] * 5 + [_P],
    "rt_latency_hist": [_P] * 4 + [_I] * 4 + [_P],
}


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's usual home."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, headers = _sources()
    for path in cus + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(nvcc: Optional[str] = None,
                  build_root: Path = BUILD_ROOT) -> Path:
    """Compile ``csrc/*.cu`` into the shared library (if this source hash
    has not been built yet) and return its path.  Raises
    :class:`RuntimeError` when ``nvcc`` is missing or a compile fails,
    with the compiler's output."""
    out_dir = Path(build_root) / _digest()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = nvcc or find_nvcc()
    if nvcc is None or not os.path.isfile(nvcc):
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found (set CUDA_HOME "
            "or put nvcc on PATH); pass device='cpu' to run without them")
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cus, _ = _sources()
        procs = []
        for src in cus:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log.append(f"== build seconds {time.perf_counter() - t0:.3f}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)   # atomic: a reader never sees half a file
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every
    entry point's argument and return types declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
