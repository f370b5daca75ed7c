"""The port's serving engine and launcher on the CPU: greedy tokens
identical to the JAX package's ``ServingEngine`` on the same weights
(loaded by ``convert.py``) for the dense, SSM and hybrid families, the
tick bound of continuous batching (``tests/test_substrate.py``),
seeded temperature sampling, and ``python -m repro_torch.launch.serve
--device cpu``."""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import Request, ServeConfig, ServingEngine

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ["yi-6b", "mamba2-2.7b", "recurrentgemma-9b"]
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _serve(eng, make_request, prompts, new=8):
    reqs = [make_request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_matches_jax_engine(name):
    """3 slots, 6 requests of 3-11 tokens, 8 greedy tokens each: the
    same tokens as the JAX engine, every request done."""
    jcfg = replace(JAX_ARCHS[name].smoke(), **F32)
    jm = jax_build_model(jcfg, remat="none")
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = from_jax_params(replace(get_arch(name).smoke(), **F32),
                         jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7, 3, 11, 6)]
    want = _serve(JaxServingEngine(jm, params,
                                   JaxServeConfig(batch=3, max_len=64)),
                  JaxRequest, prompts)
    eng = ServingEngine(tm, ServeConfig(batch=3, max_len=64))
    got = _serve(eng, Request, prompts)
    for g, w in zip(got, want):
        assert g.done and len(g.out_tokens) == 8
        assert g.out_tokens == w.out_tokens, (g.rid, g.out_tokens,
                                              w.out_tokens)
    assert sorted(r.rid for r in eng.finished) == list(range(6))


def test_batches_share_decode_ticks():
    """3 slots x 6 requests of 8 tokens take far fewer ticks than
    serial decoding (continuous batching batches)."""
    model = build_model(replace(get_arch("yi-6b").smoke(), **F32),
                        device="cpu")
    rng = np.random.default_rng(1)
    eng = ServingEngine(model, ServeConfig(batch=3, max_len=64))
    done = _serve(eng, Request, [
        rng.integers(0, 256, size=6).astype(np.int32) for _ in range(6)])
    assert eng.ticks <= 6 * 7 / 2, eng.ticks  # well under serial 42
    assert all(r.done for r in done)


def test_retirement_rules_and_seeded_sampling():
    """A request retires at EOS and at the cache's end; temperature
    sampling is a function of ServeConfig.seed."""
    model = build_model(replace(get_arch("recurrentgemma-9b").smoke(),
                                **F32), device="cpu", seed=3)
    prompt = np.arange(5, dtype=np.int32)
    eng = ServingEngine(model, ServeConfig(batch=2, max_len=64))
    (greedy,) = _serve(eng, Request, [prompt], new=6)
    eos = greedy.out_tokens[2]
    eng = ServingEngine(model, ServeConfig(batch=2, max_len=64, eos_id=eos))
    (stopped,) = _serve(eng, Request, [prompt], new=6)
    assert stopped.out_tokens == greedy.out_tokens[:greedy.out_tokens.index(
        eos) + 1]
    eng = ServingEngine(model, ServeConfig(batch=2, max_len=9))
    (short,) = _serve(eng, Request, [prompt], new=20)
    assert short.done and len(short.out_tokens) == 9 - 1 - 5 + 1

    def sampled(seed):
        eng = ServingEngine(model, ServeConfig(batch=2, max_len=64,
                                               seed=seed))
        reqs = [Request(rid=i, prompt=prompt, max_new_tokens=8,
                        temperature=1.0) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.out_tokens for r in reqs]

    assert sampled(7) == sampled(7)
    assert sampled(7) != sampled(8)


def test_launcher_on_the_cpu(capsys):
    reqs, eng = serve.main(["--device", "cpu", "--arch", "mamba2-2.7b",
                            "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 + 2 and out[-1] == "device cpu"
    assert "tokens in" in out[-2] and "engine ticks" in out[-2]
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "recurrentgemma-9b", "--requests", "2", "--max-new", "3"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "device cpu"
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve"],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        assert proc.returncode != 0 and "device='cpu'" in proc.stderr
