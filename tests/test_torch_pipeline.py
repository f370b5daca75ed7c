"""The port's GPipe pipeline (``sharding/pipeline.py``) on 4 gloo ranks,
one stage a rank, against the JAX package's ``pipeline`` (run once on a
forced 4-device mesh in a subprocess) and the port's sequential stack,
on JAX's test case (S=4 stages of tanh(x @ w + b), M=6 microbatches,
B=8, D=16) with the same numpy inputs: outputs within rtol 1e-5 and the
gradients of mean(out ** 2) within rtol 1e-4, as JAX's test holds its
own (``tests/test_pipeline.py``).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_dist_ranks import run_on_ranks

S, M, B, D = 4, 6, 8, 16

JAX_SNIPPET = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.sharding.pipeline import pipeline

    inp = np.load(sys.argv[1])
    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    mb = jnp.asarray(inp["mb"])
    mesh = jax.make_mesh((4,), ("stage",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    piped = pipeline(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), mesh,
                     "stage")
    with mesh:
        out = jax.jit(piped)(params, mb)

    def loss(params):
        with mesh:
            return (jax.jit(piped)(params, mb) ** 2).mean()

    g = jax.grad(loss)(params)
    np.savez(sys.argv[2], out=np.asarray(out), gw=np.asarray(g["w"]),
             gb=np.asarray(g["b"]))
""")


def _inputs():
    rng = np.random.default_rng(0)
    return dict(w=(rng.standard_normal((S, D, D)) * D ** -0.5).astype(
                    np.float32),
                b=(rng.standard_normal((S, D)) * 0.1).astype(np.float32),
                mb=rng.standard_normal((M, B, D)).astype(np.float32))


def _sequential(inp):
    p = {k: torch.from_numpy(inp[k]).requires_grad_() for k in ("w", "b")}
    x = torch.from_numpy(inp["mb"])
    for s in range(S):
        x = torch.tanh(x @ p["w"][s] + p["b"][s])
    (x ** 2).mean().backward()
    return x.detach().numpy(), {k: v.grad.numpy() for k, v in p.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SNIPPET, str(tmp / "in.npz"),
         str(tmp / "jax.npz")], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port = run_on_ranks(S, tmp, "pipeline_case",
                        ({"w": inp["w"], "b": inp["b"]}, inp["mb"]),
                        timeout=120.0)
    _, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-3000:]
    ref = np.load(tmp / "jax.npz")
    jax_out = (ref["out"], {"w": ref["gw"], "b": ref["gb"]})
    return port, jax_out, _sequential(inp)


@pytest.mark.parametrize("against", ["jax", "sequential"])
def test_pipeline_outputs_and_gradients(runs, against):
    (out, grads), jax_out, seq = runs
    want_out, want_g = jax_out if against == "jax" else seq
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(grads[k], want_g[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
