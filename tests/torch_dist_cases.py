"""Shared pieces of the DTensor cell tests (``test_torch_dist_*.py``):
the JAX package's weights and a batch for a smoke config cut to one
superblock, the port's one-device grad function and train step on them,
and the comparison of a cell's run on the ranks with that step."""

from dataclasses import replace

import jax
import numpy as np

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import moe
from repro_torch.models.convert import from_jax_params
from repro_torch.training import optimizer as topt
from repro_torch.training.step import make_grad_fn, make_train_step

F32 = dict(compute_dtype="float32", param_dtype="float32")
# the smoke configs cut to one superblock (two layers for the
# single-kind stacks): the DTensor dispatch is paid per op on the CPU
LAYERS = {"yi-6b": 2, "recurrentgemma-9b": 3, "qwen3-moe-235b-a22b": 2,
          "mamba2-2.7b": 2}


def inputs(name, kv_heads=0):
    """(the port's config, JAX's initial weights as numpy, a 4 x 32
    SyntheticLM batch) at float32; ``kv_heads`` overrides the smoke
    config's KV heads."""
    cut = dict(F32, num_layers=LAYERS[name])
    if kv_heads:
        cut["num_kv_heads"] = kv_heads
    jm = jax_build_model(replace(JAX_ARCHS[name].smoke(), **cut),
                         remat="none")
    params = jax.jit(lambda key: jm.init(key)[0])(jax.random.PRNGKey(0))
    cfg = replace(ARCHS[name].smoke(), **cut)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=5)).batch(0)
    return cfg, jax.tree.map(np.asarray, params), batch


def one_device(cfg, params, batch):
    """The port's one-device grad function and train step, with the MoE
    routing integers of each call."""
    seen = []
    orig = moe.route

    def keep(p, cfg_, x, train):
        r = orig(p, cfg_, x, train)
        seen.append({k: getattr(r, k).numpy()
                     for k in ("idx", "order", "rank", "keep")})
        return r
    model = from_jax_params(cfg, params, device="cpu")
    tp = {k: v.detach().clone().requires_grad_()
          for k, v in model.named_parameters()}
    moe.route = keep
    try:
        (loss, _), grads = make_grad_fn(model)(tp, batch)
        tp, _, met = make_train_step(model, topt.AdamWConfig())(
            tp, topt.init_opt_state(tp), batch)
    finally:
        moe.route = orig
    return dict(loss=float(loss), grads={k: g.numpy()
                                         for k, g in grads.items()},
                step_loss=float(met["loss"]),
                params={k: v.detach().numpy() for k, v in tp.items()},
                routing=seen)


def check_cell(got, want):
    """A cell's run on the ranks against the one-device step: the loss
    within 2e-5, every gradient within 1e-4 of its leaf's largest (the
    port's training-parity tolerances), the parameters after one AdamW
    step within 1e-6 where the gradient is firm."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                               rtol=2e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    moved = 0
    for k, w in want["params"].items():
        g = np.abs(want["grads"][k])
        firm = g > 1e-3 * g.max()
        np.testing.assert_allclose(got["params"][k][firm], w[firm], rtol=0,
                                   atol=1e-6, err_msg=k)
        moved += int(firm.sum())
    assert moved > 0.5 * sum(v.size for v in want["params"].values())
