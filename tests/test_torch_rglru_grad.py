"""The backward of the port's RG-LRU scan on the CPU: the reversed
recurrence (``rglru_scan_backward``, the formula the card runs as a
second launch of the scan kernel) against autograd through the port's
plain ``rglru_scan_ref`` and against ``jax.grad`` of the JAX package's
``rglru_scan_ref``, on the same seeded numpy inputs.  S of 1, 2, 16
(one kernel chunk), 17 (one past it) and 64; W of 3 to 130; B of 1 to
3; h0 and a cotangent on h[:, -1] each on and off; tolerances (absolute
plus relative) as ``tests/test_kernels.py``'s: float32 2e-5, bfloat16
2e-2 (the gradients come back in the inputs' type)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import rglru_scan_ref as jax_rglru_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, w, h0, dh_last, dtype):
    rng = np.random.default_rng(1000 * s + 10 * w + b)
    dt = TORCH_DT[dtype]
    a = torch.from_numpy(1 / (1 + np.exp(-rng.standard_normal(
        (b, s, w))))).float().to(dt)
    bx = torch.from_numpy(rng.standard_normal((b, s, w)) * 0.2).float().to(dt)
    h0v = (torch.from_numpy(rng.standard_normal((b, w)) * 0.1).float()
           if h0 else None)
    dh = torch.from_numpy(rng.standard_normal((b, s, w)) * 0.5).float()
    dhl = (torch.from_numpy(rng.standard_normal((b, w))).float()
           if dh_last else None)
    return a, bx, h0v, dh, dhl


def _torch_grads(scan, a, bx, h0, dh, dhl):
    leaves = [a.clone().requires_grad_(), bx.clone().requires_grad_()]
    if h0 is not None:
        leaves.append(h0.clone().requires_grad_())
    h, hl = scan(*leaves[:2], leaves[2] if h0 is not None else None)
    loss = (h * dh).sum()
    if dhl is not None:
        loss = loss + (hl * dhl).sum()
    return torch.autograd.grad(loss, leaves)


def _jax_grads(a, bx, h0, dh, dhl):
    f32 = [jnp.asarray(t.float().numpy()) for t in (a, bx)]
    jdh = jnp.asarray(dh.numpy())
    jdhl = None if dhl is None else jnp.asarray(dhl.numpy())
    args = f32 + ([jnp.asarray(h0.numpy())] if h0 is not None else [])
    return _jax_grad_fn(len(args), jdhl is not None)(jdh, jdhl, *args)


_JAX_GRAD_FNS = {}


def _jax_grad_fn(n_args, with_dhl):
    """jit(grad) of the JAX reference's loss, one per argument layout."""
    key = (n_args, with_dhl)
    if key not in _JAX_GRAD_FNS:
        def loss(a, bx, *h0, dh, dhl):
            h, hl = jax_rglru_ref(a, bx, h0[0] if h0 else None)
            out = (h * dh).sum()
            return out + (hl * dhl).sum() if with_dhl else out
        grad = jax.grad(loss, argnums=tuple(range(n_args)))
        _JAX_GRAD_FNS[key] = jax.jit(
            lambda dh, dhl, *args: grad(*args, dh=dh, dhl=dhl))
    return _JAX_GRAD_FNS[key]


def _close(got, want, tol, what):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want.float().numpy() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh_last", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("b,s,w", [(1, 1, 3), (2, 2, 5), (1, 16, 130),
                                   (3, 17, 64), (2, 64, 33)])
def test_reversed_scan_matches_autograd_and_jax(b, s, w, h0, dh_last, dtype):
    a, bx, h0v, dh, dhl = _inputs(b, s, w, h0, dh_last, dtype)
    before = dict(LAUNCHES)
    got = _torch_grads(rglru_scan, a, bx, h0v, dh, dhl)
    assert LAUNCHES == before          # the CPU path launches nothing
    assert [g.dtype for g in got[:2]] == [a.dtype, a.dtype]
    if h0:
        assert got[2].dtype == torch.float32
    plain = _torch_grads(rglru_scan_ref, a, bx, h0v, dh, dhl)
    ref = _jax_grads(a, bx, h0v, dh, dhl)
    tol = TOL[dtype]
    for name, g, p, j in zip(("da", "dbx", "dh0"), got, plain, ref):
        _close(g, p, tol, f"{name} vs autograd through rglru_scan_ref")
        _close(g, j, tol, f"{name} vs jax.grad of rglru_scan_ref")


def test_gradient_reaches_the_gates_through_the_model_block():
    """The RG-LRU block's scan is on the autograd graph: the gate
    parameters get the gradient that a step-by-step plain recurrence
    gives them."""
    from dataclasses import replace

    import repro_torch.models.rglru as rglru_mod
    from repro_torch.configs import get_arch
    from repro_torch.models.rglru import RGLRU, rglru_forward

    cfg = replace(get_arch("recurrentgemma-9b").smoke(),
                  compute_dtype="float32", param_dtype="float32")
    p = RGLRU(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32))
    names = ("lam", "w_r", "b_r", "w_i", "b_i", "w_in", "conv_w")

    def grads():
        y, (_, h_last) = rglru_forward(p, cfg, x)
        loss = (y * y).mean() + h_last.square().mean()
        return torch.autograd.grad(loss, [getattr(p, n) for n in names])
    got = grads()
    orig = rglru_mod.rglru_scan
    rglru_mod.rglru_scan = rglru_scan_ref
    try:
        want = grads()
    finally:
        rglru_mod.rglru_scan = orig
    for name, g, w in zip(names, got, want):
        assert float(g.abs().max()) > 0, name
        _close(g, w, 2e-5, name)
