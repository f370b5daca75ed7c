"""The SSD scan's plain backward, ``ssd_chunk_scan_bwd_ref``: the
formulas the backward kernel (``csrc/ssd_scan_bwd.cu``) computes, held
against ``jax.vjp`` of the JAX package's ``ssd_chunk_scan_ref`` at f32
(within 2e-5 of each gradient's largest entry) and against torch
autograd through the port's ``ssd_chunk_scan_ref`` at f64 (within
1e-10), on a padded chunk, S a chunk multiple and q = S < chunk, with dh
non-zero; and with only xbar and a_log wanted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunk_scan_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_scan_bwd_ref,
                                              ssd_chunk_scan_ref)

NAMES = ("xbar", "a_log", "Bm", "Cm")
# (b, s, h, p, n, chunk)
CASES = [(2, 37, 3, 8, 16, 16),     # a padded last chunk
         (1, 64, 2, 4, 8, 16),      # S a multiple of the chunk
         (2, 5, 2, 4, 8, 16)]       # q = S < chunk


def _inputs(case, seed):
    b, s, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    return ({"xbar": rng.standard_normal((b, s, h, p)),
             "a_log": -rng.random((b, s, h)) * 0.5,
             "Bm": rng.standard_normal((b, s, n)) * 0.3,
             "Cm": rng.standard_normal((b, s, n)) * 0.3},
            rng.standard_normal((b, s, h, p)),
            rng.standard_normal((b, h, n, p)))


def _within_leaf_max(got, want, tol, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_equals_jax_vjp_at_f32(case):
    inp, dy, dh = _inputs(case, 0)
    chunk = case[-1]
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in inp.items()}
    got = ssd_chunk_scan_bwd_ref(*t.values(),
                                 torch.tensor(dy, dtype=torch.float32),
                                 torch.tensor(dh, dtype=torch.float32),
                                 chunk=chunk)

    @jax.jit
    def vjp(args, cot):
        return jax.vjp(lambda *a: jax_ssd_ref(*a, chunk=chunk),
                       *args)[1](cot)

    want = vjp(tuple(jnp.asarray(inp[k], jnp.float32) for k in NAMES),
               (jnp.asarray(dy, jnp.float32), jnp.asarray(dh, jnp.float32)))
    for k, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, k
        _within_leaf_max(g.numpy(), np.asarray(w), 2e-5, k)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_equals_autograd_at_f64(case):
    inp, dy, dh = _inputs(case, 1)
    chunk = case[-1]
    t = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in inp.items()}
    gy, gh = torch.tensor(dy), torch.tensor(dh)
    want = torch.autograd.grad(
        ssd_chunk_scan_ref(*t.values(), chunk=chunk), list(t.values()),
        (gy, gh))
    got = ssd_chunk_scan_bwd_ref(*(v.detach() for v in t.values()), gy, gh,
                                 chunk=chunk)
    for k, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, k
        _within_leaf_max(g.numpy(), w.numpy(), 1e-10, k)


def test_plain_backward_with_only_xbar_and_a_log_wanted():
    case = CASES[0]
    inp, dy, dh = _inputs(case, 2)
    chunk = case[-1]
    t = {k: torch.tensor(v, dtype=torch.float64,
                         requires_grad=k in ("xbar", "a_log"))
         for k, v in inp.items()}
    gy, gh = torch.tensor(dy), torch.tensor(dh)
    want = torch.autograd.grad(
        ssd_chunk_scan_ref(*t.values(), chunk=chunk),
        [t["xbar"], t["a_log"]], (gy, gh))
    got = ssd_chunk_scan_bwd_ref(*(v.detach() for v in t.values()), gy, gh,
                                 chunk=chunk)
    for k, g, w in zip(("xbar", "a_log"), got[:2], want):
        _within_leaf_max(g.numpy(), w.numpy(), 1e-10, k)
