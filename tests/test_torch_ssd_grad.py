"""The SSD scan wrapper's card path on the CPU: ``route`` made to pick
the kernel and the bare launches replaced by ones that write the plain
versions (``ssd_chunk_scan_ref``, ``ssd_chunk_scan_bwd_ref``) into the
wrapper's padded buffers.  Under ``no_grad``, or with no input needing a
gradient, the launch runs bare and no autograd function is built; with
inputs that need one, the autograd function runs the same counted
launch, and its backward (one counted ``ssd_scan_bwd`` launch, no call
of ``ssd_chunk_scan_ref``) gives autograd's gradients through
``ssd_chunk_scan_ref`` and ``jax.grad`` of the JAX package's
``ssd_chunk_scan_ref`` within f32 2e-5, the padded chunk included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_chunk_scan_ref as jax_ssd_ref
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_scan_bwd_ref,
                                              ssd_chunk_scan_ref)

NAMES = ("xbar", "a_log", "Bm", "Cm")


@pytest.fixture
def card_path(monkeypatch):
    """The wrapper's card path on CPU tensors; yields the list that each
    ``_SSDScan.apply`` call appends to."""
    def launch(xbar, a_log, Bm, Cm, y, hout, q):
        assert xbar.shape[1] % q == 0
        yy, hh = ssd_chunk_scan_ref(xbar, a_log, Bm, Cm, chunk=q)
        y.copy_(yy)
        hout.copy_(hh)

    def launch_bwd(xbar, a_log, Bm, Cm, dy, dh, *outs, q):
        assert xbar.shape[1] % q == 0 and dy.shape == xbar.shape
        assert dh.dtype == torch.float32
        for out, g in zip(outs, ssd_chunk_scan_bwd_ref(
                xbar, a_log, Bm, Cm, dy, dh, chunk=q)):
            out.copy_(g)

    applied = []
    apply = ops._SSDScan.apply

    def counted(*args):
        applied.append(args)
        return apply(*args)
    monkeypatch.setattr(ops.common, "route", lambda dev: True)
    monkeypatch.setattr(ops, "launch_ssd_scan", launch)
    monkeypatch.setattr(ops, "launch_ssd_scan_bwd",
                        lambda *a: launch_bwd(*a[:-1], q=a[-1]))
    monkeypatch.setattr(ops._SSDScan, "apply", counted)
    reset_launches()
    yield applied
    reset_launches()


def _inputs(seed, b=2, s=37, h=3, p=8, n=16):
    rng = np.random.default_rng(seed)
    return {"xbar": rng.standard_normal((b, s, h, p)),
            "a_log": -rng.random((b, s, h)) * 0.5,
            "Bm": rng.standard_normal((b, s, n)) * 0.3,
            "Cm": rng.standard_normal((b, s, n)) * 0.3}


def _tensors(inp, need=()):
    return {k: torch.tensor(v, dtype=torch.float32, requires_grad=k in need)
            for k, v in inp.items()}


def test_no_gradient_wanted_launches_bare(card_path):
    inp = _inputs(0)
    want = ssd_chunk_scan_ref(*_tensors(inp).values(), chunk=16)
    with torch.no_grad():
        got = ops.ssd_chunk_scan(*_tensors(inp, NAMES).values(), chunk=16)
    assert LAUNCHES["ssd_scan"] == 1 and card_path == []
    got2 = ops.ssd_chunk_scan(*_tensors(inp).values(), chunk=16)
    assert LAUNCHES["ssd_scan"] == 2 and card_path == []
    for a, b in ((got, want), (got2, want)):
        for x, y in zip(a, b):
            assert x.grad_fn is None
            np.testing.assert_allclose(x.numpy(), y.detach().numpy(),
                                       rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("need", [NAMES, ("xbar", "Bm"), ("a_log",)])
def test_backward_equals_autograd_through_the_plain_version(card_path,
                                                            need):
    inp = _inputs(1)
    rng = np.random.default_rng(2)
    gy = torch.tensor(rng.standard_normal((2, 37, 3, 8)), dtype=torch.float32)
    gh = torch.tensor(rng.standard_normal((2, 3, 16, 8)), dtype=torch.float32)

    def grads(fn):
        t = _tensors(inp, need)
        y, h = fn(*t.values(), chunk=16)
        loss = (y * gy).sum() + (h * gh).sum()
        wrt = [t[k] for k in need]
        return loss.detach(), torch.autograd.grad(loss, wrt)

    def jax_loss(*wrt):
        args = dict({k: jnp.asarray(v, jnp.float32) for k, v in inp.items()},
                    **dict(zip(need, wrt)))
        y, h = jax_ssd_ref(*(args[k] for k in NAMES), chunk=16)
        return (y * gy.numpy()).sum() + (h * gh.numpy()).sum()

    want_loss, want = grads(ssd_chunk_scan_ref)
    plain_calls = []

    def counted_ref(*args, **kw):
        plain_calls.append(args)
        return ssd_chunk_scan_ref(*args, **kw)
    # the card path's forward and backward call no plain version
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "ssd_chunk_scan_ref", counted_ref)
        got_loss, got = grads(ops.ssd_chunk_scan)
    assert plain_calls == []
    jax_loss_v, jax_g = jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(need))))(
        *(jnp.asarray(inp[k], jnp.float32) for k in need))
    assert len(card_path) == 1 and LAUNCHES["ssd_scan"] == 1
    assert LAUNCHES["ssd_scan_bwd"] == 1
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=2e-5)
    np.testing.assert_allclose(float(got_loss), float(jax_loss_v),
                               rtol=2e-5)
    for k, g, w, j in zip(need, got, want, jax_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=k)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=2e-5, err_msg=f"{k} vs jax.grad")
