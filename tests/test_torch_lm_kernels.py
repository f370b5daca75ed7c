"""The port's LM kernels on the CPU (their plain PyTorch versions, which
the wrappers run for CPU tensors) against the JAX package's ops: flash
attention and the SSD scan as the JAX tests run them (Pallas in
interpret mode), the SSD scan also against the JAX reference
``ssd_chunk_scan_ref``, and the RG-LRU scan against its jnp reference
``rglru_scan_ref`` (the Pallas RG-LRU kernel does not run under this
jax).  Inputs are made with numpy from a seed and handed to both.
Tolerances are ``tests/test_kernels.py``'s: float32 2e-5, bfloat16
2e-2.  The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.ssd_scan.ops import ssd_chunk_scan as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_chunk_scan_ref as jax_ssd_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.ssd_scan.ops import ssd_chunk_scan
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_scan_ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    x = np.ascontiguousarray(x, np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(TORCH_DT[dtype]))


def _np(t) -> np.ndarray:
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


# ------------------------------------------------------------------ #
# flash attention
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,causal", [
    (1, 4, 4, 128, 64, True),     # MHA, aligned
    (2, 4, 2, 200, 64, True),     # GQA, padded seq
    (1, 8, 1, 256, 128, True),    # MQA
    (2, 4, 2, 160, 96, False),    # full attention, odd head_dim tile
    (1, 2, 2, 64, 32, True),      # smaller than one block
])
def test_flash_attention_matches_jax(b, h, kv, s, d, causal, dtype):
    rng = np.random.default_rng(b * s + d)
    jq, tq = _pair(rng.standard_normal((b, h, s, d)), dtype)
    jk, tk = _pair(rng.standard_normal((b, kv, s, d)), dtype)
    jv, tv = _pair(rng.standard_normal((b, kv, s, d)), dtype)
    want = jax_flash(jq, jk, jv, causal, 128, 128, True)
    got = flash_attention(tq, tk, tv, causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (b, h, s, d)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_flash_attention_padding_and_blocks():
    """Block sizes set only the padding: a short kv (masked by its true
    length), q shorter than a block, and the (64, 256) blocks of the JAX
    invariance test all give the plain version's unpadded answer."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 4, 256, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 256, 64), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 256, 64), np.float32))
    a = flash_attention(q, k, v, True, 128, 128)
    b = flash_attention(q, k, v, True, 64, 256)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)
    # kv of 200 keys padded to 256 by the op and masked by seq_kv, then
    # a causal q of 40 rows over 100 keys: the mask is aligned at the
    # start, as the kernel's is
    for sq, skv, causal in ((50, 200, False), (40, 100, True)):
        qs, ks, vs = (t[:, :, :n].contiguous()
                      for t, n in ((q, sq), (k, skv), (v, skv)))
        got = flash_attention(qs, ks, vs, causal)
        want = jax_flash(*(jnp.asarray(t.numpy()) for t in (qs, ks, vs)),
                         causal, 128, 128, True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_flash_attention_backward_matches_plain_and_jax():
    """The autograd backward (recompute through the plain version) equals
    the plain version's own autograd and the JAX op's custom-vjp grads."""
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 4, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32))]

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
        (fn(*ts) ** 2).sum().backward()
        return [t.grad.numpy() for t in ts]

    g_op = grads(lambda q, k, v: flash_attention(q, k, v, True))
    g_ref = grads(lambda q, k, v: flash_attention_ref(q, k, v, True))
    g_jax = jax.grad(lambda q, k, v: (jax_flash(q, k, v, True, 128, 128, True)
                                      ** 2).sum(), argnums=(0, 1, 2))(
        *[jnp.asarray(a) for a in arrs])
    for a, b, c in zip(g_op, g_ref, g_jax):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ #
# SSD scan
# ------------------------------------------------------------------ #
def _ssd_inputs(rng, b, s, h, p, n, dtype):
    jx, tx = _pair(rng.standard_normal((b, s, h, p)) * 0.5, dtype)
    al = -np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    jb, tb = _pair(rng.standard_normal((b, s, n)) * 0.3, dtype)
    jc, tc = _pair(rng.standard_normal((b, s, n)) * 0.3, dtype)
    return (jx, jnp.asarray(al), jb, jc), (tx, torch.from_numpy(al), tb, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 96, 3, 16, 32, 32),
    (1, 128, 2, 64, 128, 128),    # production-like tile
    (2, 100, 2, 16, 32, 32),      # needs padding
    (1, 64, 1, 8, 16, 16),
    (1, 5, 2, 16, 16, 16),        # shorter than a chunk: q = S
])
def test_ssd_scan_matches_jax(b, s, h, p, n, chunk, dtype):
    rng = np.random.default_rng(s + p)
    jin, tin = _ssd_inputs(rng, b, s, h, p, n, dtype)
    y, hf = ssd_chunk_scan(*tin, chunk=chunk)
    assert y.dtype == TORCH_DT[dtype] and hf.dtype == torch.float32
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, n, p)
    for yr, hr in (jax_ssd(*jin, chunk=chunk, interpret=True),
                   jax_ssd_ref(*jin, chunk=chunk)):
        np.testing.assert_allclose(_np(y), _np(yr), **TOL[dtype])
        np.testing.assert_allclose(_np(hf), _np(hr), **TOL[dtype])


def test_ssd_scan_state_continuity():
    """The final state does not depend on the chunk size, and a scan
    continued from a state equals the scan of the whole sequence."""
    rng = np.random.default_rng(3)
    _, (x, al, bm, cm) = _ssd_inputs(rng, 1, 64, 2, 8, 16, "float32")
    _, h16 = ssd_chunk_scan(x, al, bm, cm, chunk=16)
    _, h64 = ssd_chunk_scan(x, al, bm, cm, chunk=64)
    np.testing.assert_allclose(h16.numpy(), h64.numpy(), rtol=1e-5,
                               atol=1e-5)
    y_all, h_all = ssd_chunk_scan_ref(x, al, bm, cm, chunk=16)
    _, h_a = ssd_chunk_scan_ref(x[:, :32], al[:, :32], bm[:, :32],
                                cm[:, :32], chunk=16)
    y_b, h_b = ssd_chunk_scan_ref(x[:, 32:], al[:, 32:], bm[:, 32:],
                                  cm[:, 32:], h0=h_a, chunk=16)
    np.testing.assert_allclose(h_b.numpy(), h_all.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y_b.numpy(), y_all[:, 32:].numpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ #
# RG-LRU scan
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w,h0", [
    (2, 256, 128, False),
    (2, 300, 96, True),
    (1, 512, 256, True),
    (3, 64, 64, False),
    (1, 7, 5, True),
])
def test_rglru_scan_matches_jax_ref(b, s, w, h0, dtype):
    rng = np.random.default_rng(s + w)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(rng.standard_normal((b, s, w)) * 0.2, dtype)
    h0v = (rng.standard_normal((b, w)) * 0.1).astype(np.float32) \
        if h0 else None
    h, hl = rglru_scan(ta, tb, None if h0v is None else torch.from_numpy(h0v))
    hr, hlr = jax_rglru_ref(ja.astype(jnp.float32), jb.astype(jnp.float32),
                            None if h0v is None else jnp.asarray(h0v))
    assert h.dtype == torch.float32 and h.shape == (b, s, w)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **TOL[dtype])
    np.testing.assert_allclose(hl.numpy(), np.asarray(hlr), **TOL[dtype])


# ------------------------------------------------------------------ #
# wrappers
# ------------------------------------------------------------------ #
def test_wrappers_check_inputs_and_count_no_cpu_launch():
    before = dict(LAUNCHES)
    a = torch.rand(2, 8, 4)
    rglru_scan(a, a)
    x = torch.rand(1, 8, 2, 4)
    al = -torch.rand(1, 8, 2)
    bm = torch.rand(1, 8, 4)
    ssd_chunk_scan(x, al, bm, bm, chunk=4)
    q = torch.rand(1, 2, 8, 4)
    kv = q[:, :1].contiguous()
    flash_attention(q, kv, kv)
    assert LAUNCHES == before          # the CPU path launches nothing
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan(a.double(), a.double())
    with pytest.raises(TypeError, match="must be"):
        rglru_scan(a, a.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), a)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_scan(x, al, bm.transpose(1, 2).contiguous().transpose(1, 2),
                       bm, chunk=4)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk_scan(x, al.bfloat16(), bm, bm, chunk=4)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, q[:, :1].repeat(1, 3, 1, 1).contiguous(),
                        q[:, :1].repeat(1, 3, 1, 1).contiguous())
    # a device other than the card and the CPU is refused; a meta tensor
    # (the dry-run's abstract cells) only gets its output allocated, and
    # no launch is counted
    from repro_torch.kernels import common
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        common.route(torch.device("xpu"))
    meta = torch.empty((1, 2, 8, 4), device="meta")
    out = flash_attention(meta, meta, meta)
    assert out.device.type == "meta" and out.shape == meta.shape
    assert LAUNCHES == before
