"""Shared cases of ``test_torch_{moe,encdec,mrope}.py``: the JAX package's
model and the port's on the same weights (``models.convert``) for one
arch's ``smoke()`` config at float32, seeded inputs as numpy, and the
parity checks each family runs — logits, prefill + decode against the
full forward, and one loss-and-gradient evaluation against
``jax.value_and_grad`` of JAX's ``make_loss_fn``."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.training.step import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import ARCHS
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params, port_state
from repro_torch.training.step import make_grad_fn

F32 = dict(compute_dtype="float32", param_dtype="float32")
_MODELS = {}
_GRADS = {}


def drop_free(cfg):
    """Both capacity factors at E / k: no assignment is ever dropped, so
    decoding equals the forward (``tests/test_archs.py``'s setting)."""
    cf = float(cfg.n_experts / cfg.top_k)
    return dict(capacity_factor=cf, capacity_factor_eval=cf)


def models(name, drop_free_cf=False):
    """(JAX model, its params, the port's model holding them), cached;
    ``drop_free_cf`` applies to an MoE arch only."""
    drop_free_cf = drop_free_cf and JAX_ARCHS[name].is_moe
    key = (name, drop_free_cf)
    if key not in _MODELS:
        jcfg = replace(JAX_ARCHS[name].smoke(), **F32)
        tcfg = replace(ARCHS[name].smoke(), **F32)
        if drop_free_cf:
            jcfg = replace(jcfg, **drop_free(jcfg))
            tcfg = replace(tcfg, **drop_free(tcfg))
        jm = jax_build_model(jcfg, remat="none")
        params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
        tm = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
        _MODELS[key] = (jm, params, tm)
    return _MODELS[key]


def inputs(cfg, b, s, seed, positions=None):
    """Seeded numpy inputs: tokens, labels, and ``enc_embeds`` for an
    encoder-decoder; ``positions`` as given (None: the default)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.is_encdec:
        out["enc_embeds"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if positions is not None:
        out["positions"] = positions
    return out


def model_kw(inp, to):
    """The model inputs of ``inp`` (not the labels), through ``to``."""
    return {k: to(v) for k, v in inp.items()
            if k in ("tokens", "positions", "embeds", "enc_embeds")}


def forward_pair(name, inp, drop_free_cf=False):
    """(JAX logits, JAX aux, port logits, port aux) as numpy."""
    jm, params, tm = models(name, drop_free_cf)
    want, jaux, _, _ = jm.forward(params, **model_kw(inp, jnp.asarray))
    with torch.no_grad():
        got, aux = tm.forward_aux(**model_kw(inp, torch.from_numpy))
    return np.asarray(want), float(jaux), got.numpy(), float(aux)


def check_decode_matches_forward(name, inp, s0):
    """Prefill the first ``s0`` positions with caches of S slots, then
    decode to S: each step's logits equal the full forward's (2e-4),
    at a drop-free capacity.  Returns the prefill's caches."""
    _, _, tm = models(name, drop_free_cf=True)
    kw = model_kw(inp, torch.from_numpy)
    s = kw["tokens"].shape[1]
    with torch.no_grad():
        full = tm(**kw)
    pre = dict(kw, tokens=kw["tokens"][:, :s0])
    if "positions" in pre:
        pre["positions"] = pre["positions"][..., :s0]
    last, caches = tm.prefill(**pre, pad_to=s)
    np.testing.assert_allclose(last.numpy(), full[:, s0 - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    for t in range(s0, s):
        logits, caches = tm.decode_step(kw["tokens"][:, t], caches, t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=f"t={t}")
    return caches


def _jax_grads(name, inp):
    key = (name, tuple(sorted(inp)), inp["tokens"].tobytes())
    if key not in _GRADS:
        jm, params, _ = models(name)
        jbatch = {k: jnp.asarray(v) for k, v in inp.items()}
        (loss, parts), grads = jax.jit(jax.value_and_grad(
            jax_make_loss_fn(jm), has_aux=True))(params, jbatch)
        _GRADS[key] = (float(loss), float(parts["aux"]),
                       port_state(jax.tree.map(np.asarray, grads)))
    return _GRADS[key]


def check_grads_match_jax(name, inp, remat):
    """One loss-and-gradient evaluation of the port (``make_grad_fn``,
    ``remat``) against ``jax.value_and_grad`` of JAX's loss, aux
    included, from the same weights: loss and aux within 2e-5
    (relative), every gradient leaf within 5e-5 of its largest entry (f32
    sums in another order)."""
    jloss, jaux, jgrads = _jax_grads(name, inp)
    _, _, tm = models(name)
    model = Model(tm.cfg, device="cpu", remat=remat)
    model.load_state_dict(tm.state_dict())
    params = {k: v.detach().clone().requires_grad_()
              for k, v in model.named_parameters()}
    (loss, parts), grads = make_grad_fn(model)(params, inp)
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-5)
    np.testing.assert_allclose(float(parts["aux"]), jaux, rtol=2e-5,
                               atol=1e-7)
    assert sorted(grads) == sorted(jgrads)
    for k, want in jgrads.items():
        scale = float(np.abs(want).max())
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=5e-5 * scale, err_msg=k)
    return jaux
