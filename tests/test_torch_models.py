"""The port's LM models on the CPU against the JAX package's: the config
copies field for field, the JAX weights loaded by ``convert.py`` giving
the same logits (5e-5) for the dense, SSM and hybrid families, the
1,024-token forward that takes the blockwise attention branch, and
prefill + decode equal to the full forward (2e-4, as
``tests/test_archs.py`` holds the JAX model), the windowed cache roll
included.  Everything runs at float32 on the ``smoke()`` reductions."""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro_torch.backend import DeviceUnavailableError
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_params, port_state

FAMILIES = ["yi-6b", "mamba2-2.7b", "recurrentgemma-9b"]


def smoke_cfgs(name):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    return (replace(JAX_ARCHS[name].smoke(), **kw),
            replace(ARCHS[name].smoke(), **kw))


_MODELS = {}


def models(name):
    """(JAX model, its params, the port's model holding them), cached."""
    if name not in _MODELS:
        jcfg, tcfg = smoke_cfgs(name)
        jm = jax_build_model(jcfg, remat="none")
        params, _ = jm.init(jax.random.PRNGKey(0))
        tm = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
        _MODELS[name] = (jm, params, tm)
    return _MODELS[name]


# ------------------------------------------------------------------ #
# configs
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_config_copy_matches_reference(name):
    ref, port = JAX_ARCHS[name], get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.layer_kinds() == ref.layer_kinds()
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())
    assert ({k: dataclasses.asdict(v) for k, v in SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()})


def test_other_families_and_missing_card_raise():
    """The MoE, encoder-decoder and M-RoPE families build (their parity
    with the JAX package: ``test_torch_{moe,encdec,mrope}.py``); without
    a card the default device raises."""
    for name, part in (("qwen3-moe-235b-a22b", "stacks.0.0.b0.moe.router"),
                       ("grok-1-314b", "stacks.0.0.b0.moe.w_down"),
                       ("whisper-small", "enc_stack.0.b0.attn.wq"),
                       ("qwen2-vl-72b", "stacks.0.0.b0.mlp.w_up")):
        model = Model(get_arch(name).smoke(), device="cpu")
        assert part in dict(model.named_parameters()), name
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        Model(get_arch("yi-6b").smoke())


# ------------------------------------------------------------------ #
# weights and forward parity
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", FAMILIES)
def test_convert_maps_every_leaf(name):
    _, params, tm = models(name)
    state = port_state(jax.tree.map(np.asarray, params))
    own = dict(tm.named_parameters())
    assert sorted(state) == sorted(own)
    for key, arr in state.items():
        np.testing.assert_array_equal(own[key].detach().numpy(), arr)
    n_port = sum(p.numel() for p in own.values())
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert n_port == n_jax


@pytest.mark.parametrize("seq", [24, 1024])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name, seq):
    """Logits of a (2, seq) batch; at seq = 1,024 attention takes the
    blockwise branch (a multiple of ATTN_CHUNK above one chunk)."""
    jm, params, tm = models(name)
    tokens = np.random.default_rng(seq).integers(
        0, tm.cfg.vocab_size, (2, seq)).astype(np.int32)
    want, _, _, _ = jm.forward(params, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (2, seq, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


# ------------------------------------------------------------------ #
# prefill + decode
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("s0,s", [(16, 24), (45, 53)])
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_forward(name, s0, s):
    """Prefill s0 tokens with caches of s slots, then decode to s: each
    step's logits equal the full forward's.  At s0 = 45 the hybrid's
    attention caches (window 32) are circular: the prefill keeps the
    prompt's tail rolled to slot p % 32 and decoding wraps around it."""
    _, _, tm = models(name)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (2, s)).astype(np.int64))
    with torch.no_grad():
        full = tm(tokens)
    last, caches = tm.prefill(tokens[:, :s0], pad_to=s)
    np.testing.assert_allclose(last.numpy(), full[:, s0 - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    for t in range(s0, s):
        logits, caches = tm.decode_step(tokens[:, t], caches, t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_prefill_matches_jax_prefill():
    """The port's prefill logits and caches equal the JAX package's (the
    caches unstacked from its (n_rep, ...) leaves)."""
    jm, params, tm = models("recurrentgemma-9b")
    tokens = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (1, 40)).astype(np.int32)
    want, jcaches = jm.prefill(params, jnp.asarray(tokens), pad_to=48)
    got, caches = tm.prefill(torch.from_numpy(tokens), pad_to=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    for stack, jstack in zip(caches, jcaches):
        for r, block in enumerate(stack):
            for name, cache in block.items():
                for leaf, jleaf in zip(cache, jstack[name]):
                    np.testing.assert_allclose(
                        leaf.float().numpy(), np.asarray(jleaf[r], np.float32),
                        rtol=5e-5, atol=5e-5)


def test_bf16_decode_keeps_the_compute_type():
    """At a bf16 compute type (the full configs' default) the SSM decode
    keeps its f32 state and a bf16 block output, so decoding runs; its
    logits stay close to the f32 model's."""
    _, _, tm = models("mamba2-2.7b")
    tm16 = Model(replace(tm.cfg, compute_dtype="bfloat16"), device="cpu")
    tm16.load_state_dict(tm.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tm.cfg.vocab_size, (1, 12)).astype(np.int64))
    _, caches = tm16.prefill(tokens[:, :8], pad_to=12)
    assert caches[0][0]["b0"][1].dtype == torch.float32
    with torch.no_grad():
        full = tm(tokens)
    for t in range(8, 12):
        logits, caches = tm16.decode_step(tokens[:, t], caches, t)
        assert caches[0][0]["b0"][1].dtype == torch.float32
        assert bool(torch.isfinite(logits).all())
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=0.1, atol=0.1)
