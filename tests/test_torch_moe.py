"""The port's MoE family (qwen3-moe-235b-a22b and grok-1-314b, ``smoke()``
at float32) on the CPU against the JAX package's, on JAX's weights
loaded by ``models.convert``:

* every leaf mapped, the router kept float32;
* forward logits within 5e-5 at the default training capacity (cf
  1.25, assignments dropped), the balance loss equal, and every layer's
  routing — top-k experts, the sort order, ranks and the kept set —
  equal to JAX's integers on the layer's input;
* ``moe_ffn`` alone at (1, 16,384, 64), routed in two 8,192-token
  chunks, within 5e-5 with the aux equal; a tied router takes the lower
  expert, as ``jax.lax.top_k`` does;
* prefill + decode equal to the forward within 2e-4 at a drop-free
  capacity (``tests/test_archs.py``'s setting);
* one loss-and-gradient evaluation equal to ``jax.value_and_grad``'s,
  the aux included, with remat none and dots;
* the serve and train launchers on the MoE archs.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe
from repro_torch.models.convert import port_state

from torch_family_cases import (check_decode_matches_forward,
                                check_grads_match_jax, forward_pair, inputs,
                                models)

MOE = ["qwen3-moe-235b-a22b", "grok-1-314b"]


def _jax_routing(router, x, cfg, train):
    """JAX's routing integers for x, by ``repro/models/moe.py``'s own
    steps (softmax, ``lax.top_k``, ``jnp.argsort``, the segment count)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = s * k
    cf = cfg.capacity_factor if train else cfg.capacity_factor_eval
    cap = max(1, min(s, int(np.ceil(s * k / e * cf))))
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(b, n)
    order = jnp.argsort(flat_e, axis=1)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    seg_start = jnp.sum(sorted_e[:, :, None] < jnp.arange(e)[None, None, :],
                        axis=1)
    rank = jnp.arange(n)[None, :] - jnp.take_along_axis(seg_start, sorted_e,
                                                        axis=1)
    return {"idx": np.asarray(idx), "order": np.asarray(order),
            "rank": np.asarray(rank), "keep": np.asarray(rank < cap),
            "cap": cap}


@pytest.mark.parametrize("name", MOE)
def test_convert_maps_every_leaf_router_f32(name):
    _, params, tm = models(name)
    state = port_state(jax.tree.map(np.asarray, params))
    own = dict(tm.named_parameters())
    assert sorted(state) == sorted(own)
    for key, arr in state.items():
        np.testing.assert_array_equal(own[key].detach().numpy(), arr)
    routers = [k for k in own if k.endswith("moe.router")]
    assert len(routers) == tm.cfg.num_layers
    bf16 = replace(tm.cfg, param_dtype="bfloat16")
    m16 = moe.MoE(bf16, torch.bfloat16, "cpu", torch.Generator())
    assert m16.router.dtype == torch.float32
    assert m16.w_gate.dtype == torch.bfloat16
    assert tuple(m16.w_down.shape) == (bf16.n_experts, bf16.d_ff,
                                       bf16.d_model)


@pytest.mark.parametrize("name", MOE)
def test_forward_with_drops_matches_jax_routing_included(name, monkeypatch):
    _, params, tm = models(name)
    cfg = tm.cfg
    assert cfg.capacity_factor == 1.25
    inp = inputs(cfg, 2, 24, seed=3)
    seen = []
    orig = moe.route

    def keep(p, cfg_, x, train):
        r = orig(p, cfg_, x, train)
        seen.append((p.router.detach().numpy(), x.detach().numpy(), train,
                     r))
        return r
    monkeypatch.setattr(moe, "route", keep)
    want, jaux, got, aux = forward_pair(name, inp)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)
    assert aux > 0
    assert len(seen) == cfg.num_layers
    dropped = 0
    for router, x, train, r in seen:
        assert train
        jr = _jax_routing(router, x, cfg, train)
        assert r.cap == jr["cap"]
        for key in ("idx", "order", "rank", "keep"):
            np.testing.assert_array_equal(getattr(r, key).numpy(), jr[key],
                                          err_msg=key)
        dropped += int((~jr["keep"]).sum())
    assert dropped > 0, "cf 1.25 dropped nothing: no drop was tested"


def test_moe_ffn_chunked_matches_jax():
    """(1, 16,384, 64): two chunks of 8,192 tokens, the aux their mean."""
    _, params, tm = models("grok-1-314b")
    cfg = tm.cfg
    layer = tm.stacks[0][1]["b0"].moe
    jp = jax.tree.map(jnp.asarray, params["stack0"]["b0"]["moe"])
    jp = jax.tree.map(lambda t: t[1], jp)
    x = (np.random.default_rng(9).standard_normal(
        (1, 2 * moe.MOE_CHUNK, cfg.d_model)) * 0.5).astype(np.float32)
    want, jaux = jax_moe_ffn(jp, cfg, jnp.asarray(x), train=True)
    chunks = torch.from_numpy(x).split(moe.MOE_CHUNK, dim=1)
    assert len(chunks) == 2
    with torch.no_grad():
        got, aux = moe.moe_ffn(layer, cfg, torch.from_numpy(x), train=True)
        half = [float(moe.route(layer, cfg, c, True).aux) for c in chunks]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(float(aux), sum(half) / 2, rtol=1e-6)


def test_tied_router_takes_the_lower_expert():
    """Experts 1 and 2 with equal router columns tie on every token: the
    port's top-k takes 1 before 2, as ``jax.lax.top_k`` does."""
    _, _, tm = models("qwen3-moe-235b-a22b")
    cfg = tm.cfg
    layer = tm.stacks[0][0]["b0"].moe
    router = layer.router.detach().numpy().copy()
    router[:, 1] *= 4.0          # the tied pair, the top two below
    router[:, 2] = router[:, 1]
    x = np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    x = np.abs(x) * np.sign(router[:, 1])[None, None, :]
    p = moe.MoE(cfg, torch.float32, "cpu", torch.Generator())
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(router))
    r = moe.route(p, cfg, torch.from_numpy(x), True)
    jr = _jax_routing(router, x, cfg, True)
    assert bool((r.gates[..., 0] == r.gates[..., 1]).all())
    assert (jr["idx"][..., :2] == [1, 2]).all()
    for key in ("idx", "order", "rank", "keep"):
        np.testing.assert_array_equal(getattr(r, key).numpy(), jr[key],
                                      err_msg=key)


@pytest.mark.parametrize("name", MOE)
def test_decode_matches_forward_drop_free(name):
    _, _, tm = models(name, drop_free_cf=True)
    check_decode_matches_forward(name, inputs(tm.cfg, 2, 20, seed=4), 12)


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("name", MOE)
def test_train_grads_match_jax_with_aux(name, remat):
    _, _, tm = models(name)
    jaux = check_grads_match_jax(name, inputs(tm.cfg, 2, 24, seed=5), remat)
    assert jaux > 0


def test_launchers_take_moe_archs(capsys):
    reqs, _ = serve_launcher.main(["--device", "cpu", "--arch",
                                   "grok-1-314b", "--requests", "3",
                                   "--max-new", "4"])
    assert all(len(r.out_tokens) == 4 for r in reqs)
    loss = train_launcher.main(["--device", "cpu", "--arch",
                                "qwen3-moe-235b-a22b", "--steps", "2",
                                "--seq-len", "16", "--batch", "2",
                                "--log-every", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "device cpu" in out
