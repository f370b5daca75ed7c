"""The port's training path on the CPU against the JAX package's, on the
same seeded inputs:

* ``adamw_update`` (clipping on and off, ``master_weights`` with bf16
  live parameters) and the learning-rate schedules;
* one ``make_train_step`` step of the dense, hybrid and SSM smoke
  configs at float32 from JAX's own initial weights (loaded through
  ``models.convert``), with 1 and 2 microbatches: loss, ``grad_norm``
  and ``clip_scale`` within 2e-5 (relative), the gradients of
  ``jax.value_and_grad`` within 5e-5 of each leaf's largest (f32 sums
  over the batch's tokens, taken in another order), and the
  updated parameters within 1e-6 wherever the gradient is well above
  its rounding (AdamW's first step moves an entry by lr times the sign
  of its gradient, so an entry whose gradient is rounding noise may
  move either way);
* ``remat`` none, dots and full giving the same loss and gradients;
* the launcher: ``--mode spmd`` with a checkpoint and a resume equal to
  the run without one, and ``--mode gossip`` with churn ending on its
  causal check.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.training import optimizer as jopt
from repro.training import schedule as jsched
from repro.training.step import make_loss_fn as jax_make_loss_fn
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params, port_state
from repro_torch.training import optimizer as topt
from repro_torch.training import schedule as tsched
from repro_torch.training.step import (cross_entropy, make_grad_fn,
                                       make_loss_fn, make_train_step)

FAMILIES = ["yi-6b", "recurrentgemma-9b", "mamba2-2.7b"]
F32 = dict(compute_dtype="float32", param_dtype="float32")
LR = 1e-3


# ------------------------------------------------------------------ #
# optimizer and schedules
# ------------------------------------------------------------------ #
def _opt_inputs(seed, grad_scale, bf16=False):
    """A params/grads/state triple as numpy: a matrix, a 3-d leaf and a
    norm vector; moments positive, step 3."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stacks.0.0.b0.ln1": (5,), "conv": (2, 3, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    if bf16:
        p = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                           .astype(jnp.float32)) for k, v in p.items()}
    g = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (rng.random(s) * 0.01 + 1e-4).astype(np.float32)
         for k, s in shapes.items()}
    return p, g, m, v


@pytest.mark.parametrize("grad_scale,master", [(0.05, False), (3.0, False),
                                               (3.0, True)])
def test_adamw_update_matches_jax(grad_scale, master):
    """One update from the same state: clipping inactive (small
    gradients) and active; master weights keep an f32 copy and bf16 live
    parameters."""
    p, g, m, v = _opt_inputs(7, grad_scale, bf16=master)
    jcfg = jopt.AdamWConfig(lr=2e-2, master_weights=master)
    tcfg = topt.AdamWConfig(lr=2e-2, master_weights=master)
    live = jnp.bfloat16 if master else jnp.float32
    jp = {k: jnp.asarray(x).astype(live) for k, x in p.items()}
    jstate = jopt.init_opt_state(jp, master_weights=master)._replace(
        m={k: jnp.asarray(x) for k, x in m.items()},
        v={k: jnp.asarray(x) for k, x in v.items()},
        step=jnp.asarray(3, jnp.int32))
    jnew, jst, jmet = jopt.adamw_update(
        jcfg, jp, {k: jnp.asarray(x) for k, x in g.items()}, jstate, 0.5)

    tlive = torch.bfloat16 if master else torch.float32
    tp = {k: torch.from_numpy(x.copy()).to(tlive).requires_grad_()
          for k, x in p.items()}
    tstate = topt.init_opt_state(tp, master_weights=master)._replace(
        m={k: torch.from_numpy(x.copy()) for k, x in m.items()},
        v={k: torch.from_numpy(x.copy()) for k, x in v.items()},
        step=torch.tensor(3, dtype=torch.int32))
    tnew, tst, tmet = topt.adamw_update(
        tcfg, tp, {k: torch.from_numpy(x) for k, x in g.items()}, tstate,
        0.5)
    assert tnew is tp and int(tst.step) == int(jst.step) == 4
    for key in ("grad_norm", "clip_scale"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-6)
    assert (float(jmet["clip_scale"]) < 1.0) == (grad_scale > 1.0)
    for k in p:
        assert tnew[k].dtype == tlive
        np.testing.assert_allclose(tnew[k].detach().float().numpy(),
                                   np.asarray(jnew[k].astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        for name in ("m", "v") + (("master",) if master else ()):
            np.testing.assert_allclose(
                getattr(tst, name)[k].numpy(),
                np.asarray(getattr(jst, name)[k]), rtol=1e-6, atol=1e-7,
                err_msg=f"{name}/{k}")


def test_global_norm_sums_every_element():
    p, g, _, _ = _opt_inputs(3, 1.0)
    want = float(jopt.global_norm({k: jnp.asarray(x) for k, x in g.items()}))
    got = topt.global_norm({k: torch.from_numpy(x) for k, x in g.items()})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("warmup_cosine", (10, 100, 0.1)),
    ("warmup_cosine", (0, 50, 0.0)), ("warmup_linear", (5, 50, 0.0)),
    ("warmup_linear", (8, 40, 0.25))])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 4, 5, 8, 10, 20, 37, 50, 55, 100, 150):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7,
                                   err_msg=f"{name}{args} at {step}")


def test_cross_entropy_matches_jax_with_and_without_mask():
    from repro.training.step import cross_entropy as jax_ce
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((2, 7, 13)) * 3).astype(np.float32)
    labels = rng.integers(0, 13, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for mk in (None, mask):
        want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                            None if mk is None else jnp.asarray(mk)))
        got = float(cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  None if mk is None else
                                  torch.from_numpy(mk)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("frac", [0.1, 0.5, 1e-4])
def test_topk_compression_matches_jax(frac):
    """Indices equal to jnp.argsort's on equal inputs (ties included: a
    leaf of repeated magnitudes), values, the dense round trip, payload
    bytes and the error-feedback residual."""
    from repro.training import compression as jcomp
    from repro_torch.training import compression as tcomp
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((6, 7)).astype(np.float32),
            "b": np.repeat(rng.standard_normal(4), 5).astype(np.float32)
            * np.tile([1, -1], 10).astype(np.float32),
            "c": rng.standard_normal(3).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    jc, tc = jcomp.topk_compress(jt, frac), tcomp.topk_compress(tt, frac)
    for k in tree:
        assert tc[k][0].dtype == torch.int32 and tc[k][2] == jc[k][2]
        np.testing.assert_array_equal(tc[k][0].numpy(), np.asarray(jc[k][0]))
        np.testing.assert_array_equal(tc[k][1].numpy(), np.asarray(jc[k][1]))
    assert tcomp.payload_bytes(tc) == jcomp.payload_bytes(jc)
    jd, td = jcomp.topk_decompress(jc), tcomp.topk_decompress(tc)
    for k in tree:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    jef, tef = jcomp.ErrorFeedback(frac), tcomp.ErrorFeedback(frac)
    for _ in range(2):
        jef.compress(jt)
        tef.compress(tt)
    for k in tree:
        np.testing.assert_array_equal(tef.residual[k].numpy(),
                                      np.asarray(jef.residual[k]))


# ------------------------------------------------------------------ #
# one train step against JAX's
# ------------------------------------------------------------------ #
_STEPS = {}


def _step_run(name):
    """JAX's and the port's value_and_grad and one train step (1 and 2
    microbatches) from JAX's initial weights on one batch, cached."""
    if name in _STEPS:
        return _STEPS[name]
    jcfg = replace(JAX_ARCHS[name].smoke(), **F32)
    tcfg = replace(ARCHS[name].smoke(), **F32)
    jm = jax_build_model(jcfg, remat="none")
    params = jax.jit(lambda key: jm.init(key)[0])(jax.random.PRNGKey(0))
    tm = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                         device="cpu")
    batch = SyntheticLM(DataConfig(tcfg.vocab_size, 32, 4, seed=5)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm), has_aux=True))(params, jbatch)
    tparams = {k: v.detach().clone().requires_grad_()
               for k, v in tm.named_parameters()}
    (tloss, _), tgrads = make_grad_fn(tm)(tparams, batch)
    out = {"grads": (float(jloss), port_state(jax.tree.map(
        np.asarray, jgrads)), float(tloss), tgrads), "steps": {}}
    for mb in (1, 2):
        jstep = jax.jit(jax_make_train_step(jm, jopt.AdamWConfig(lr=LR),
                                            microbatches=mb))
        jp, _, jmet = jstep(params, jopt.init_opt_state(params), jbatch)
        tp = {k: v.detach().clone().requires_grad_()
              for k, v in tm.named_parameters()}
        tp, tst, tmet = make_train_step(tm, topt.AdamWConfig(lr=LR),
                                        microbatches=mb)(
            tp, topt.init_opt_state(tp), batch)
        out["steps"][mb] = (port_state(jax.tree.map(np.asarray, jp)),
                            {k: float(v) for k, v in jmet.items()},
                            {k: v.detach() for k, v in tp.items()},
                            {k: float(v) for k, v in tmet.items()})
    _STEPS[name] = out
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax(name):
    jloss, jgrads, tloss, tgrads = _step_run(name)["grads"]
    np.testing.assert_allclose(tloss, jloss, rtol=2e-5)
    assert sorted(tgrads) == sorted(jgrads)
    for k, want in jgrads.items():
        got = tgrads[k].numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, k
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name, mb):
    run = _step_run(name)
    _, jgrads, _, _ = run["grads"]
    jp, jmet, tp, tmet = run["steps"][mb]
    for key in ("loss", "ce", "grad_norm", "clip_scale"):
        np.testing.assert_allclose(tmet[key], jmet[key], rtol=2e-5,
                                   err_msg=key)
    assert tmet["aux"] == jmet["aux"] == 0.0
    assert tmet["step"] == jmet["step"] == 1.0
    moved = 0
    for k, want in jp.items():
        g = np.abs(jgrads[k])
        firm = g > 1e-3 * g.max()
        got = tp[k].numpy()
        np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-6,
                                   err_msg=k)
        moved += int(firm.sum())
    assert moved > 0.5 * sum(v.size for v in jp.values())


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "yi-6b"])
def test_remat_modes_give_equal_loss_and_gradients(name):
    cfg = replace(ARCHS[name].smoke(), **F32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 24, 2, seed=1)).batch(0)
    out = {}
    for remat in ("none", "dots", "full"):
        model = build_model(cfg, device="cpu", seed=3, remat=remat)
        params = dict(model.named_parameters())
        (loss, _), grads = make_grad_fn(model)(params, batch)
        out[remat] = (float(loss), grads)
    loss0, g0 = out["none"]
    for remat in ("dots", "full"):
        loss, g = out[remat]
        np.testing.assert_allclose(loss, loss0, rtol=1e-6, err_msg=remat)
        for k in g0:
            np.testing.assert_allclose(g[k].numpy(), g0[k].numpy(),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{remat}/{k}")
    with pytest.raises(ValueError, match="remat"):
        build_model(cfg, device="cpu", remat="everything")


def test_loss_fn_binds_a_replica_into_a_shared_model():
    """One model evaluates another replica's weights, and its own come
    back after the call."""
    cfg = replace(ARCHS["yi-6b"].smoke(), **F32)
    model = build_model(cfg, device="cpu", seed=0)
    other = build_model(cfg, device="cpu", seed=1)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2)).batch(0)
    loss_fn = make_loss_fn(model)
    with torch.no_grad():
        own = float(loss_fn(dict(model.named_parameters()), batch)[0])
        theirs = float(make_loss_fn(other)(dict(other.named_parameters()),
                                           batch)[0])
        bound = float(loss_fn(dict(other.named_parameters()), batch)[0])
        again = float(loss_fn(dict(model.named_parameters()), batch)[0])
    assert bound == theirs and bound != own and again == own


# ------------------------------------------------------------------ #
# the launcher
# ------------------------------------------------------------------ #
_SPMD = ["--device", "cpu", "--arch", "yi-6b", "--seq-len", "16",
         "--batch", "2", "--log-every", "100"]


def test_launcher_spmd_resumes_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.checkpoint import ckpt
    straight = launcher.main(_SPMD + ["--steps", "6"])
    d = str(tmp_path)
    first = launcher.main(_SPMD + ["--steps", "4", "--ckpt-dir", d,
                                   "--ckpt-every", "2"])
    assert ckpt.available_steps(d) == [2, 4]
    _, meta = ckpt.restore(d, 4)
    assert meta == {"data_step": 4, "arch": "yi-6b"}
    resumed = launcher.main(_SPMD + ["--steps", "6", "--ckpt-dir", d,
                                     "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "resuming from step 4" in out and "device cpu" in out
    assert np.isfinite(first) and resumed == pytest.approx(straight,
                                                           rel=1e-6)
    assert ckpt.latest_step(d) == 6


def test_launcher_gossip_with_churn(capsys):
    loss = launcher.main(["--device", "cpu", "--mode", "gossip", "--pods",
                          "3", "--rounds", "3", "--local-steps", "1",
                          "--seq-len", "16", "--batch", "2", "--churn"])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert "joined" in out and "crashed silently" in out
    assert "causal check:" in out and "device cpu" in out
