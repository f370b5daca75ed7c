"""The port's causal-gossip trainer on the CPU against the JAX package's
(``tests/test_gossip.py``'s tiny config and cases): every pod starts
from the JAX pods' weights (``PRNGKey(0)``, through
``models.convert.port_state``), and the two runs must give equal apply
logs, equal causal reports and equal ``bytes_stored``; the losses agree
within 5e-3 (relative) in the first round and 5e-2 after.  Both runs
are f32 AdamW at lr 1e-2, whose first step moves each entry by lr times
the sign of its gradient, so an entry whose gradient is rounding noise
moves either way and the difference grows over the rounds while the
protocol's schedule stays identical: the JAX trainer against itself,
its initial weights scaled by 1 + 1e-7 noise, differs by up to 1.2e-3
in the first round and 1.8e-2 by the tenth, as the port does.  Then
the port's versions of that file's cases: convergence, causal safety,
dissemination, replica drift, join and graceful leave, a silent crash,
compression, checkpoint restart and a straggler."""

from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.models import build_model as jax_build_model
from repro.runtime.gossip import CausalGossipTrainer as JaxTrainer
from repro.runtime.gossip import GossipConfig as JaxGossipConfig
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.models.convert import port_state
from repro_torch.runtime.gossip import CausalGossipTrainer, GossipConfig

TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2,
            head_dim=16, vocab_size=64, compute_dtype="float32",
            param_dtype="float32")
FIRST_ROUND_TOL = 5e-3
LOSS_TOL = 5e-2


def _jax_state():
    jm = jax_build_model(replace(JAX_ARCHS["yi-6b"].smoke(), **TINY),
                         remat="none")
    params, _ = jm.init(jax.random.PRNGKey(0))
    return port_state(jax.tree.map(np.asarray, params))


_STATE = {}


def make_trainer(n_pods=4, seed=0, **gkw):
    if "w" not in _STATE:
        _STATE["w"] = _jax_state()
    cfg = replace(ARCHS["yi-6b"].smoke(), **TINY)
    dc = DataConfig(vocab_size=64, seq_len=32, global_batch=8)
    return CausalGossipTrainer(
        lambda: build_model(cfg, device="cpu"), n_pods,
        GossipConfig(local_steps=2, **gkw), dc, seed=seed,
        init_state=_STATE["w"])


def make_jax_trainer(n_pods=4, seed=0, **gkw):
    cfg = replace(JAX_ARCHS["yi-6b"].smoke(), **TINY)
    dc = JaxDataConfig(vocab_size=64, seq_len=32, global_batch=8)
    return JaxTrainer(lambda: jax_build_model(cfg, remat="none"), n_pods,
                      JaxGossipConfig(local_steps=2, **gkw), dc, seed=seed)


def assert_same_run(port, ref):
    """Equal membership, apply logs, causal reports and payload bytes;
    losses within tolerance."""
    assert sorted(port.pods) == sorted(ref.pods)
    for pid, pod in port.pods.items():
        rp = ref.pods[pid]
        assert pod.alive == rp.alive, pid
        assert pod.applied == rp.applied, pid
        assert len(pod.losses) == len(rp.losses), pid
        if pod.losses:
            np.testing.assert_allclose(pod.losses[0], rp.losses[0],
                                       rtol=FIRST_ROUND_TOL)
            np.testing.assert_allclose(pod.losses, rp.losses, rtol=LOSS_TOL,
                                       err_msg=f"pod {pid}")
    assert port.store.bytes_stored == ref.store.bytes_stored
    a, b = port.causal_report(), ref.causal_report()
    assert a.summary() == b.summary()
    assert (a.causal_ok, a.double_deliveries, a.n_broadcasts) == (
        b.causal_ok, b.double_deliveries, b.n_broadcasts)


@pytest.fixture(scope="module")
def converged_pair():
    tr, ref = make_trainer(), make_jax_trainer()
    tr.run_rounds(10)
    ref.run_rounds(10)
    return tr, ref


def test_gossip_run_equals_jax(converged_pair):
    tr, ref = converged_pair
    assert_same_run(tr, ref)
    assert tr.device.type == "cpu"
    np.testing.assert_allclose(tr.replica_drift(), ref.replica_drift(),
                               rtol=0.1)


def test_gossip_loss_decreases(converged_pair):
    """3-round leading/trailing means, as tests/test_gossip.py compares."""
    tr, _ = converged_pair
    for pod in tr.pods.values():
        head = float(np.mean(pod.losses[:3]))
        tail = float(np.mean(pod.losses[-3:]))
        assert tail < head - 0.25, pod.losses


def test_gossip_is_causally_safe(converged_pair):
    tr, _ = converged_pair
    rep = tr.causal_report()
    assert rep.causal_ok and not rep.double_deliveries, rep.summary()
    assert rep.n_broadcasts == sum(len(p.losses) for p in tr.pods.values())


def test_gossip_updates_disseminate_to_all(converged_pair):
    tr, _ = converged_pair
    n = len(tr.pods)
    for pod in tr.pods.values():
        assert len(pod.applied) == (n - 1) * len(pod.losses)


def test_gossip_replicas_stay_close(converged_pair):
    assert converged_pair[0].replica_drift() < 0.8


def test_gossip_elastic_join_and_leave():
    def churn(r, t):
        if r == 2:
            t.join()                      # pod 4 joins mid-run
        if r == 4:
            t.leave(1, graceful=True)     # pod 1 departs

    tr, ref = make_trainer(n_pods=4), make_jax_trainer(n_pods=4)
    tr.run_rounds(8, churn=churn)
    ref.run_rounds(8, churn=churn)
    assert_same_run(tr, ref)
    rep = tr.causal_report()
    assert rep.causal_ok and not rep.double_deliveries, rep.summary()
    joined = tr.pods[4]
    assert joined.losses and joined.losses[-1] < 4.5
    assert len(joined.applied) > 0
    assert not tr.pods[1].alive


def test_gossip_silent_crash_is_survived():
    def churn(r, t):
        if r == 3:
            t.leave(2, graceful=False)    # silent crash (Fig. 5b)

    kw = dict(ping_timeout=5.0, max_retry=2)
    tr, ref = make_trainer(**kw), make_jax_trainer(**kw)
    tr.run_rounds(8, churn=churn)
    ref.run_rounds(8, churn=churn)
    assert_same_run(tr, ref)
    rep = tr.causal_report()
    assert rep.causal_ok and not rep.double_deliveries, rep.summary()
    assert all(p.losses[-1] < p.losses[0] for p in tr.pods.values()
               if p.alive)


def test_gossip_compression_converges_with_smaller_payloads():
    """Top-k at 10% within JAX's leaves: the payload bytes equal the JAX
    trainer's, ~20% of the dense run's."""
    dense = make_trainer(n_pods=3, seed=1)
    dense.run_rounds(6)
    comp = make_trainer(n_pods=3, seed=1, compress_frac=0.1)
    comp.run_rounds(6)
    ref = make_jax_trainer(n_pods=3, seed=1, compress_frac=0.1)
    ref.run_rounds(6)
    assert_same_run(comp, ref)
    assert comp.mean_loss() < 4.3
    assert comp.store.bytes_stored < 0.25 * dense.store.bytes_stored


def test_gossip_checkpoint_restart(tmp_path):
    from repro_torch.checkpoint import ckpt
    tr = make_trainer(n_pods=3)
    tr.run_rounds(4)
    pod = tr.pods[0]
    ckpt.save(str(tmp_path), pod.round,
              {"params": pod.params, "opt": pod.opt_state._asdict()},
              meta={"data_step": pod.data_step, "round": pod.round})
    tr.leave(0, graceful=False)
    new_pid = tr.join()
    npod = tr.pods[new_pid]
    state, meta = ckpt.restore(
        str(tmp_path), ckpt.latest_step(str(tmp_path)),
        like={"params": npod.params, "opt": npod.opt_state._asdict()})
    for k, p in npod.params.items():
        np.testing.assert_array_equal(state["params"][k].numpy(),
                                      pod.params[k].detach().numpy())
    npod.params = {k: v.requires_grad_() for k, v in state["params"].items()}
    npod.data_step = meta["data_step"]
    tr.run_rounds(4)
    rep = tr.causal_report()
    assert rep.causal_ok and not rep.double_deliveries, rep.summary()
    assert npod.losses[-1] < 4.3


def test_gossip_straggler_does_not_block_fleet():
    tr, ref = make_trainer(n_pods=4), make_jax_trainer(n_pods=4)
    tr.run_rounds(9, stragglers={2: 3})
    ref.run_rounds(9, stragglers={2: 3})
    assert_same_run(tr, ref)
    fast = [p for p in tr.pods.values() if p.pid != 2]
    assert all(len(p.losses) == 9 for p in fast)
    assert len(tr.pods[2].losses) == 3
    assert all(p.losses[-1] < p.losses[0] for p in fast)
    for p in fast:
        assert sum(1 for (o, _) in p.applied if o == 2) == 3
