"""The port's tensorized round engine (``repro_torch.core.engine``) on
the CPU against the JAX package's (``repro.core.engine``), on the
instances of ``tests/test_engine.py``:

* ``random_instance`` byte-equal to JAX's (config, schedule, adjacency,
  delays);
* ``run_engine(device="cpu")`` byte-equal to JAX's ``run_engine``, to
  JAX's numpy oracle ``run_ref`` and to the port's copy of it, on 10
  pc-mode seeds, 5 r-mode seeds, Fig. 3 in both modes and a static net
  whose delivery rounds are BFS distances; ``analyze`` equal to JAX's;
* ``run_engine_sharded`` with one rank in process and on 2 and 4
  spawned gloo ranks (N=50, so 4 ranks pad to 52) byte-equal to
  ``run_ref``, the padded rows never delivering (JAX's sharded runner
  fails on this jax, so the oracle stands in for it).
"""

from collections import deque

import numpy as np
import pytest

import repro.core.engine as J
from repro_torch.core import engine as T
from repro_torch.core.engine.sharded import run_engine_sharded

from torch_dist_ranks import run_on_ranks

PC = [dict(seed=seed, n=16, k=4, m_app=8, n_adds=5, n_rms=4, rounds=48,
           mode="pc", always_gate=bool(seed % 2), pong_delay=1 + seed % 3)
      for seed in range(10)]
R_MODE = [dict(seed=seed + 100, n=12, k=3, m_app=6, n_adds=4, n_rms=2,
               rounds=40, mode="r") for seed in range(5)]
SHARDED = dict(seed=3, n=50, k=4, m_app=8, n_adds=5, n_rms=3, rounds=40,
               mode="pc")


def _pair(kw):
    kw = dict(kw)
    seed = kw.pop("seed")
    return J.random_instance(seed, **kw), T.random_instance(seed, **kw)


@pytest.mark.parametrize("kw", PC + R_MODE,
                         ids=[f"pc{k['seed']}" for k in PC]
                         + [f"r{k['seed']}" for k in R_MODE])
def test_run_engine_byte_equal_to_jax_and_oracles(kw):
    (jcfg, jsched, jadj, jdelay), (cfg, sched, adj0, delay0) = _pair(kw)
    assert cfg == T.EngineConfig(**{f: getattr(jcfg, f) for f in
                                    ("n", "k", "rounds", "mode",
                                     "pong_delay", "always_gate")})
    for name in ("bcast_round", "bcast_origin", "add_round", "add_p",
                 "add_k", "add_q", "add_delay", "rm_round", "rm_p", "rm_k"):
        np.testing.assert_array_equal(getattr(sched, name),
                                      getattr(jsched, name), err_msg=name)
    np.testing.assert_array_equal(adj0, jadj)
    np.testing.assert_array_equal(delay0, jdelay)
    want = J.run_ref(jcfg, jsched, jadj.copy(), jdelay.copy())
    got = T.run_engine(cfg, sched, adj0, delay0, device="cpu")
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(J.run_engine(jcfg, jsched, jadj, jdelay)))
    np.testing.assert_array_equal(
        got, T.run_ref(cfg, sched, adj0.copy(), delay0.copy()))
    assert T.analyze(got, sched) == J.analyze(want, jsched)


def _fig3(mod, mode):
    n, k = 3, 3
    adj0 = np.full((n, k), -1, np.int64)
    delay0 = np.ones((n, k), np.int64)
    adj0[0, 0], delay0[0, 0] = 1, 5   # A -> B slow
    adj0[1, 0], delay0[1, 0] = 2, 5   # B -> D slow
    adj0[1, 1], delay0[1, 1] = 0, 5   # B -> A
    adj0[2, 0], delay0[2, 0] = 1, 5   # D -> B
    z = np.zeros(0, np.int32)
    sched = mod.Schedule(np.array([0, 3], np.int32), np.array([0, 0], np.int32),
                         np.array([2], np.int32), np.array([0], np.int32),
                         np.array([2], np.int32), np.array([2], np.int32),
                         np.array([1], np.int32), z, z, z)
    return mod.EngineConfig(n=n, k=k, rounds=40, mode=mode, pong_delay=1), \
        sched, adj0, delay0


@pytest.mark.parametrize("mode", ["r", "pc"])
def test_fig3_both_modes(mode):
    cfg, sched, adj0, delay0 = _fig3(T, mode)
    got = T.run_engine(cfg, sched, adj0, delay0, device="cpu")
    jcfg, jsched, jadj, jdelay = _fig3(J, mode)
    np.testing.assert_array_equal(
        got, J.run_ref(jcfg, jsched, jadj.copy(), jdelay.copy()))
    rep = T.analyze(got, sched)
    assert rep == J.analyze(got, jsched)
    if mode == "r":
        assert rep["violations"] > 0 and got[2, 1] < got[2, 0]
    else:
        assert rep["violations"] == 0 and rep["missing"] == 0
        assert rep["delivered_frac"] == 1.0 and got[2, 0] < got[2, 1]


def test_static_delivery_equals_bfs_distance():
    rng = np.random.default_rng(0)
    n, k = 32, 4
    adj0 = np.full((n, k), -1, np.int64)
    adj0[:, 0] = (np.arange(n) + 1) % n
    for i in range(n):
        adj0[i, 1:] = rng.choice(n, size=k - 1, replace=False)
    delay0 = np.ones((n, k), np.int64)
    sched = T.Schedule.empty_churn([0], [0])
    cfg = T.EngineConfig(n=n, k=k, rounds=n + 2, mode="pc")
    d = T.run_engine(cfg, sched, adj0, delay0, device="cpu")
    dist = {0: 0}
    dq = deque([0])
    while dq:
        u = dq.popleft()
        for v in adj0[u]:
            if v >= 0 and int(v) not in dist:
                dist[int(v)] = dist[u] + 1
                dq.append(int(v))
    assert [int(d[q, 0]) for q in range(n)] == [dist[q] for q in range(n)]


def _sharded_case():
    kw = dict(SHARDED)
    seed = kw.pop("seed")
    return T.random_instance(seed, **kw)


def test_sharded_one_rank_in_process():
    cfg, sched, adj0, delay0 = _sharded_case()
    got = run_engine_sharded(cfg, sched, adj0, delay0, device="cpu")
    np.testing.assert_array_equal(
        got, T.run_ref(cfg, sched, adj0.copy(), delay0.copy()))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ranks_byte_equal_to_oracle(world, tmp_path):
    cfg, sched, adj0, delay0 = _sharded_case()
    got, = run_on_ranks(world, tmp_path, "engine_cases",
                        ([(cfg, sched, adj0, delay0)],), timeout=120.0)
    pad = (-cfg.n) % world
    assert got.shape == (cfg.n + pad, sched.m_total)
    np.testing.assert_array_equal(
        got[:cfg.n], T.run_ref(cfg, sched, adj0.copy(), delay0.copy()))
    assert (got[cfg.n:] < 0).all()
