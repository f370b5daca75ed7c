"""CausalGossipTrainer — the paper's protocol as a training control plane.

The port of the JAX package's ``runtime/gossip.py``.  Each pod is a
PC-broadcast *process* (``repro_torch.core``); the overlay between pods
is the paper's dynamic network.  Training is DiLoCo-style local SGD:

  1. a pod runs H local AdamW steps on its data shard;
  2. it computes the outer update (pseudo-gradient) against its round
     anchor, optionally top-k + error-feedback compressed;
  3. it PC-broadcasts the update: O(1) control metadata (<pod, counter>),
     while the tensors ride the data plane (a blob store keyed by
     message id);
  4. every pod folds in updates **in causal order** upon delivery: if pod
     B computed its update after observing A's, no pod ever applies B's
     before A's — model lineage stays monotone with no vector clocks.

Elasticity is the paper's own mechanism: pod joins add links that stay
*unsafe* until the ping phase completes (Algorithm 2); silent pod deaths
exhaust retries and the link is abandoned (Algorithm 3).  A joining pod
copies a neighbour's weights and then receives causally ordered updates
like everyone else.

The protocol runs on the port's exact event simulator (host Python, the
JAX package's order of random draws and event ties, so the apply logs
match it tuple for tuple).  The tensors live on the model's device: the
pods' replicas, their optimizer state, the deltas and the blobs.  All
pods share one model and one train step (``training.step.bound`` binds
each pod's replica into it), and all start from the same weights, as
every JAX pod draws its weights from ``PRNGKey(0)``.  Top-k compression
selects within JAX's leaves (``models.convert.stack_superblocks``), so a
compressed payload has JAX's size.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import BoundedPCBroadcast, Network, check_trace
from ..core.base import AppMsg
from ..data.pipeline import DataConfig, SyntheticLM
from ..models.convert import stack_superblocks, unstack_superblocks
from ..training.compression import (ErrorFeedback, payload_bytes,
                                    topk_decompress)
from ..training.optimizer import AdamWConfig, init_opt_state
from ..training.step import make_train_step

__all__ = ["GossipConfig", "BlobStore", "Pod", "CausalGossipTrainer"]

Tree = Dict[str, torch.Tensor]


@dataclass
class GossipConfig:
    local_steps: int = 4            # H: inner steps per round
    outer_lr: float = 0.7           # mixing rate for foreign updates
    compress_frac: float = 0.0      # 0 = dense updates
    inner: AdamWConfig = field(default_factory=lambda: AdamWConfig(lr=1e-2))
    round_time: float = 1.0         # simulated seconds per round
    ping_timeout: float = 30.0
    max_retry: int = 5
    max_buffer: int = 256


class BlobStore:
    """Data plane: update tensors keyed by (pod, counter) message id."""

    def __init__(self):
        self.blobs: Dict[Tuple[int, int], Any] = {}
        self.bytes_stored = 0

    def put(self, mid, tree, nbytes: int):
        self.blobs[mid] = tree
        self.bytes_stored += nbytes

    def get(self, mid):
        return self.blobs[mid]


def _copy(tree: Tree) -> Tree:
    """Leaf tensors of their own, trainable."""
    return {k: v.detach().clone().requires_grad_(v.is_floating_point())
            for k, v in tree.items()}


class Pod:
    """One training pod: a model replica + a PC-broadcast endpoint.

    ``params`` is the replica it starts from (copied); ``train_step`` the
    step every pod shares."""

    def __init__(self, pid: int, model, cfg: GossipConfig, data_cfg,
                 store: BlobStore, params: Tree, train_step: Callable):
        self.pid = pid
        self.model = model
        self.cfg = cfg
        self.store = store
        self.params = _copy(params)
        self.opt_state = init_opt_state(self.params)
        self.train_step = train_step
        self.data = SyntheticLM(dataclasses.replace(data_cfg, shard=pid))
        self.data_step = 0
        self.round = 0
        self.applied: List[Tuple[int, int]] = []    # causal apply log
        self.losses: List[float] = []
        self.ef = (ErrorFeedback(cfg.compress_frac)
                   if cfg.compress_frac else None)
        self.proto = BoundedPCBroadcast(
            pid, deliver_cb=self._on_deliver, ping_mode="route",
            direct_ping_fallback=True,   # fresh-joiner bootstrap; history
                                         # arrives via adopt_weights()
            max_size=cfg.max_buffer, max_retry=cfg.max_retry,
            ping_timeout=cfg.ping_timeout)
        self.alive = True

    # ---------------- inner optimization ------------------------------ #
    def local_round(self):
        anchor = {k: v.detach().clone() for k, v in self.params.items()}
        loss = float("nan")
        for _ in range(self.cfg.local_steps):
            self.params, self.opt_state, m = self.train_step(
                self.params, self.opt_state, self.data.batch(self.data_step))
            loss = float(m["loss"])
            self.data_step += 1
        self.losses.append(loss)
        self.round += 1
        # outer update (pseudo-gradient): anchor - new
        delta = {k: (anchor[k] - p.detach()).float()
                 for k, p in self.params.items()}
        return loss, delta

    # ---------------- gossip plane ------------------------------------ #
    def publish(self, delta: Tree) -> AppMsg:
        nbytes = sum(x.numel() * x.element_size() for x in delta.values())
        if self.ef is not None:
            ctree = self.ef.compress(stack_superblocks(delta))
            nbytes = payload_bytes(ctree)
            blob = ("topk", ctree)
        else:
            blob = ("dense", delta)
        m = self.proto.broadcast(payload=("update", self.round))
        self.store.put((m.origin, m.counter), blob, nbytes)
        return m

    def _on_deliver(self, pid: int, msg: AppMsg) -> None:
        """Causal delivery: fold the update into the local replica."""
        if msg.origin == self.pid:
            return  # own update is already in params (and precedes the
                    # blob store write inside publish())
        mid = (msg.origin, msg.counter)
        kind, blob = self.store.get(mid)
        delta = (unstack_superblocks(topk_decompress(blob)) if kind == "topk"
                 else blob)
        lr = self.cfg.outer_lr / 2.0
        with torch.no_grad():
            for k, p in self.params.items():
                d = delta[k].to(p.device)
                p.copy_(p.float() - lr * d.float())
        self.applied.append(mid)

    # ---------------- elasticity --------------------------------------- #
    def adopt_weights(self, other: "Pod") -> None:
        """State transfer at join: copy a live neighbour's replica."""
        self.params = _copy(other.params)
        self.opt_state = init_opt_state(self.params)


class CausalGossipTrainer:
    """Drives N pods over the event-simulated overlay.

    ``model_factory()`` builds the one model the pods share (on its
    device); every pod starts from ``init_state`` (parameter name ->
    array or tensor, e.g. ``models.convert.port_state`` of JAX weights)
    or, without it, from that model's own weights."""

    def __init__(self, model_factory: Callable[[], Any], n_pods: int,
                 cfg: GossipConfig, data_cfg, seed: int = 0,
                 delay: float = 0.05, init_state=None):
        self.cfg = cfg
        self.net = Network(seed=seed, default_delay=delay,
                           oob_delay=delay / 2)
        self.store = BlobStore()
        self.model = model_factory()
        own = dict(self.model.named_parameters())
        if init_state is None:
            self.init_params = _copy(own)
        else:
            if sorted(init_state) != sorted(own):
                raise KeyError("init_state must name every parameter of "
                               "the model, and nothing else")
            self.init_params = _copy({
                k: torch.as_tensor(np.array(init_state[k])).to(
                    device=own[k].device, dtype=own[k].dtype)
                for k in own})
        self.data_cfg = data_cfg
        self.pods: Dict[int, Pod] = {}
        self._next_pid = 0
        self._shared_step = make_train_step(self.model, cfg.inner)
        for _ in range(n_pods):
            self._spawn()
        pids = list(self.pods)
        for i, p in enumerate(pids):      # ring + chord bootstrap overlay
            self.net.connect(p, pids[(i + 1) % len(pids)])
            if len(pids) > 3:
                self.net.connect(p, pids[(i + len(pids) // 2) % len(pids)])

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _spawn(self) -> Pod:
        pid = self._next_pid
        self._next_pid += 1
        pod = Pod(pid, self.model, self.cfg, self.data_cfg, self.store,
                  self.init_params, self._shared_step)
        self.pods[pid] = pod
        self.net.add_process(pod.proto)
        return pod

    # ---------------- elastic membership ------------------------------- #
    def join(self, neighbors: Optional[List[int]] = None) -> int:
        """A new pod joins mid-run: weights from a neighbour, links gated
        by ping phases (the paper's Algorithm 2 doing elastic scaling)."""
        pod = self._spawn()
        alive = [p for p in self.pods.values()
                 if p.alive and p.pid != pod.pid]
        neighbors = neighbors or [p.pid for p in
                                  alive[-3:]]  # arbitrary live subset
        pod.adopt_weights(self.pods[neighbors[0]])
        for q in neighbors:
            self.net.connect(pod.pid, q)
            self.net.connect(q, pod.pid)
        return pod.pid

    def leave(self, pid: int, graceful: bool = True) -> None:
        self.pods[pid].alive = False
        if graceful:
            self.net.depart(pid)
        else:
            self.net.crash(pid)          # silent: Algorithm 3 cleans up

    # ---------------- main loop ---------------------------------------- #
    def run_rounds(self, n_rounds: int,
                   churn: Optional[Callable[[int, "CausalGossipTrainer"],
                                            None]] = None,
                   stragglers: Optional[Dict[int, int]] = None):
        """``stragglers`` maps pid -> period: that pod only completes a
        round every ``period`` rounds.  Dissemination is non-blocking
        causal broadcast, so nobody waits: the straggler contributes
        updates less often."""
        stragglers = stragglers or {}
        for r in range(n_rounds):
            for pod in list(self.pods.values()):
                if not pod.alive:
                    continue
                period = stragglers.get(pod.pid, 1)
                if period > 1 and r % period:
                    continue                    # straggler sits this one out
                _, delta = pod.local_round()
                pod.publish(delta)
                # interleave protocol traffic with compute
                self.net.run(until=self.net.time + self.cfg.round_time / 4)
            if churn is not None:
                churn(r, self)
            self.net.run(until=self.net.time + self.cfg.round_time)
        self.net.run(until=self.net.time + 100 * self.cfg.round_time)

    # ---------------- diagnostics --------------------------------------- #
    def mean_loss(self, last: int = 1) -> float:
        vals = [np.mean(p.losses[-last:]) for p in self.pods.values()
                if p.alive and p.losses]
        return float(np.mean(vals))

    def replica_drift(self) -> float:
        """Max relative parameter L2 distance between live replicas."""
        live = [p for p in self.pods.values() if p.alive]
        if len(live) < 2:
            return 0.0
        flats = [torch.cat([x.detach().double().reshape(-1)
                            for x in p.params.values()]) for p in live]
        ref = flats[0]
        return float(max(torch.linalg.vector_norm(f - ref)
                         / (torch.linalg.vector_norm(ref) + 1e-9)
                         for f in flats[1:]))

    def causal_report(self):
        crashed = {p.pid for p in self.pods.values() if not p.alive}
        return check_trace(self.net.trace, crashed=crashed,
                           check_agreement=False)
