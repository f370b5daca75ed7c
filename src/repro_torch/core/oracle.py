"""Happens-before oracle: checks broadcast properties from an event trace
(the port's copy of the JAX package's ``repro.core.oracle``).

The oracle is protocol-agnostic and assumes nothing about the protocol's
correctness: the causal past of a broadcast m' is rebuilt transitively from
the global trace (everything its broadcaster had *delivered* when it
broadcast m', closed under those messages' own pasts).  From it we check:

  * causal order  (Definition 6): if C delivers m and m' with
    b(m) -> b(m'), then C delivered m first;
  * uniform integrity: at most one delivery of each message per process;
  * validity: a correct broadcaster delivers its own messages;
  * uniform agreement (quiescent): once the network is idle, all correct
    processes delivered the same set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Set, Tuple

from .base import msg_id

__all__ = ["OracleReport", "check_trace"]

MsgId = Tuple[int, int]


@dataclass
class OracleReport:
    causal_violations: List[Tuple[int, MsgId, MsgId]] = field(default_factory=list)
    double_deliveries: List[Tuple[int, MsgId]] = field(default_factory=list)
    validity_violations: List[MsgId] = field(default_factory=list)
    agreement_violations: List[Tuple[int, MsgId]] = field(default_factory=list)
    n_broadcasts: int = 0
    n_deliveries: int = 0

    @property
    def causal_ok(self) -> bool:
        return not self.causal_violations

    @property
    def ok(self) -> bool:
        return (not self.causal_violations and not self.double_deliveries
                and not self.validity_violations and not self.agreement_violations)

    def summary(self) -> str:
        return (f"broadcasts={self.n_broadcasts} deliveries={self.n_deliveries} "
                f"causal_violations={len(self.causal_violations)} "
                f"double={len(self.double_deliveries)} "
                f"validity={len(self.validity_violations)} "
                f"agreement={len(self.agreement_violations)}")


def check_trace(trace, crashed: Set[int] = frozenset(),
                check_agreement: bool = True,
                all_pids: Set[int] | None = None) -> OracleReport:
    """Validate a ``Network.trace`` against the broadcast specification.

    ``crashed`` — pids exempt from validity/agreement (faulty processes).
    ``check_agreement`` — only meaningful on a quiescent (idle) network.
    ``all_pids`` — full membership; without it, agreement is checked only
    over processes that delivered at least one message.
    """
    rep = OracleReport()
    past: Dict[MsgId, FrozenSet[MsgId]] = {}
    delivered_at: Dict[int, Dict[MsgId, int]] = {}   # pid -> id -> order index
    delivered_seq: Dict[int, List[MsgId]] = {}       # pid -> delivery order
    broadcaster: Dict[MsgId, int] = {}

    for (_, kind, pid, data) in trace:
        if kind == "broadcast":
            mid = msg_id(data)
            rep.n_broadcasts += 1
            broadcaster[mid] = pid
            # Transitive causal past: everything pid delivered so far, closed
            # under those messages' pasts (computed at *their* broadcast).
            direct = list(delivered_at.get(pid, ()))
            closure: Set[MsgId] = set(direct)
            for d in direct:
                closure |= past.get(d, frozenset())
            past[mid] = frozenset(closure)
        elif kind == "deliver":
            mid = msg_id(data)
            rep.n_deliveries += 1
            seen = delivered_at.setdefault(pid, {})
            if mid in seen:
                rep.double_deliveries.append((pid, mid))
                continue
            seen[mid] = len(seen)
            delivered_seq.setdefault(pid, []).append(mid)

    # Causal order: every message in past(m') delivered before m' (if ever).
    for pid, seq in delivered_seq.items():
        index = delivered_at[pid]
        for mid in seq:
            i = index[mid]
            for dep in past.get(mid, frozenset()):
                j = index.get(dep)
                if j is not None and j > i:
                    rep.causal_violations.append((pid, dep, mid))

    # Validity: correct broadcasters deliver their own messages.
    for mid, src in broadcaster.items():
        if src in crashed:
            continue
        if mid not in delivered_at.get(src, {}):
            rep.validity_violations.append(mid)

    # Uniform agreement (quiescent check): any message delivered anywhere
    # must be delivered by every correct process.
    if check_agreement:
        all_delivered: Set[MsgId] = set()
        for pid, seen in delivered_at.items():
            all_delivered |= set(seen)
        members = set(all_pids) if all_pids is not None else (
            delivered_at.keys() | {broadcaster[m] for m in broadcaster})
        for pid in members:
            if pid in crashed:
                continue
            seen = delivered_at.get(pid, {})
            for mid in all_delivered:
                if mid not in seen:
                    rep.agreement_violations.append((pid, mid))
    return rep
