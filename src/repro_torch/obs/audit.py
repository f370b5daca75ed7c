"""Online causality auditor: a protocol-level race detector (the port's
copy of the JAX package's ``repro.obs.audit``).

Consumes completed flight-recorder records *during* execution (every
retirement sweep: per segment in batch mode, per tick live) and checks
that no receiver delivered two causally ordered sampled messages out of
order.  Two happens-before edge families are checked (DESIGN §2.11):

  same-origin     a, b from one origin with a.bcast < b.bcast
                  (FIFO order implies causal order at the sender)
  deliv-before-bcast
                  a delivered at b's origin strictly before b was
                  broadcast (a potentially caused b)

Both edges are *sound* — they are genuine happens-before relations, so
any flagged inversion is a real causal-delivery violation, never a
false positive.  They are not complete: transitive chains through
unsampled messages are invisible by construction (O(sample) state), so
a clean audit is strong evidence, not proof.  The exact-engine
crossval remains the completeness check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

__all__ = [
    "AUDIT_MODES", "AuditMode", "CausalAuditor",
    "CausalityViolationError", "Violation",
]


@dataclass(frozen=True)
class AuditMode:
    """A named auditing policy (``--list`` discoverable)."""
    key: str
    fail_fast: bool
    description: str


AUDIT_MODES: Dict[str, AuditMode] = {
    "off": AuditMode(
        "off", False, "no causality auditing (default)"),
    "log": AuditMode(
        "log", False, "check sampled happens-before pairs; record "
        "violations and keep running"),
    "fail": AuditMode(
        "fail", True, "check sampled happens-before pairs; raise "
        "CausalityViolationError on the first violation"),
}


@dataclass(frozen=True)
class Violation:
    """One receiver delivered a happens-before pair out of order."""
    a_id: int          # the earlier message (a -> b)
    b_id: int
    edge: str          # "same-origin" | "deliv-before-bcast"
    receiver: int
    a_deliv: int       # receiver's delivery rounds: a_deliv > b_deliv
    b_deliv: int

    def to_dict(self) -> dict:
        return dict(a_id=self.a_id, b_id=self.b_id, edge=self.edge,
                    receiver=self.receiver, a_deliv=self.a_deliv,
                    b_deliv=self.b_deliv)


class CausalityViolationError(RuntimeError):
    """Fail-fast audit tripped: carries the first ``Violation``."""

    def __init__(self, violation: Violation):
        self.violation = violation
        super().__init__(
            f"causal delivery violated ({violation.edge}): receiver "
            f"{violation.receiver} delivered msg {violation.a_id} at "
            f"round {violation.a_deliv} but its successor msg "
            f"{violation.b_id} already at round {violation.b_deliv}")


class CausalAuditor:
    """Incremental pairwise checker over completed flight records.

    ``observe`` is O(completed) per record — fine at sampling rates the
    flight recorder is built for; the ops plane surfaces
    ``pairs_checked`` so runaway quadratic cost is visible.
    """

    def __init__(self, mode: str = "log", max_violations: int = 1024):
        if mode not in AUDIT_MODES or mode == "off":
            raise KeyError(
                f"auditor mode must be one of "
                f"{sorted(k for k in AUDIT_MODES if k != 'off')}, "
                f"got {mode!r}")
        self.mode = mode
        self.fail_fast = AUDIT_MODES[mode].fail_fast
        self.max_violations = int(max_violations)
        self.records: List = []
        self._by_origin: Dict[int, List] = {}
        self.pairs_checked = 0
        self.violations: List[Violation] = []

    def observe(self, rec) -> None:
        """Audit one newly completed record against all earlier ones."""
        mine = self._by_origin.setdefault(rec.origin, [])
        for prev in mine:
            if prev.bcast_round == rec.bcast_round:
                continue    # one broadcast per (origin, round) invariant
            a, b = ((prev, rec) if prev.bcast_round < rec.bcast_round
                    else (rec, prev))
            self._check(a, b, "same-origin")
        for prev in self.records:
            if prev.origin == rec.origin:
                continue
            # prev delivered at rec's origin before rec was broadcast:
            # prev potentially caused rec (prev -> rec)
            da = int(prev.deliv[rec.origin])
            if 0 <= da < rec.bcast_round:
                self._check(prev, rec, "deliv-before-bcast")
            db = int(rec.deliv[prev.origin])
            if 0 <= db < prev.bcast_round:
                self._check(rec, prev, "deliv-before-bcast")
        mine.append(rec)
        self.records.append(rec)

    def _check(self, a, b, edge: str) -> None:
        """a -> b: no receiver that delivered both may order them
        b-first."""
        self.pairs_checked += 1
        da, db = a.deliv, b.deliv
        bad = np.nonzero((da >= 0) & (db >= 0) & (da > db))[0]
        for p in bad:
            v = Violation(int(a.id), int(b.id), edge, int(p),
                          int(da[p]), int(db[p]))
            if len(self.violations) < self.max_violations:
                self.violations.append(v)
            if self.fail_fast:
                raise CausalityViolationError(v)

    def export(self) -> List[dict]:
        return [v.to_dict() for v in self.violations]
