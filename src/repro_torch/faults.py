"""Deterministic seeded fault-injection registry (DESIGN.md "Fault
model and recovery"; public serving API re-exported via
``repro.serve.faults``).

Every external edge of the engine declares a *site* — a stable string
naming the operation that can fail — and consults the global ``FAULTS``
registry on each call:

    storage.footer      read_footer                (corrupt)
    storage.chunk       StoredPart.load, per chunk (missing/torn/corrupt)
    dist.exchange       DistContext.exchange       (fail)
    codegen.compile     jit_program / dist compile (fail/delay)
    dist.imbalance      ServingRuntime metrics     (inflate)
    serve.cache_evict   ServingRuntime dispatch    (evict)

A *rule* armed on a site fires on a deterministic window of that site's
call sequence (``first``..``first+count-1``), optionally thinned by a
seeded Bernoulli draw (``p``) — so a chaos schedule replays identically
under one seed, and every recovery path can be pinned to exactly the
call that should exercise it. The registry is process-global and OFF by
default: with no armed rules every ``hit()`` is a single dict lookup,
so production paths pay nothing.

Sites never interpret a fault themselves beyond their own flavor
vocabulary (``kind``): the *site* decides what "torn" means for a chunk
array, the *registry* only decides when it happens. Fired faults are
recorded in ``FAULTS.fired`` / ``FAULTS.stats`` for test and benchmark
assertions ("the schedule injected >= 1 of each class").
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

import numpy as np

from .obs.metrics import host_recording


@dataclass
class FaultRule:
    """One armed fault: fire ``kind`` at ``site`` on call indices
    ``first .. first+count-1`` (count < 0 = forever), each eligible call
    passing an independent seeded coin with probability ``p``.
    ``match`` filters on the site's keyword info (equality per key);
    ``arg`` is the site-specific payload (delay seconds, inflation
    factor, truncation fraction...)."""
    site: str
    kind: str
    first: int = 0
    count: int = 1
    p: float = 1.0
    arg: object = None
    match: Dict[str, object] = dc_field(default_factory=dict)
    fired: int = 0

    def eligible(self, call_idx: int, info: Dict[str, object]) -> bool:
        if call_idx < self.first:
            return False
        if self.count >= 0 and call_idx >= self.first + self.count:
            return False
        return all(info.get(k) == v for k, v in self.match.items())


class FaultRegistry:
    """Seeded, deterministic, process-global (see module docstring)."""

    def __init__(self, seed: int = 0):
        self.reset(seed)

    def reset(self, seed: int = 0) -> None:
        """Clear every rule, counter and record; reseed the coin."""
        self.rules: List[FaultRule] = []
        self.calls: Dict[str, int] = {}
        self.fired: List[tuple] = []        # (site, kind, call_idx, info)
        self.stats: Dict[str, int] = {}
        self._rng = np.random.RandomState(seed)

    @property
    def enabled(self) -> bool:
        return bool(self.rules)

    def arm(self, site: str, kind: str, first: int = 0, count: int = 1,
            p: float = 1.0, arg: object = None, **match) -> FaultRule:
        """Arm one rule; returns it (its ``fired`` counter is live)."""
        rule = FaultRule(site=site, kind=kind, first=first, count=count,
                         p=p, arg=arg, match=dict(match))
        self.rules.append(rule)
        return rule

    def disarm(self, site: Optional[str] = None) -> None:
        """Drop rules for ``site`` (None = all) without touching call
        counters or the fired record."""
        self.rules = [] if site is None else \
            [r for r in self.rules if r.site != site]

    def hit(self, site: str, **info) -> Optional[FaultRule]:
        """Count one call of ``site`` and return the first rule that
        fires on it (None = proceed normally). Call order is the only
        clock, so a fixed schedule + seed replays identically; while NO
        rules are armed, calls are not even counted — site indices
        start from the moment a schedule is armed. A thread that does not
        record host telemetry (a site of the virtual mesh other than
        site 0, see ``obs.metrics.host_recording``) consults nothing, so
        a site is called once per run, as at the reference's single
        trace."""
        if not self.rules or not host_recording():
            return None
        idx = self.calls.get(site, 0)
        self.calls[site] = idx + 1
        for rule in self.rules:
            if rule.site != site or not rule.eligible(idx, info):
                continue
            if rule.p < 1.0 and self._rng.rand() >= rule.p:
                continue
            rule.fired += 1
            key = f"{site}:{rule.kind}"
            self.stats[key] = self.stats.get(key, 0) + 1
            self.fired.append((site, rule.kind, idx, dict(info)))
            return rule
        return None


FAULTS = FaultRegistry()
"""The process-global registry every instrumented site consults."""
