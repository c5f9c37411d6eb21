"""Unified metrics registry — the single store behind every host-side
counter in the engine.

The five process-global dicts that grew organically across PRs 1-8
(``exec.ops.SORT_STATS``, ``exec.dist.SHUFFLE_STATS``,
``storage.reader.STORAGE_STATS``, ``core.plans.EVAL_STATS``,
``core.codegen.TRACE_STATS``) are now thin :class:`CounterView` windows
onto one :class:`MetricsRegistry`, namespaced by domain
(``sort.key_reuse``, ``shuffle.collectives``, ``storage.bytes_read``,
``eval.join``, ``trace.traces``). The views keep every historical call
site working — item get/set, ``.get``, ``.clear()``, ``dict(view)``,
iteration — while new code talks to the registry directly.

Three metric kinds:

* **counters** — monotonically incremented numbers (``inc``). All the
  legacy trace-time accounting lives here.
* **gauges** — last-write-wins numbers (``set_gauge``); adaptive sizing
  writes ``shuffle.size_used_<site>`` this way.
* **histograms** — log-bucketed latency distributions (``observe``)
  with p50/p95/p99 readout (``percentile`` / ``percentiles``). Buckets
  grow geometrically by ``2**0.125`` (~9% wide), so any percentile is
  within ~4.4% relative error of the exact order statistic — asserted
  against the NumPy reference in ``tests/test_obs.py``.

Counters and gauges share one value namespace (a gauge is just a
counter that is assigned instead of incremented); histograms live in
their own namespace.

Scoping: ``metrics_scope()`` snapshots the value store on entry and
exposes the **delta** accumulated inside the ``with`` block. Scopes
nest arbitrarily (each keeps its own baseline) — ``explain_analyze``
uses one per plan operator, and the pytest autouse fixture resets the
whole registry between tests so per-site ``shuffle.size_used_<n>``
keys can no longer leak across runs with different mesh sizes.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

_HIST_GAMMA = 2.0 ** 0.125           # bucket growth; rel. err <= ~4.4%
_LOG_GAMMA = math.log(_HIST_GAMMA)



_HOST = threading.local()


def host_recording() -> bool:
    """Whether this thread records host-side telemetry: counters,
    gauges, histograms, spans and fault-site calls. Always true outside
    the virtual mesh (``exec.dist``). Its sites run on threads of their
    own, where only site 0 of a compile attempt records, since the
    reference records these once, when it traces the per-partition
    code for all devices; a warm call records nothing, as a warm jitted
    call does not trace."""
    return getattr(_HOST, "on", True)


@contextmanager
def host_recording_as(on: bool):
    """Set this thread's ``host_recording()`` inside the block."""
    prev = getattr(_HOST, "on", True)
    _HOST.on = bool(on)
    try:
        yield
    finally:
        _HOST.on = prev


class Histogram:
    """Log-bucketed histogram for non-negative samples (latencies)."""

    __slots__ = ("count", "total", "min", "max", "zero", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.zero = 0                    # samples <= 0
        self.buckets: Dict[int, int] = {}

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0.0:
            self.zero += 1
            return
        idx = int(math.floor(math.log(v) / _LOG_GAMMA))
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (0..100); NaN when empty."""
        if self.count == 0:
            return math.nan
        rank = (q / 100.0) * (self.count - 1)
        seen = self.zero
        if rank < seen:                  # inside the zero bucket
            return max(self.min, 0.0) if self.min <= 0 else 0.0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank < seen:
                lo = _HIST_GAMMA ** idx
                hi = lo * _HIST_GAMMA
                mid = math.sqrt(lo * hi)      # geometric midpoint
                return min(max(mid, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.min if self.count else math.nan,
                "max": self.max if self.count else math.nan,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Counters + gauges + histograms under dotted ``domain.name`` keys."""

    def __init__(self):
        self._values: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- counters / gauges ------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        if host_recording():
            self._values[name] = self._values.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        if host_recording():
            self._values[name] = value

    def get(self, name: str, default=0):
        return self._values.get(name, default)

    # -- histograms -------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        if not host_recording():
            return
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        h.observe(value)

    def histogram(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)

    def percentile(self, name: str, q: float) -> float:
        h = self._hists.get(name)
        return h.percentile(q) if h is not None else math.nan

    def percentiles(self, name: str,
                    qs: Tuple[float, ...] = (50, 95, 99)) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(name, q) for q in qs}

    # -- namespace plumbing ----------------------------------------------
    def view(self, domain: str) -> "CounterView":
        return CounterView(self, domain)

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        """Copy of the value store (optionally one ``prefix.`` domain)."""
        if not prefix:
            return dict(self._values)
        pre = prefix if prefix.endswith(".") else prefix + "."
        return {k: v for k, v in self._values.items() if k.startswith(pre)}

    def reset(self, prefix: str = "") -> None:
        if not prefix:
            self._values.clear()
            self._hists.clear()
            return
        pre = prefix if prefix.endswith(".") else prefix + "."
        for k in [k for k in self._values if k.startswith(pre)]:
            del self._values[k]
        for k in [k for k in self._hists if k.startswith(pre)]:
            del self._hists[k]

    # -- scopes -----------------------------------------------------------
    @contextmanager
    def scope(self):
        yield MetricsScope(self)


class MetricsScope:
    """Delta view since construction; nest freely (own baseline each)."""

    def __init__(self, registry: MetricsRegistry):
        self._reg = registry
        self._base = dict(registry._values)

    def counters(self, prefix: str = "") -> Dict[str, float]:
        """Keys whose value changed inside the scope, as deltas."""
        pre = (prefix if prefix.endswith(".") else prefix + ".") \
            if prefix else ""
        out = {}
        for k, v in self._reg._values.items():
            if pre and not k.startswith(pre):
                continue
            d = v - self._base.get(k, 0)
            if d:
                out[k] = d
        return out

    def get(self, name: str, default=0):
        now = self._reg._values.get(name)
        then = self._base.get(name)
        if now is None and then is None:
            return default
        return (now or 0) - (then or 0)


class CounterView:
    """Dict-shaped window onto one registry domain (backward compat for
    the legacy ``*_STATS`` globals). Supports exactly the operations the
    historical call sites use: item get/set, ``get``, ``clear``,
    ``items``/``keys``/``values``, iteration, ``len``, membership, and
    ``dict(view)``."""

    __slots__ = ("_reg", "_domain", "_pre")

    def __init__(self, registry: MetricsRegistry, domain: str):
        self._reg = registry
        self._domain = domain
        self._pre = domain + "."

    # mapping protocol ----------------------------------------------------
    def __getitem__(self, key: str):
        full = self._pre + key
        if full not in self._reg._values:
            raise KeyError(key)
        return self._reg._values[full]

    def __setitem__(self, key: str, value) -> None:
        if host_recording():
            self._reg._values[self._pre + key] = value

    def __delitem__(self, key: str) -> None:
        del self._reg._values[self._pre + key]

    def __contains__(self, key: str) -> bool:
        return self._pre + key in self._reg._values

    def __iter__(self) -> Iterator[str]:
        n = len(self._pre)
        return (k[n:] for k in list(self._reg._values)
                if k.startswith(self._pre))

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def get(self, key: str, default=None):
        return self._reg._values.get(self._pre + key, default)

    def keys(self):
        return list(self)

    def values(self):
        return [self._reg._values[self._pre + k] for k in self]

    def items(self):
        return [(k, self._reg._values[self._pre + k]) for k in self]

    def clear(self) -> None:
        self._reg.reset(self._domain)

    def update(self, other) -> None:
        for k, v in dict(other).items():
            self[k] = v

    def __eq__(self, other) -> bool:
        return dict(self.items()) == dict(other)

    def __repr__(self) -> str:
        return f"CounterView({self._domain!r}, {dict(self.items())!r})"


# ---------------------------------------------------------------------------
# the process-wide registry (engine counters) + module-level helpers
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()


@contextmanager
def metrics_scope(registry: Optional[MetricsRegistry] = None):
    """Snapshot-scoped delta window over ``registry`` (default: the
    process registry). Nestable; see :class:`MetricsScope`."""
    with (registry or REGISTRY).scope() as s:
        yield s


def reset_all_metrics() -> None:
    """Wipe the process registry (every domain + histogram). The pytest
    autouse fixture calls this between tests; the tracer is reset
    separately (``obs.trace.TRACER.reset()``)."""
    REGISTRY.reset()
