"""Unified telemetry (PyTorch twin of ``repro.obs``): metrics registry,
span tracer, EXPLAIN ANALYZE, and the observed-stats feedback loop.

``explain_analyze`` / ``StatsFeedback`` are exposed lazily: the engine
modules (``exec.ops``, ``core.plans``, ...) import
``repro_torch.obs.metrics`` at load time, and an eager import of
``obs.explain`` here would close an import cycle back into
``core.plans``.
"""

from .metrics import (CounterView, Histogram, MetricsRegistry,  # noqa: F401
                      MetricsScope, REGISTRY, metrics_scope,
                      reset_all_metrics)
from .trace import TRACER, Span, Tracer, span, tracing  # noqa: F401

__all__ = [
    "CounterView", "Histogram", "MetricsRegistry", "MetricsScope",
    "REGISTRY", "metrics_scope", "reset_all_metrics",
    "TRACER", "Span", "Tracer", "span", "tracing",
    "explain_analyze", "ExplainResult", "StatsFeedback",
    "record_observed_stats", "reset_telemetry",
]


def reset_telemetry() -> None:
    """Registry + tracer reset in one call (the pytest fixture hook)."""
    reset_all_metrics()
    TRACER.reset()


def __getattr__(name):
    if name in ("explain_analyze", "ExplainResult", "ExplainNode"):
        from . import explain
        return getattr(explain, name)
    if name in ("StatsFeedback", "record_observed_stats"):
        from . import feedback
        return getattr(feedback, name)
    raise AttributeError(name)
