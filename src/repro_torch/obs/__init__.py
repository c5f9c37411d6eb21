"""Telemetry: the metrics registry and the span tracer (mirrors the
part of ``repro.obs`` the port has so far; EXPLAIN ANALYZE and the
stats feedback loop come with the serving slice)."""

from .metrics import (CounterView, Histogram, MetricsRegistry,  # noqa: F401
                      MetricsScope, REGISTRY, metrics_scope,
                      reset_all_metrics)
from .trace import TRACER, Span, Tracer, span, tracing  # noqa: F401

__all__ = [
    "CounterView", "Histogram", "MetricsRegistry", "MetricsScope",
    "REGISTRY", "metrics_scope", "reset_all_metrics",
    "TRACER", "Span", "Tracer", "span", "tracing", "reset_telemetry",
]


def reset_telemetry() -> None:
    """Registry + tracer reset in one call (the pytest fixture hook)."""
    reset_all_metrics()
    TRACER.reset()
