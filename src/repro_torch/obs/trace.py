"""Span-based query profiler — host-side wall-clock trace trees.

``span("exchange", keys=...)`` opens a nested span on the process
tracer; spans close LIFO (context managers), building per-query trace
trees exportable as JSON in two shapes: a nested tree
(``TRACER.tree()``) and the Chrome trace-event format
(``TRACER.chrome_trace()`` — load the file at ``chrome://tracing`` or
https://ui.perfetto.dev).

Design constraints (the zero-retrace contract):

* **Near-zero overhead when disabled.** ``span()`` checks one boolean
  and returns a shared no-op context manager; nothing allocates. The
  disabled-mode cost is gated in ``make obs-smoke``.
* **Host-side timing only, never device timing inside traced code.**
  Spans manipulate plain Python objects, so a span around a
  ``DistContext.exchange`` is transparent to jax tracing: it measures
  *trace-time* (recorded with ``unit="trace"``), fires once per
  (re)compile, and warm jitted calls are untouched — enabling the
  tracer between calls can therefore never trigger a retrace, which
  ``tests/test_obs.py`` asserts differentially (bit-identical output,
  ``trace.traces`` flat).
* **No traced values in attributes.** Call sites pass only static
  Python values (names, key tuples, sites); a jax tracer stored in an
  attr would leak out of the trace.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import List, Optional

from .metrics import host_recording


class Span:
    __slots__ = ("name", "attrs", "t0", "dur", "children")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs = attrs or {}
        self.t0 = time.perf_counter()
        self.dur: Optional[float] = None        # seconds; None = open
        self.children: List["Span"] = []

    def close(self) -> None:
        self.dur = time.perf_counter() - self.t0

    def tree(self) -> dict:
        return {"name": self.name,
                "ms": round((self.dur or 0.0) * 1e3, 4),
                "attrs": _jsonable(self.attrs),
                "children": [c.tree() for c in self.children]}

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def _jsonable(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (tuple, list)):
            out[k] = [x if isinstance(x, (str, int, float, bool))
                      else str(x) for x in v]
        else:
            out[k] = str(v)
    return out


class Tracer:
    """Process tracer: a stack of open spans + the finished roots."""

    def __init__(self):
        self.enabled = False
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self._epoch = time.perf_counter()

    # -- control ----------------------------------------------------------
    def enable(self, on: bool = True) -> None:
        self.enabled = on

    def reset(self) -> None:
        self.roots = []
        self._stack = []
        self._epoch = time.perf_counter()

    # -- recording --------------------------------------------------------
    def push(self, name: str, attrs: dict) -> Span:
        sp = Span(name, attrs)
        if self._stack:
            self._stack[-1].children.append(sp)
        else:
            self.roots.append(sp)
        self._stack.append(sp)
        return sp

    def pop(self, sp: Span) -> None:
        sp.close()
        # tolerate an unbalanced pop (an exception may unwind through
        # several spans); close everything above sp on the stack
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break
            if top.dur is None:
                top.close()

    # -- export -----------------------------------------------------------
    def tree(self) -> List[dict]:
        return [r.tree() for r in self.roots]

    def spans(self) -> List[Span]:
        out: List[Span] = []
        for r in self.roots:
            out.extend(r.walk())
        return out

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans()]

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans() if s.name == name]

    def chrome_trace(self) -> List[dict]:
        """Chrome trace-event JSON (``ph: "X"`` complete events; ``ts``
        and ``dur`` in microseconds relative to the tracer epoch)."""
        events = []
        for sp in self.spans():
            events.append({
                "name": sp.name, "ph": "X", "pid": 0, "tid": 0,
                "ts": round((sp.t0 - self._epoch) * 1e6, 1),
                "dur": round((sp.dur or 0.0) * 1e6, 1),
                "args": _jsonable(sp.attrs)})
        return events

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_trace(),
                       "tree": self.tree()}, f, indent=1)
        return path


TRACER = Tracer()


class _SpanCtx:
    __slots__ = ("_name", "_attrs", "_span")

    def __init__(self, name: str, attrs: dict):
        self._name = name
        self._attrs = attrs
        self._span = None

    def __enter__(self) -> Span:
        self._span = TRACER.push(self._name, self._attrs)
        return self._span

    def __exit__(self, *exc) -> bool:
        TRACER.pop(self._span)
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @property
    def attrs(self) -> dict:                  # writable sink, discarded
        return {}


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open a span on the process tracer (no-op when disabled, and on a
    thread that does not record: see ``metrics.host_recording``)."""
    if not TRACER.enabled or not host_recording():
        return _NOOP
    return _SpanCtx(name, attrs)


@contextmanager
def tracing(enabled: bool = True, reset: bool = False):
    """Scoped tracer toggle (mirrors ``exec.ops.order_awareness``)."""
    prev = TRACER.enabled
    if reset:
        TRACER.reset()
    TRACER.enabled = enabled
    try:
        yield TRACER
    finally:
        TRACER.enabled = prev
