"""Typed exception hierarchy for the serving/storage/compile stack
(DESIGN.md "Fault model and recovery").

Every external edge of the engine — disk, compile, collective dispatch,
admission — raises a subclass of ``ReproError``, so callers (most
importantly ``serve.runtime.ServingRuntime``) implement *policy by
type*: retry transients, degrade around storage and distribution
faults, shed on admission pressure, and surface everything else as a
single-query failure instead of a server crash.

``transient`` is the retry contract: an exception class with
``transient = True`` models a fault that is expected to clear on its
own (an injected executor hiccup, a cold-compile storm, an
adaptive-capacity overflow that a re-warm resolves) and is safe to
retry with backoff. Non-transient errors are deterministic — retrying
the same call reproduces them — so the runtime moves down the
degradation ladder instead.
"""

from __future__ import annotations


class ReproError(Exception):
    """Root of the engine's typed errors."""
    transient = False


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

class StorageError(ReproError):
    """Any fault on the disk edge (footer, chunk files, encoders)."""


class FooterError(StorageError):
    """Dataset footer missing, unreadable, or structurally invalid."""


class ChunkCorruptionError(StorageError):
    """A chunk file's content disagrees with the footer: torn/truncated
    write, checksum mismatch, or row-count mismatch. Raised by
    ``StoredPart.load`` (checksums only under ``verify=True``)."""


class MissingChunkError(StorageError):
    """A chunk file named by the footer does not exist on disk."""


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

class CompileError(ReproError):
    """Plan compilation / jit construction failed. Transient: the
    canonical instances are injected compile faults and resource-bound
    cold-compile storms, which clear on retry."""
    transient = True


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

class ExecError(ReproError):
    """Fault while executing a compiled program."""


class StreamingUnsupportedError(ExecError):
    """The program/dataset pair cannot stream morsels soundly: an
    aggregate sits below another operator over streamed rows (partial
    results would not re-fold), or a streamed part's label columns are
    not monotone parent rids (morsel windows could split a parent from
    its children). Deterministic — the caller should fall back to the
    one-shot ``execute_stored`` path."""


class ExchangeError(ExecError):
    """A distributed exchange / collective failed. Transient at the
    single-attempt level; the serving runtime additionally degrades to
    the single-device path when retries keep failing."""
    transient = True


class CapacityOverflowError(ExecError):
    """A warm rebind pushed rows past capacities resolved by the
    adaptive warmup (e.g. a shrunken heavy-key set re-routing a hot key
    through an exchange bucket sized without it). Transient by
    re-warming: evict the plan-cache entry and recompile with the new
    binding."""
    transient = True


# ---------------------------------------------------------------------------
# admission / serving
# ---------------------------------------------------------------------------

class AdmissionError(ReproError):
    """The serving layer refused the request before execution."""


class ShedError(AdmissionError):
    """Load shedding: queue depth, per-tenant quota, or in-flight
    compile budget exceeded. The caller may retry later; the server
    sheds instead of queueing unboundedly."""


class CircuitOpenError(AdmissionError):
    """The plan family's circuit breaker is open after repeated
    failures; requests fail fast until the cooldown elapses."""


class DeadlineExceeded(ReproError):
    """The request's deadline elapsed before an attempt could finish
    (checked before each attempt and before each backoff sleep)."""
