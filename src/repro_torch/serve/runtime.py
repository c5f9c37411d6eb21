"""ServingRuntime — the fault-tolerant serving tier over QueryService
(PyTorch twin of ``repro.serve.runtime``; DESIGN.md "Fault model and
recovery").

The query service (plan cache, parameter rebinding, batched execution)
assumes every chunk loads, every collective completes and every compile
finishes; this layer assumes none of that. Around each request it puts:

* **admission control** — per-tenant token-bucket quotas, a queue-depth
  bound, and a cold-compile budget per batch window. Refused requests
  get a typed ``ShedError`` response immediately (the server sheds, it
  never queues unboundedly); a plan family that keeps failing trips a
  per-family circuit breaker (``CircuitOpenError`` until cooldown).
* **deadlines and retries** — transient faults (injected compile or
  exchange failures, adaptive-capacity overflows) retry under
  exponential backoff with seeded jitter; the request's deadline is
  checked before every attempt and bounds every backoff sleep.
* **graceful degradation** — recovery is policy-by-exception-type:
  a ``CapacityOverflowError`` evicts the stale entry and re-warms; a
  chunk fault re-scans once with zone-map skipping disabled (pinned
  capacities keep the warm executable valid) and otherwise fails ONLY
  that query; repeated exchange failures or receive-load imbalance
  beyond threshold pin the family to a single-device twin service.
* **crash recovery** — every first compile of a family appends to a
  JSON manifest (atomic write+rename) carrying the pickled program,
  the schema/capacity-class shape and the skew-hint shape;
  ``warm_replay()`` on a fresh process re-executes each entry against a
  synthetic all-invalid environment of exactly the recorded shapes and
  dtypes, on the runtime's device, so real traffic after a restart
  rebuilds no plan (``codegen.TRACE_STATS`` stays flat).

Everything is synchronous and deterministic: the clock, the sleep and
the jitter RNG are injectable, so tests drive the deadline/backoff
machinery on a virtual clock and chaos schedules replay bit-for-bit.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import nrc as N
from repro_torch.columnar.table import FlatBag, resolve_device
from repro_torch.errors import (CapacityOverflowError, CircuitOpenError,
                                DeadlineExceeded, ExchangeError, FooterError,
                                ReproError, ShedError, StorageError)
from repro_torch.faults import FAULTS
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import span as _span

from .query_service import QueryService


# ---------------------------------------------------------------------------
# request / response
# ---------------------------------------------------------------------------

@dataclass
class QueryRequest:
    """One serving request. ``env`` is an in-memory environment of
    FlatBags or a ``storage.StoredDataset``; ``deadline`` is a budget
    in seconds from submission (None = the runtime default)."""
    program: N.Program
    env: object
    tenant: str = "default"
    deadline: Optional[float] = None
    skew_hints: Optional[dict] = None


@dataclass
class QueryResponse:
    """What ``submit`` ALWAYS returns — a request outcome is a value,
    never an escaped exception (that would be a server crash)."""
    ok: bool
    outputs: Optional[dict] = None
    error: Optional[BaseException] = None
    shed: bool = False
    retries: int = 0
    degraded: Tuple[str, ...] = ()
    family: Optional[tuple] = None
    elapsed: float = 0.0


# ---------------------------------------------------------------------------
# admission primitives
# ---------------------------------------------------------------------------

class TokenBucket:
    """Per-tenant quota: ``rate`` tokens/second up to ``burst``."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float]):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.clock = clock
        self._t: Optional[float] = None

    def take(self, n: float = 1.0) -> bool:
        now = self.clock()
        if self._t is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class CircuitBreaker:
    """Per-family breaker: ``threshold`` consecutive failures open it
    for ``cooldown`` seconds; the first call after cooldown is the
    half-open probe (success closes, failure re-opens)."""

    def __init__(self, threshold: int, cooldown: float,
                 clock: Callable[[], float]):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.clock = clock
        self.failures = 0
        self.opened_at: Optional[float] = None

    def allow(self) -> bool:
        if self.opened_at is None:
            return True
        return self.clock() - self.opened_at >= self.cooldown

    def record(self, ok: bool) -> None:
        if ok:
            self.failures = 0
            self.opened_at = None
            return
        self.failures += 1
        if self.failures >= self.threshold:
            self.opened_at = self.clock()


# ---------------------------------------------------------------------------
# crash-recoverable plan-cache manifest
# ---------------------------------------------------------------------------

class PlanCacheManifest:
    """Persistent record of every compiled plan family (DESIGN.md
    "Fault model and recovery": cache-manifest format). One JSON file,
    written atomically; each entry carries the pickled source program
    plus the SHAPE the family was compiled at — for in-memory families
    the (bag, capacity-class, column dtypes) schema, for stored
    families the dataset directory — and the skew-hint shape. That is
    exactly what ``ServingRuntime.warm_replay`` needs to reproduce the
    fingerprint and the compiled shapes in a fresh process; heavy-key
    and constant VALUES are runtime parameters and deliberately absent.
    A corrupt or missing manifest only costs cold compiles."""

    VERSION = 1

    def __init__(self, path: str):
        self.path = path
        self.entries: Dict[str, dict] = {}
        self.load()

    def load(self) -> None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError):
            self.entries = {}       # corrupt manifest == start cold
            return
        if doc.get("version") == self.VERSION:
            self.entries = {e["id"]: e for e in doc.get("entries", [])}

    def save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": self.VERSION,
                       "entries": list(self.entries.values())}, f)
        os.replace(tmp, self.path)

    def record(self, fid: str, kind: str, program: N.Program,
               **extra) -> bool:
        if fid in self.entries:
            return False
        self.entries[fid] = {
            "id": fid, "kind": kind,
            "program": base64.b64encode(pickle.dumps(program)
                                        ).decode("ascii"), **extra}
        return True

    @staticmethod
    def program(entry: dict) -> N.Program:
        return pickle.loads(base64.b64decode(entry["program"]))


def _family_id(key: tuple) -> str:
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


def _torch_dtype(name: str) -> torch.dtype:
    """The dtype a fingerprint recorded as ``str(dtype)``
    (``"torch.int64"``) back as a ``torch.dtype``."""
    dt = getattr(torch, name.rsplit(".", 1)[-1], None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype name: {name!r}")
    return dt


def _synthetic_env(schema, device=None) -> Dict[str, FlatBag]:
    """An all-invalid environment with exactly the recorded shapes:
    same bag names, capacities and dtypes as the original traffic, on
    ``device`` (None = the GPU), so replaying it builds the executable
    real requests will warm-hit."""
    dev = resolve_device(device)
    env = {}
    for name, cap, cols in schema:
        data = {col: torch.zeros(int(cap), dtype=_torch_dtype(dt),
                                 device=dev)
                for col, dt in cols}
        env[name] = FlatBag(data, torch.zeros(int(cap), dtype=torch.bool,
                                              device=dev))
    return env


def _synthetic_hints(shape) -> Optional[dict]:
    """Hint VALUES are runtime parameters; any value set with the
    recorded (bag, column) shape reproduces the fingerprint and the
    compiled plan structure."""
    hints: Dict[str, dict] = {}
    for bag, col in shape or ():
        hints.setdefault(bag, {})[col] = [0]
    return hints or None


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

class ServingRuntime:
    """Fault-tolerant front end over one ``QueryService`` (see module
    docstring). ``local_fallback`` is the single-device twin service
    used when the distributed path degrades; ``clock``/``sleep``/
    ``seed`` make every time- and jitter-dependent decision injectable
    and deterministic. ``device`` is where ``warm_replay`` builds its
    synthetic bags and reopens stored datasets (None: the service's
    mesh's device, else the GPU)."""

    def __init__(self, service: QueryService,
                 manifest_path: Optional[str] = None, *,
                 local_fallback: Optional[QueryService] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: int = 0,
                 max_queue: int = 64,
                 max_retries: int = 3,
                 backoff_base: float = 0.005,
                 backoff_cap: float = 0.5,
                 default_deadline: Optional[float] = None,
                 tenant_rate: float = float("inf"),
                 tenant_burst: float = float("inf"),
                 compile_budget: int = 8,
                 imbalance_threshold: float = 4.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 1.0,
                 verify_reads: bool = False,
                 device=None):
        self.service = service
        self.local_fallback = local_fallback
        self.clock = clock
        self.sleep = sleep
        self.max_queue = int(max_queue)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.default_deadline = default_deadline
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self.compile_budget = int(compile_budget)
        self.imbalance_threshold = float(imbalance_threshold)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown = float(breaker_cooldown)
        self.verify_reads = bool(verify_reads)
        if device is None and service.mesh is not None:
            device = service.mesh.device
        self.device = device
        self._rng = np.random.RandomState(seed)
        self._buckets: Dict[str, TokenBucket] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._degraded_families: set = set()
        self.manifest = PlanCacheManifest(manifest_path) \
            if manifest_path else None
        # counters live in a PER-RUNTIME registry (two runtimes in one
        # process — e.g. the chaos harness's primary + fallback — must
        # not share windows); ``stats`` is a dict-compatible view, so
        # every existing ``rt.stats["ok"]`` call site reads unchanged.
        # The same registry holds the end-to-end latency histogram
        # (``serve.latency_ms``) behind ``latency_percentiles()``.
        self.metrics = MetricsRegistry()
        self.stats = self.metrics.view("serve")
        self.stats.update({
            "submitted": 0, "ok": 0, "failed": 0, "retried": 0,
            "shed_quota": 0, "shed_queue": 0, "shed_compile": 0,
            "circuit_open": 0, "deadline_exceeded": 0,
            "degraded_no_skip": 0, "degraded_dist_local": 0,
            "degraded_imbalance": 0, "compiles": 0,
            "injected_evictions": 0, "batches": 0, "coalesced": 0,
            "replayed": 0, "replay_failed": 0, "backoff_s": 0.0})

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 of end-to-end ``submit``/``submit_many`` request
        latency (ms), from the runtime's own histogram."""
        ps = self.metrics.percentiles("serve.latency_ms")
        return {"p50_ms": ps["p50"], "p95_ms": ps["p95"],
                "p99_ms": ps["p99"]}

    def _observe_latency(self, resp: "QueryResponse") -> None:
        self.metrics.observe("serve.latency_ms",
                             float(resp.elapsed) * 1e3)

    # -- family identity ----------------------------------------------------
    def family_key(self, req: QueryRequest) -> tuple:
        if hasattr(req.env, "load_env"):        # StoredDataset
            key, _, _ = self.service.fingerprint_stored(
                req.program, req.env, req.skew_hints)
        else:
            key, _, _, _ = self.service.fingerprint(
                req.program, req.env, req.skew_hints)
        return key

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                self.tenant_rate, self.tenant_burst, self.clock)
        return b

    def _breaker(self, key: tuple) -> CircuitBreaker:
        fid = _family_id(key)
        br = self._breakers.get(fid)
        if br is None:
            br = self._breakers[fid] = CircuitBreaker(
                self.breaker_threshold, self.breaker_cooldown, self.clock)
        return br

    # -- admission ----------------------------------------------------------
    def _admit(self, req: QueryRequest,
               key: tuple) -> Optional[QueryResponse]:
        """None = admitted; otherwise the shed response."""
        if not self._breaker(key).allow():
            self.stats["circuit_open"] += 1
            return QueryResponse(
                ok=False, shed=True, family=key,
                error=CircuitOpenError(
                    f"family {_family_id(key)} circuit open"))
        if not self._bucket(req.tenant).take():
            self.stats["shed_quota"] += 1
            return QueryResponse(
                ok=False, shed=True, family=key,
                error=ShedError(f"tenant {req.tenant!r} over quota"))
        return None

    # -- single submission --------------------------------------------------
    def submit(self, req: QueryRequest) -> QueryResponse:
        """Serve one request end to end; ALWAYS returns a response."""
        with _span("serve.submit", tenant=req.tenant):
            resp = self._submit(req)
        self._observe_latency(resp)
        return resp

    def _submit(self, req: QueryRequest) -> QueryResponse:
        t0 = self.clock()
        self.stats["submitted"] += 1
        try:
            key = self.family_key(req)
            shed = self._admit(req, key)
            if shed is not None:
                shed.elapsed = self.clock() - t0
                return shed
            if self.compile_budget <= 0 and not self.service.is_warm(key):
                self.stats["shed_compile"] += 1
                return QueryResponse(
                    ok=False, shed=True, family=key,
                    error=ShedError("cold-compile budget exhausted"),
                    elapsed=self.clock() - t0)
            return self._serve(req, key, t0)
        except BaseException as e:      # last resort: never crash
            self.stats["failed"] += 1
            return QueryResponse(ok=False, error=e,
                                 elapsed=self.clock() - t0)

    # -- batched submission -------------------------------------------------
    def submit_many(self, reqs: Sequence[QueryRequest]
                    ) -> List[QueryResponse]:
        """Admit a window of concurrent requests, shed past the queue
        bound and the cold-compile budget, then coalesce same-family
        local requests into single ``execute_many`` dispatches and
        serve the rest individually through the retry ladder."""
        with _span("serve.submit_many", batch=len(reqs)):
            out = self._submit_many(reqs)
        for resp in out:
            self._observe_latency(resp)
        return out

    def _submit_many(self, reqs: Sequence[QueryRequest]
                     ) -> List[QueryResponse]:
        t0 = self.clock()
        out: List[Optional[QueryResponse]] = [None] * len(reqs)
        admitted = []
        for i, r in enumerate(reqs):
            self.stats["submitted"] += 1
            if len(admitted) >= self.max_queue:
                self.stats["shed_queue"] += 1
                out[i] = QueryResponse(
                    ok=False, shed=True,
                    error=ShedError(f"queue depth > {self.max_queue}"))
                continue
            try:
                key = self.family_key(r)
            except BaseException as e:
                self.stats["failed"] += 1
                out[i] = QueryResponse(ok=False, error=e)
                continue
            shed = self._admit(r, key)
            if shed is not None:
                out[i] = shed
                continue
            admitted.append((i, r, key))
        # cold-compile storm control: at most `compile_budget` DISTINCT
        # cold families per window; requests of families past the
        # budget shed (they will be warm next window)
        cold: List[str] = []
        groups: Dict[object, list] = {}
        for i, r, key in admitted:
            fid = _family_id(key)
            if not self.service.is_warm(key) and fid not in cold:
                cold.append(fid)
            if fid in cold and cold.index(fid) >= self.compile_budget:
                self.stats["shed_compile"] += 1
                out[i] = QueryResponse(
                    ok=False, shed=True, family=key,
                    error=ShedError("cold-compile budget exhausted"))
                continue
            gk = (fid, id(r.env)) if self._coalescible(r, key) \
                else ("solo", i)
            groups.setdefault(gk, []).append((i, r, key))
        for gk, members in groups.items():
            if gk[0] != "solo" and len(members) > 1:
                self._serve_batch(members, out, t0)
            else:
                for i, r, key in members:
                    out[i] = self._serve(r, key, self.clock())
        return out  # type: ignore[return-value]

    def _coalescible(self, req: QueryRequest, key: tuple) -> bool:
        return (self.service.mesh is None
                and not hasattr(req.env, "load_env")
                and req.skew_hints is None
                and _family_id(key) not in self._degraded_families)

    def _serve_batch(self, members, out, t0) -> None:
        _, r0, key = members[0]
        br = self._breaker(key)
        try:
            miss0 = self.service.stats["misses"]
            results = self.service.execute_many(
                [r.program for _, r, _ in members], r0.env)
            if self.service.stats["misses"] > miss0:
                self.stats["compiles"] += 1
                self._record(r0, key)
            br.record(True)
            self.stats["batches"] += 1
            self.stats["coalesced"] += len(members)
            for (i, r, k), res in zip(members, results):
                self.stats["ok"] += 1
                out[i] = QueryResponse(ok=True, outputs=res, family=k,
                                       elapsed=self.clock() - t0)
        except BaseException:
            # a failed coalesced dispatch falls back to per-request
            # serving (each request then gets the full retry ladder)
            for i, r, k in members:
                out[i] = self._serve(r, k, self.clock())

    # -- the retry / degradation ladder ------------------------------------
    def _serve(self, req: QueryRequest, key: tuple,
               t0: float) -> QueryResponse:
        deadline = req.deadline if req.deadline is not None \
            else self.default_deadline
        deadline_at = None if deadline is None else t0 + deadline
        br = self._breaker(key)
        retries = 0
        degraded: List[str] = []
        no_skip = False
        while True:
            if deadline_at is not None and self.clock() >= deadline_at:
                self.stats["deadline_exceeded"] += 1
                self.stats["failed"] += 1
                br.record(False)
                return QueryResponse(
                    ok=False, retries=retries, family=key,
                    degraded=tuple(degraded),
                    error=DeadlineExceeded(
                        f"deadline {deadline}s elapsed"),
                    elapsed=self.clock() - t0)
            try:
                outputs = self._dispatch(req, key, no_skip)
                br.record(True)
                self.stats["ok"] += 1
                return QueryResponse(
                    ok=True, outputs=outputs, retries=retries,
                    degraded=tuple(degraded), family=key,
                    elapsed=self.clock() - t0)
            except ReproError as e:
                action = self._recover(e, req, key, no_skip, retries,
                                       degraded)
                if action == "fail" or retries >= self.max_retries:
                    br.record(False)
                    self.stats["failed"] += 1
                    return QueryResponse(
                        ok=False, error=e, retries=retries,
                        degraded=tuple(degraded), family=key,
                        elapsed=self.clock() - t0)
                no_skip = no_skip or action == "retry_no_skip"
                retries += 1
                self.stats["retried"] += 1
                self._backoff(retries, deadline_at)
            except BaseException as e:
                # anything untyped fails THIS query only
                br.record(False)
                self.stats["failed"] += 1
                return QueryResponse(
                    ok=False, error=e, retries=retries,
                    degraded=tuple(degraded), family=key,
                    elapsed=self.clock() - t0)

    def _recover(self, e: ReproError, req: QueryRequest, key: tuple,
                 no_skip: bool, retries: int,
                 degraded: List[str]) -> str:
        """Map a typed failure to the next rung of the ladder:
        'retry' | 'retry_no_skip' | 'fail'."""
        if isinstance(e, CapacityOverflowError):
            # stale adaptive capacities: evict and re-warm for the new
            # binding (the retry recompiles through the miss path)
            if self.service.evict(key):
                self.stats["compiles"] += 0   # counted on the re-warm
            if "rewarm" not in degraded:
                degraded.append("rewarm")
            return "retry"
        if isinstance(e, FooterError):
            return "fail"                     # dataset itself unreadable
        if isinstance(e, StorageError):
            # chunk fault: one more attempt (an IO blip clears), then
            # the degraded full scan with zone-map skipping disabled;
            # persistent corruption fails the query, never the server
            if hasattr(req.env, "load_env") and not no_skip:
                if "no_skip_rescan" not in degraded:
                    degraded.append("no_skip_rescan")
                    self.stats["degraded_no_skip"] += 1
                return "retry_no_skip"
            return "retry" if retries < self.max_retries else "fail"
        if isinstance(e, ExchangeError):
            # transient collective failure: retry; if it keeps failing
            # and a local twin exists, pin the family to it
            if retries >= 1 and self.local_fallback is not None:
                fid = _family_id(key)
                if fid not in self._degraded_families:
                    self._degraded_families.add(fid)
                    self.stats["degraded_dist_local"] += 1
                degraded.append("dist_to_local")
                return "retry"
            return "retry"
        return "retry" if e.transient else "fail"

    def _backoff(self, attempt: int, deadline_at: Optional[float]) -> None:
        delay = min(self.backoff_cap,
                    self.backoff_base * (2.0 ** (attempt - 1)))
        delay *= 0.5 + 0.5 * float(self._rng.rand())    # seeded jitter
        if deadline_at is not None:
            delay = min(delay, max(deadline_at - self.clock(), 0.0))
        self.stats["backoff_s"] += delay
        self.sleep(delay)

    # -- dispatch -----------------------------------------------------------
    def _route(self, key: tuple) -> QueryService:
        if _family_id(key) in self._degraded_families \
                and self.local_fallback is not None:
            return self.local_fallback
        return self.service

    def _dispatch(self, req: QueryRequest, key: tuple,
                  no_skip: bool) -> dict:
        rule = FAULTS.hit("serve.cache_evict", family=_family_id(key))
        if rule is not None and rule.kind == "evict" \
                and self.service.evict(key):
            # mid-flight eviction: the very next lookup recompiles
            # transparently (the natural miss path)
            self.stats["injected_evictions"] += 1
        svc = self._route(key)
        miss0 = svc.stats["misses"]
        if hasattr(req.env, "load_env"):
            out = svc.execute_stored(
                req.program, req.env, skew_hints=req.skew_hints,
                no_skip=no_skip, verify=self.verify_reads)
        else:
            out = svc.execute(req.program, req.env,
                              skew_hints=req.skew_hints)
        if svc.stats["misses"] > miss0:
            self.stats["compiles"] += 1
            if svc is self.service:
                self._record(req, key)
        if svc is self.service and svc.mesh is not None:
            self._check_imbalance(svc, key)
        return out

    def _check_imbalance(self, svc: QueryService, key: tuple) -> None:
        """Receive-load imbalance of the last dist execute: max over
        exchange sites of (max rows one partition received) / (mean).
        Beyond threshold, future calls of the family pin to the local
        twin — the distributed placement is pathological for its key
        distribution (Beame/Koutris/Suciu's skew regime)."""
        ratio = self._imbalance_ratio(svc.last_metrics, svc.mesh.size)
        rule = FAULTS.hit("dist.imbalance", family=_family_id(key))
        if rule is not None and rule.kind == "inflate":
            ratio *= float(rule.arg or 10.0)
        if ratio > self.imbalance_threshold \
                and self.local_fallback is not None:
            fid = _family_id(key)
            if fid not in self._degraded_families:
                self._degraded_families.add(fid)
                self.stats["degraded_imbalance"] += 1

    @staticmethod
    def _imbalance_ratio(metrics: Optional[dict], nparts: int) -> float:
        if not metrics or nparts <= 1:
            return 1.0
        worst = 1.0
        for k, v in metrics.items():
            if not k.startswith("part_max_"):
                continue
            site = k[len("part_max_"):]
            total = metrics.get(f"part_rows_{site}", 0)
            if total:
                worst = max(worst, float(v) * nparts / float(total))
        return worst

    # -- crash recovery -----------------------------------------------------
    def _record(self, req: QueryRequest, key: tuple) -> None:
        if self.manifest is None:
            return
        fid = _family_id(key)
        shape = [list(p) for p in
                 QueryService._skew_shape(req.skew_hints)]
        if hasattr(req.env, "load_env"):
            added = self.manifest.record(
                fid, "stored", req.program,
                dataset_dir=req.env.dir, skew=shape)
        else:
            _, _, _, class_caps = self.service.fingerprint(
                req.program, req.env, req.skew_hints)
            schema = [[name, class_caps[name],
                       [[c, str(bag.data[c].dtype)]
                        for c in bag.columns]]
                      for name, bag in sorted(req.env.items())]
            added = self.manifest.record(fid, "local", req.program,
                                         schema=schema, skew=shape)
        if added:
            self.manifest.save()

    def warm_replay(self) -> int:
        """Re-compile every manifest family in this (fresh) process by
        executing it once against a synthetic environment of exactly
        the recorded shapes — after this, real traffic of recorded
        families runs with ZERO plan rebuilds. Returns families replayed;
        an entry that fails to replay is skipped (costing only its
        cold compile later), it never fails the restart."""
        if self.manifest is None:
            return 0
        n = 0
        for entry in list(self.manifest.entries.values()):
            try:
                prog = PlanCacheManifest.program(entry)
                hints = _synthetic_hints(entry.get("skew"))
                if entry["kind"] == "stored":
                    from repro_torch.storage import StoredDataset
                    ds = StoredDataset(entry["dataset_dir"],
                                       device=self.device)
                    self.service.execute_stored(prog, ds,
                                                skew_hints=hints)
                else:
                    env = _synthetic_env(entry["schema"], self.device)
                    self.service.execute(prog, env, skew_hints=hints)
                n += 1
            except BaseException:
                self.stats["replay_failed"] += 1
        self.stats["replayed"] += n
        return n
