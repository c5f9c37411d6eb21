"""QueryService — a parameterized plan-cache front end for the
whole-program shredded compiler (PyTorch twin of
``repro.serve.query_service``; DESIGN.md "Whole-program compilation and
the query service").

Serving repeated query traffic means the expensive work — NRC
shredding, materialization, plan passes — must happen once per *query
family*, not once per invocation. The service realizes that with a
three-part cache key:

  * **program structure** — the submitted NRC program with every
    liftable constant replaced by a positional ``N.Param``
    (``nrc.lift_constants``). Two submissions that differ only in
    constant values fingerprint identically; the values ride along as
    runtime parameter bindings, so a warm hit rebuilds no plan
    (``codegen.TRACE_STATS`` stays flat).
  * **schema** — per environment bag, its column names and dtypes.
  * **capacity class** — bag capacities rounded up to the next power of
    two; submissions whose bags differ only in row count inside one
    class hit the same executable (bags are padded up on entry, and
    every operator masks by validity).

Misses compile via ``codegen.compile_program`` (cross-assignment CSE,
dead-code elimination) into a single ``jit_program`` executable — or,
with a mesh (``exec.dist.device_mesh_1d``), through
``codegen.compile_program_distributed`` with the service's
``dist_kwargs`` (``adaptive=True`` resolves exact exchange-bucket
capacities before the warm runner is cached). On the distributed path
the lifted constants are runtime parameters too, so dist submissions
differing only in constants also hit one warm runner.

**Automated skew handling**: with ``skew_mode="auto"`` the compiler
inserts ``SkewJoinP`` nodes wherever heavy-hitter statistics predict
partition imbalance over ``skew_partitions`` (default: the mesh size) —
from a stored dataset's persisted sketches (``execute_stored``), or from
caller-supplied ``skew_hints`` ({bag: {column: heavy keys}}). The
heavy-key sets ride as runtime parameters: the cache key carries only
the hint *shape*, so a warm call with a DIFFERENT heavy-key set rebinds
with zero retraces, exactly like ``N.Param`` constants.

``execute_many`` serves concurrent invocations of one family: it
resolves the family once (one cache lookup, one ``batch_calls``) and
runs the warm executable once per parameter binding. The reference
stacks the bindings and runs them under ``jax.vmap``; the port's
executable launches ctypes-bound kernels and reads sizes on the host,
which ``torch.func.vmap`` cannot map through.

Stored datasets (``storage.StoredDataset``) serve through
``execute_stored`` — one warm plan, zone maps re-selecting chunks per
parameter binding — and ``execute_stored_streaming``, which runs the
same executable once per morsel window and re-folds the partial
outputs (``plans.morsel_fold``).

With a ``feedback`` accumulator (``obs.StatsFeedback``), cold compiles
measure the input bags' valid rows into it and overlay earlier
measurements onto the planner statistics, per-operator rows harvested
from EXPLAIN ANALYZE pin the cost estimator's estimates, and every
distributed execute folds its receive-load imbalance in.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.columnar.table import FlatBag
from repro_torch.core import codegen as CG
from repro_torch.core import materialization as M
from repro_torch.core import nrc as N
from repro_torch.core.plans import ExecSettings
from repro_torch.core.unnesting import Catalog
from repro_torch.errors import CapacityOverflowError
from repro_torch.obs.trace import span as _span


def lift_program(program: N.Program) -> Tuple[N.Program, list]:
    """Lift every liftable constant of every assignment into positional
    ``__p<i>`` parameters (numbering shared across assignments, in
    deterministic traversal order). Returns (lifted program, values)."""
    vals: list = []
    assigns = []
    for a in program.assignments:
        e, vals = N.lift_constants(a.expr, values=vals)
        assigns.append(N.Assignment(a.name, e, a.role, a.path,
                                    a.parent, a.label_attr))
    return N.Program(assigns), vals


def _class_capacity(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


@dataclass
class CacheEntry:
    key: tuple
    cp: CG.CompiledProgram
    sp: M.ShreddedProgram
    exe: Optional[CG.ProgramExecutable]      # local path
    runner: Optional[object]                 # dist path (DistRunner)
    param_names: tuple
    class_caps: Dict[str, int]
    hits: int = 0
    # storage-backed entries: per-part column/skip-predicate
    # requirements derived from the compiled plans (storage.catalog)
    storage_req: Optional[dict] = None
    # morsel-streaming entries: (storage.morsel.MorselPlan,
    # {output: fold spec} from plans.morsel_fold)
    morsel: Optional[tuple] = None

    def manifest(self, source: str) -> M.Manifest:
        return self.sp.manifests[source]

    @property
    def estimates(self) -> Dict[str, Optional[int]]:
        """Cost-based per-node root-row estimates, snapshotted at
        compile time (``cost_mode="auto"``; empty otherwise). Warm
        rebinds read this cached copy — no re-estimation."""
        return self.cp.estimates


class QueryService:
    """Compile-once / serve-many front end. See module docstring.

    ``mesh=None`` serves through the local single-executable path
    (parameter bindings supported, capacity classes rounded to powers of
    two); with a mesh (``exec.dist.device_mesh_1d``), programs compile
    through the distributed scheduler, on the mesh's sites.
    ``feedback`` is an optional ``obs.StatsFeedback`` (see the module
    docstring)."""

    def __init__(self, input_types: Dict[str, N.BagT],
                 catalog: Optional[Catalog] = None,
                 settings: Optional[ExecSettings] = None,
                 domain_elimination: bool = True,
                 mesh=None, dist_kwargs: Optional[dict] = None,
                 max_entries: int = 64,
                 skew_mode: str = "auto",
                 skew_threshold: float = 0.025,
                 skew_partitions: Optional[int] = None,
                 hypercube_mode: str = "auto",
                 feedback: Optional[object] = None,
                 cost_mode: str = "off"):
        assert skew_mode in ("auto", "off"), skew_mode
        assert hypercube_mode in ("auto", "off"), hypercube_mode
        assert cost_mode in ("auto", "off"), cost_mode
        self.input_types = dict(input_types)
        self.catalog = catalog or Catalog()
        self.settings = settings or ExecSettings()
        self.domain_elim = domain_elimination
        self.mesh = mesh
        self.dist_kwargs = dict(dist_kwargs or {})
        self.max_entries = max_entries
        self.skew_mode = skew_mode
        self.hypercube_mode = hypercube_mode
        self.cost_mode = cost_mode
        self.skew_threshold = skew_threshold
        # imbalance is judged against the partition count queries will
        # actually run over: the mesh size, unless pinned explicitly
        # (a single partition can never be imbalanced -> pass disabled)
        self.skew_partitions = skew_partitions if skew_partitions \
            else (mesh.size if mesh is not None else 1)
        self._cache: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "batch_calls": 0}
        # shuffle/overflow metrics of the most recent dist execute —
        # the serving runtime reads receive-load imbalance off these
        self.last_metrics: Optional[dict] = None
        # optional obs.StatsFeedback: cold compiles measure input rows
        # into it, dist executes fold receive-load imbalance, and the
        # planner stats passed to the skew/hypercube passes get the
        # measured rows overlaid (TableStats.effective_rows)
        self.feedback = feedback

    # -- ingestion helper --------------------------------------------------
    def shred_inputs(self, inputs: Dict[str, list],
                     capacities: Optional[Dict[str, int]] = None,
                     encoders: Optional[dict] = None,
                     device=None) -> Dict[str, FlatBag]:
        """Value-shred nested rows onto ``device`` (None = the GPU)."""
        return CG.columnar_shred_inputs(inputs, self.input_types,
                                        capacities, encoders, device=device)

    # -- fingerprinting ----------------------------------------------------
    @staticmethod
    def _skew_shape(skew_hints: Optional[dict]) -> tuple:
        """Structural component of a hint set: WHICH (bag, column)
        pairs carry a heavy-key set — never the key values, which are
        runtime parameter bindings."""
        if not skew_hints:
            return ()
        return tuple(sorted((bag, col) for bag, cols in skew_hints.items()
                            for col in cols))

    def fingerprint(self, program: N.Program, env: Dict[str, FlatBag],
                    skew_hints: Optional[dict] = None
                    ) -> Tuple[tuple, N.Program, list, Dict[str, int]]:
        """(cache key, lifted program, parameter values, class caps)."""
        lifted, values = lift_program(program)
        prog_fp = N.program_fingerprint(lifted)
        class_caps = {}
        schema = []
        for name in sorted(env):
            bag = env[name]
            cap = bag.capacity if self.mesh is not None \
                else _class_capacity(bag.capacity)
            class_caps[name] = cap
            schema.append((name, cap,
                           tuple((c, str(bag.data[c].dtype))
                                 for c in bag.columns)))
        key = (prog_fp, tuple(schema),
               "dist" if self.mesh is not None else "local",
               ("skew",) + self._skew_shape(skew_hints))
        return key, lifted, values, class_caps

    # -- cache management --------------------------------------------------
    @staticmethod
    def _valid_rows(b: FlatBag) -> int:
        """Host-side valid-row count of an in-memory bag (compile time
        only, on the cold cache miss): the pow2 capacity class can
        overestimate live rows by ~2x, which would bias share planning
        and the skew threshold."""
        return int(b.valid.sum())

    def _hint_stats(self, skew_hints: Optional[dict],
                    env_c: Dict[str, FlatBag]) -> Optional[dict]:
        """Caller-supplied heavy-key hints as planner statistics: every
        hinted key counts as definitely-heavy (count == rows), so the
        automatic pass inserts a SkewJoinP at exactly the hinted
        joins. On the distributed path, every environment bag also
        contributes a row estimate (its VALID rows, counted host-side
        at compile time), so the HyperCube share planner and the cost
        estimator can cost multiway chains over in-memory inputs that
        have no persisted sketches."""
        if self.skew_mode == "off" or self.skew_partitions <= 1:
            return None
        want_hc = self.mesh is not None and self.hypercube_mode == "auto"
        if not skew_hints and not want_hc and self.cost_mode != "auto":
            return None
        from repro_torch.core.skew import TableStats
        stats = {}
        if want_hc or self.cost_mode == "auto":
            for bag, b in env_c.items():
                stats[bag] = TableStats(rows=self._valid_rows(b))
        for bag, cols in (skew_hints or {}).items():
            rows = self._valid_rows(env_c[bag]) if bag in env_c else 1
            ts = stats.get(bag) or TableStats(rows=rows)
            ts.heavy = {col: [(int(k), rows) for k in list(ks)]
                        for col, ks in cols.items()}
            stats[bag] = ts
        return stats

    def _skew_binds(self, cp: CG.CompiledProgram,
                    skew_hints: Optional[dict]) -> Dict[str, object]:
        """Warm-call heavy-key rebinding: hint values for the (bag,
        column) pairs the compiled plan lifted as skew parameters.
        Hints beyond the static MAX_HEAVY bound truncate, mirroring
        the compile-time decision (`decide_heavy_keys` keeps 40)."""
        if not skew_hints or not cp.skew_params:
            return {}
        from repro_torch.core.skew import MAX_HEAVY, pad_heavy
        out = {}
        for name, (bag, attr) in cp.skew_params.items():
            ks = (skew_hints.get(bag) or {}).get(attr)
            if ks is not None:
                out[name] = pad_heavy(list(ks)[:MAX_HEAVY])
        return out

    def _lookup(self, program: N.Program, env: Dict[str, FlatBag],
                skew_hints: Optional[dict] = None
                ) -> Tuple[CacheEntry, Dict[str, object],
                           Dict[str, FlatBag]]:
        key, lifted, values, class_caps = self.fingerprint(
            program, env, skew_hints)
        env_c = {name: bag if bag.capacity == class_caps[name]
                 else bag.resize(class_caps[name])
                 for name, bag in env.items()}
        entry = self._cache.get(key)
        if entry is not None:
            self._touch(key, entry)
        else:
            entry = self._remember(key, self._compile(
                key, lifted, env_c, class_caps, len(values),
                skew_stats=self._hint_stats(skew_hints, env_c)))
        params = {f"__p{i}": v for i, v in enumerate(values)}
        params.update(self._skew_binds(entry.cp, skew_hints))
        return entry, params, env_c

    def is_warm(self, key: tuple) -> bool:
        """True when ``key`` is cached (no stats / LRU side effects)."""
        return key in self._cache

    def evict(self, key: Optional[tuple] = None) -> int:
        """Drop one cached entry (or all with ``key=None``); returns
        the number evicted."""
        if key is None:
            n = len(self._cache)
            self._cache.clear()
        else:
            n = 1 if self._cache.pop(key, None) is not None else 0
        self.stats["evictions"] += n
        return n

    def _touch(self, key: tuple, entry: CacheEntry) -> None:
        self.stats["hits"] += 1
        entry.hits += 1
        self._cache.move_to_end(key)

    def _remember(self, key: tuple, entry: CacheEntry) -> CacheEntry:
        self.stats["misses"] += 1
        self._cache[key] = entry
        if len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)
            self.stats["evictions"] += 1
        return entry

    def _compile_cp(self, lifted: N.Program,
                    skew_stats: Optional[dict] = None
                    ) -> Tuple[M.ShreddedProgram, CG.CompiledProgram]:
        sp = M.shred_program(lifted, self.input_types,
                             domain_elimination=self.domain_elim)
        cp = CG.compile_program(sp, self.catalog,
                                skew_stats=skew_stats,
                                skew_mode=self.skew_mode,
                                skew_partitions=self.skew_partitions,
                                skew_threshold=self.skew_threshold,
                                hypercube_mode=self.hypercube_mode,
                                cost_mode=self.cost_mode,
                                observed_rows=self._observed_rows())
        return sp, cp

    def _observed_rows(self) -> Optional[dict]:
        """Per-operator measured row counts from the feedback
        accumulator (``obs.StatsFeedback.node_rows``), for the cost
        estimator's ground-truth override on recompiles."""
        rows = getattr(self.feedback, "node_rows", None)
        return dict(rows) if rows else None

    def _compile(self, key: tuple, lifted: N.Program,
                 env_c: Dict[str, FlatBag],
                 class_caps: Dict[str, int],
                 n_params: int = 0,
                 skew_stats: Optional[dict] = None) -> CacheEntry:
        if self.feedback is not None:
            # once per family (the cold path): ground-truth input rows
            # into the feedback accumulator, then overlay any prior
            # measurements onto the planner stats for this compile
            self.feedback.record_env(env_c)
            skew_stats = self.feedback.apply(skew_stats)
        with _span("query.compile",
                   path="dist" if self.mesh is not None else "local",
                   assignments=len(lifted.assignments)):
            sp, cp = self._compile_cp(lifted, skew_stats)
            if self.mesh is not None:
                runner, _, _ = CG.compile_program_distributed(
                    cp, env_c, self.mesh,
                    use_kernel=self.settings.use_kernel, **self.dist_kwargs)
                return CacheEntry(key, cp, sp, None, runner, (),
                                  dict(class_caps))
            return self._local_entry(key, sp, cp, class_caps, n_params)

    def _local_entry(self, key: tuple, sp: M.ShreddedProgram,
                     cp: CG.CompiledProgram, class_caps: Dict[str, int],
                     n_params: int, storage_req=None) -> CacheEntry:
        """The shared executable-and-cache tail (in-memory and
        storage-backed misses)."""
        exe = CG.jit_program(cp, self.settings)
        # every positionally lifted name is a legal binding, even when
        # its expression died in DCE/pruning (binds to nothing)
        exe.accepted = frozenset(f"__p{i}" for i in range(n_params))
        return CacheEntry(key, cp, sp, exe, None,
                          tuple(sorted(exe.param_defaults)),
                          dict(class_caps), storage_req=storage_req)

    # -- execution ---------------------------------------------------------
    def execute(self, program: N.Program, env,
                skew_hints: Optional[dict] = None) -> Dict[str, FlatBag]:
        """Run one program invocation; returns the output bags (every
        manifest top + dictionary). Warm path: cache hit, parameter
        rebind, no shredding, plan passes or plan rebuild. ``env`` is
        either an environment of FlatBags or a persisted
        ``storage.StoredDataset`` (routed through ``execute_stored``).

        ``skew_hints`` ({bag: {column: heavy-key iterable}}) marks
        probe-side columns whose heavy keys should take the broadcast
        path. The hint SHAPE joins the cache key; the key VALUES are
        runtime parameters — warm calls may supply a different set per
        call with zero retracing."""
        if hasattr(env, "load_env"):       # storage.StoredDataset
            return self.execute_stored(program, env,
                                       skew_hints=skew_hints)
        assert not hasattr(env, "ensure_loaded"), (
            "QueryService.execute received a lazy StorageEnv; pass the "
            "StoredDataset itself (execute / execute_stored), or run "
            "the eager path via codegen.run_flat_program")
        with _span("query.execute",
                   path="dist" if self.mesh is not None else "local"):
            return self._execute(program, env, skew_hints)

    def _execute(self, program: N.Program, env,
                 skew_hints: Optional[dict]) -> Dict[str, FlatBag]:
        entry, params, env_c = self._lookup(program, env, skew_hints)
        if entry.runner is not None:
            rp = entry.runner.params or {}
            bound = {k: v for k, v in params.items() if k in rp}
            out, metrics = entry.runner(env_c, params=bound)
            self.last_metrics = metrics
            if self.feedback is not None:
                self.feedback.record_metrics(
                    str(entry.key[0]), metrics, self.skew_partitions)
            # a rebind that SHRINKS the warm heavy-key set can push a
            # hot key back through an exchange bucket the adaptive
            # warmup sized without it; the raw runner meters that as
            # overflow (the skew safety valve), but a serving layer
            # must not silently truncate — fail loudly, re-warm with
            # the new set instead
            if entry.cp.skew_params and any(k in entry.cp.skew_params
                                            for k in bound):
                lost = metrics.get("overflow_rows", 0) \
                    + metrics.get("compact_dropped_rows", 0)
                if lost:
                    raise CapacityOverflowError(
                        f"heavy-key rebind overflowed warm capacities "
                        f"({lost} rows dropped); the adaptive sizes "
                        f"were resolved for the warmup heavy-key set — "
                        f"grow the set, or re-warm the entry for the "
                        f"new one")
            return out
        return entry.exe(env_c, params)

    def execute_many(self, programs: Sequence[N.Program],
                     env: Dict[str, FlatBag]) -> List[Dict[str, FlatBag]]:
        """Batch concurrent invocations of ONE query family: all
        programs must fingerprint identically (same structure, differing
        only in lifted constant values). The family resolves once (one
        cache lookup); the warm executable then runs once per binding
        over the shared environment, and each program's outputs equal
        its own ``execute``'s."""
        assert programs, "empty batch"
        assert self.mesh is None, (
            "execute_many is a local-path feature (batching over params)")
        self.stats["batch_calls"] += 1
        with _span("query.execute_many", batch=len(programs)):
            return self._execute_many(programs, env)

    def _execute_many(self, programs: Sequence[N.Program],
                      env: Dict[str, FlatBag]
                      ) -> List[Dict[str, FlatBag]]:
        entry, params0, env_c = self._lookup(programs[0], env)
        binds = [entry.exe.bind(params0)]
        for prog in programs[1:]:
            key, _, values, _ = self.fingerprint(prog, env)
            assert key == entry.key, (
                "execute_many: programs are not one parameterized "
                "family (structure/schema/capacity-class mismatch)")
            binds.append(entry.exe.bind(
                {f"__p{i}": v for i, v in enumerate(values)}))
        if not binds[0]:
            # no parameters anywhere: identical invocations
            out = entry.exe(env_c)
            return [out for _ in binds]
        return [entry.exe(env_c, b) for b in binds]

    # -- storage-backed execution ------------------------------------------
    def fingerprint_stored(self, program: N.Program, dataset,
                           skew_hints: Optional[dict] = None
                           ) -> Tuple[tuple, N.Program, list]:
        """Cache key for a (program, stored dataset) pair. The dataset
        fingerprint covers schemas and row totals but NOT chunk
        selection — one warm plan serves every parameter binding while
        zone maps re-select chunks per call."""
        lifted, values = lift_program(program)
        key = (N.program_fingerprint(lifted),
               ("stored",) + dataset.fingerprint(),
               ("skew",) + self._skew_shape(skew_hints))
        return key, lifted, values

    def _stored_skew_stats(self, dataset,
                           skew_hints: Optional[dict]) -> Optional[dict]:
        """Planner statistics for a stored dataset: the persisted
        streaming sketches + zone-map distinct counts, overridden by
        any caller hints (hinted keys count as definitely heavy)."""
        if self.skew_mode == "off" or self.skew_partitions <= 1:
            return None
        from repro_torch.core.skew import TableStats
        from repro_torch.storage import table_stats
        stats = table_stats(dataset)
        for bag, cols in (skew_hints or {}).items():
            rows = dataset.parts[bag].rows if bag in dataset.parts else 1
            ts = stats.get(bag) or TableStats(rows=rows)
            for col, ks in cols.items():
                ts.heavy[col] = [(int(k), max(rows, 1)) for k in list(ks)]
            stats[bag] = ts
        if self.feedback is not None:
            stats = self.feedback.apply(stats)
        return stats

    def _lookup_stored(self, program: N.Program, dataset,
                       skew_hints: Optional[dict] = None,
                       no_skip: bool = False, verify: bool = False
                       ) -> Tuple[CacheEntry, Dict[str, object],
                                  Dict[str, FlatBag]]:
        from repro_torch.storage import storage_requirements
        assert self.mesh is None, (
            "storage-backed serving is a local-path feature")
        key, lifted, values = self.fingerprint_stored(program, dataset,
                                                      skew_hints)
        entry = self._cache.get(key)
        if entry is not None:
            self._touch(key, entry)
        else:
            with _span("query.compile", path="stored",
                       assignments=len(lifted.assignments)):
                sp, cp = self._compile_cp(
                    lifted, self._stored_skew_stats(dataset, skew_hints))
                req = storage_requirements(cp, set(dataset.parts))
                # capacities pin to the FULL part's class regardless of
                # the per-call chunk selection, so the executable's input
                # signature never changes
                class_caps = {part: _class_capacity(
                    max(dataset.parts[part].rows, 1)) for part in req}
                entry = self._remember(key, self._local_entry(
                    key, sp, cp, class_caps, len(values),
                    storage_req=req))
        params = {f"__p{i}": v for i, v in enumerate(values)}
        params.update(self._skew_binds(entry.cp, skew_hints))
        env = dataset.load_env(
            columns={p: r.columns for p, r in entry.storage_req.items()},
            preds=None if no_skip else
            {p: r.pred for p, r in entry.storage_req.items()},
            params=params, capacities=entry.class_caps, verify=verify)
        return entry, params, env

    def execute_stored(self, program: N.Program, dataset,
                       skew_hints: Optional[dict] = None,
                       no_skip: bool = False, verify: bool = False
                       ) -> Dict[str, FlatBag]:
        """Run one invocation against a persisted dataset
        (``storage.StoredDataset``; its columns load onto the dataset's
        device). The warm path re-resolves the pushed-down ``N.Param``
        predicates against the dataset's zone maps at bind time — chunk
        selection adapts per call while the cached executable re-runs
        with no plan rebuild (capacities are pinned to the full part's
        class).

        ``no_skip=True`` disables zone-map chunk skipping for this call
        (the degraded re-scan after a chunk fault: capacities stay
        pinned, so the full scan reuses the warm executable);
        ``verify=True`` CRC-checks every loaded chunk."""
        with _span("query.execute", path="stored", no_skip=no_skip):
            entry, params, env = self._lookup_stored(
                program, dataset, skew_hints,
                no_skip=no_skip, verify=verify)
            return entry.exe(env, params)

    # -- morsel-streamed storage-backed execution --------------------------
    def _lookup_streaming(self, program: N.Program, dataset, root: str,
                          morsel_rows: int,
                          skew_hints: Optional[dict] = None):
        from repro_torch.core.plans import morsel_fold
        from repro_torch.storage import storage_requirements
        from repro_torch.storage.morsel import plan_morsels
        assert self.mesh is None, (
            "storage-backed serving is a local-path feature")
        base, lifted, values = self.fingerprint_stored(program, dataset,
                                                       skew_hints)
        key = base + (("morsel", root, int(morsel_rows)),)
        entry = self._cache.get(key)
        if entry is not None:
            self._touch(key, entry)
        else:
            sp, cp = self._compile_cp(
                lifted, self._stored_skew_stats(dataset, skew_hints))
            req = storage_requirements(cp, set(dataset.parts))
            mp = plan_morsels(dataset, root, morsel_rows)
            folds = morsel_fold(cp.plans, cp.outputs, set(mp.parts))
            # streamed parts pin to the worst morsel window's class;
            # resident parts to the full part's class — either way the
            # caps never change across morsels or calls, so ONE
            # executable serves the whole stream
            class_caps = {
                part: (mp.caps[part] if part in mp.caps
                       else _class_capacity(
                           max(dataset.parts[part].rows, 1)))
                for part in req}
            entry = self._remember(key, self._local_entry(
                key, sp, cp, class_caps, len(values), storage_req=req))
            entry.morsel = (mp, folds)
        params = {f"__p{i}": v for i, v in enumerate(values)}
        params.update(self._skew_binds(entry.cp, skew_hints))
        return entry, params

    def execute_stored_streaming(self, program: N.Program, dataset,
                                 morsel_rows: int,
                                 root: Optional[str] = None,
                                 skew_hints: Optional[dict] = None,
                                 no_skip: bool = False,
                                 verify: bool = False
                                 ) -> Dict[str, FlatBag]:
        """Run one invocation morsel-at-a-time over a persisted dataset
        whose streamed root may exceed device memory. The root input's
        parts load as chunk-aligned windows (``storage.morsel``); every
        other part stays resident; the SAME cached executable runs once
        per morsel (fixed capacity classes, validity-masked window
        tails); per-morsel partial outputs re-fold by the compile-time
        fold spec (``plans.morsel_fold``): concat for row-local outputs,
        re-aggregation for root Gamma+/dedup outputs, first for
        resident-only outputs. The rows come out in another order than
        ``execute_stored``'s: the same bag.

        Raises ``StreamingUnsupportedError`` when the program holds an
        aggregate over streamed rows below an output root, or the
        dataset's label columns are not monotone parent rids — fall
        back to ``execute_stored``."""
        with _span("query.execute", path="streaming",
                   morsel_rows=morsel_rows):
            return self._execute_stored_streaming(
                program, dataset, morsel_rows, root, skew_hints,
                no_skip, verify)

    def _execute_stored_streaming(self, program, dataset, morsel_rows,
                                  root, skew_hints, no_skip, verify
                                  ) -> Dict[str, FlatBag]:
        from repro_torch.storage.morsel import load_morsel_window
        if root is None:
            # default: stream the largest input root (by top-part rows)
            tops = {iname: dataset.parts[M.mat_input_name(iname, ())].rows
                    for iname in dataset.input_types}
            root = max(sorted(tops), key=lambda n: tops[n])
        entry, params = self._lookup_streaming(
            program, dataset, root, morsel_rows, skew_hints)
        mp, folds = entry.morsel
        req = entry.storage_req
        streamed = set(mp.parts) & set(req)
        resident = {p: r.columns for p, r in req.items()
                    if p not in streamed}
        env_resident = dataset.load_env(
            columns=resident,
            preds=None if no_skip else
            {p: req[p].pred for p in resident},
            params=params,
            capacities={p: entry.class_caps[p] for p in resident},
            verify=verify) if resident else {}
        outs = []
        for k in range(mp.n_morsels):
            env = dict(env_resident)
            for part in sorted(streamed):
                env[part] = load_morsel_window(
                    dataset.parts[part], mp.morsels[k][part],
                    req[part].columns, entry.class_caps[part],
                    pred=None if no_skip else req[part].pred,
                    params=params, verify=verify)
            outs.append(entry.exe(env, params))
        return _fold_streamed(folds, outs, self.settings)

    def unshred_stored(self, program: N.Program, dataset,
                       outputs: Dict[str, FlatBag], source: str) -> list:
        """Host-side nested rows of a stored-path result (the storage
        twin of ``unshred``)."""
        key, lifted, _ = self.fingerprint_stored(program, dataset)
        return self._rows_for(key, lifted, outputs, source)

    def _rows_for(self, key: tuple, lifted: N.Program,
                  outputs: Dict[str, FlatBag], source: str) -> list:
        """Manifest lookup (cached entry, else re-shred only) + the
        parts -> nested rows assembly shared by both unshred paths."""
        entry = self._cache.get(key)
        if entry is not None:
            man = entry.manifest(source)
        else:
            sp = M.shred_program(lifted, self.input_types,
                                 domain_elimination=self.domain_elim)
            man = sp.manifests[source]
        parts = {(): outputs[man.top]}
        for path, name in man.dicts.items():
            parts[path] = outputs[name]
        return CG.parts_to_rows(parts, man.ty)

    def warmup(self, program: N.Program, env: Dict[str, FlatBag],
               skew_hints: Optional[dict] = None) -> Dict[str, FlatBag]:
        """Populate the cache (and, on the dist path, resolve adaptive
        capacities — pass ``dist_kwargs=dict(adaptive=True)``) by
        running the program once."""
        return self.execute(program, env, skew_hints=skew_hints)

    # -- results -----------------------------------------------------------
    def unshred(self, program: N.Program, env: Dict[str, FlatBag],
                outputs: Dict[str, FlatBag], source: str) -> list:
        """Host-side nested rows of one submitted query's result (test /
        debugging convenience; production consumers read the columnar
        parts directly). Peeks at the cache without touching stats or
        LRU order; an evicted entry's manifest is recovered by
        re-shredding only (no plan compile)."""
        if hasattr(env, "load_env"):       # storage.StoredDataset
            return self.unshred_stored(program, env, outputs, source)
        key, lifted, _, _ = self.fingerprint(program, env)
        return self._rows_for(key, lifted, outputs, source)


def _fold_streamed(folds: Dict[str, tuple],
                   outs: List[Dict[str, FlatBag]],
                   settings: ExecSettings) -> Dict[str, FlatBag]:
    """Re-fold per-morsel partial outputs into the one-shot result
    (fold specs from ``plans.morsel_fold``)."""
    from repro_torch.columnar.table import concat_bags
    from repro_torch.exec import ops as X
    final: Dict[str, FlatBag] = {}
    for name, spec in folds.items():
        bags = [o[name] for o in outs]
        if spec[0] == "first":
            final[name] = bags[0]
            continue
        acc = bags[0]
        for b in bags[1:]:
            acc = concat_bags(acc, b)
        if spec[0] == "sum":
            final[name] = X.sum_by(acc, list(spec[1]), list(spec[2]),
                                   use_kernel=settings.use_kernel)
        elif spec[0] == "dedup":
            final[name] = X.dedup(
                acc, list(spec[1]) if spec[1] is not None else None)
        else:
            final[name] = acc
    return final
