"""QueryService — a parameterized plan-cache front end for the
whole-program shredded compiler (PyTorch twin of the local half of
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
dead-code elimination) into a single ``jit_program`` executable.

Stored datasets (``storage.StoredDataset``) serve through
``execute_stored`` — one warm plan, zone maps re-selecting chunks per
parameter binding — and ``execute_stored_streaming``, which runs the
same executable once per morsel window and re-folds the partial
outputs (``plans.morsel_fold``).

What waits for later slices, and raises ``NotImplementedError`` naming
its ROADMAP.md item: a ``mesh`` or ``dist_kwargs`` (queue 1 items 5
and 7), ``execute_many`` (item 7), ``skew_partitions > 1`` and
``cost_mode="auto"`` (item 4), and ``feedback`` (item 7). With one
partition the skew pass never runs, so ``skew_hints`` only join the
cache key, as their shape does in the reference.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.columnar.table import FlatBag
from repro_torch.core import codegen as CG
from repro_torch.core import materialization as M
from repro_torch.core import nrc as N
from repro_torch.core.plans import ExecSettings
from repro_torch.core.unnesting import Catalog
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
    runner: Optional[object]                 # dist path (queue 1 item 5)
    param_names: tuple
    class_caps: Dict[str, int]
    hits: int = 0
    batch_fns: Dict[int, object] = dc_field(default_factory=dict)
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
        compile time (empty until cost planning is ported)."""
        return self.cp.estimates


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"QueryService: {what} is ROADMAP.md queue 1 {item}")


class QueryService:
    """Compile-once / serve-many front end. See module docstring.

    Serves through the local single-executable path (parameter bindings
    supported, capacity classes rounded to powers of two). The
    arguments of the reference's distributed and statistics-driven
    paths are kept; any value that would need them raises."""

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
        if mesh is not None or dist_kwargs:
            raise _unported("distributed serving (mesh, dist_kwargs)",
                            "items 5 and 7")
        if skew_partitions is not None and skew_partitions > 1:
            raise _unported(f"skew planning (skew_partitions="
                            f"{skew_partitions})", "item 4")
        if feedback is not None:
            raise _unported("the stats feedback loop (feedback)", "item 7")
        if cost_mode == "auto":
            raise _unported("cost-based planning (cost_mode='auto')",
                            "item 4")
        self.input_types = dict(input_types)
        self.catalog = catalog or Catalog()
        self.settings = settings or ExecSettings()
        self.domain_elim = domain_elimination
        self.max_entries = max_entries
        self.skew_mode = skew_mode
        self.hypercube_mode = hypercube_mode
        self.cost_mode = cost_mode
        self.skew_threshold = skew_threshold
        # a single partition can never be imbalanced: the skew pass is
        # off (statistics are None on every compile)
        self.skew_partitions = 1
        self._cache: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "batch_calls": 0}

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
        pairs carry a heavy-key set — never the key values."""
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
            cap = _class_capacity(bag.capacity)
            class_caps[name] = cap
            schema.append((name, cap,
                           tuple((c, str(bag.data[c].dtype))
                                 for c in bag.columns)))
        key = (prog_fp, tuple(schema), "local",
               ("skew",) + self._skew_shape(skew_hints))
        return key, lifted, values, class_caps

    # -- cache management --------------------------------------------------
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
                key, lifted, class_caps, len(values)))
        params = {f"__p{i}": v for i, v in enumerate(values)}
        return entry, params, env_c

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

    def _compile_cp(self, lifted: N.Program
                    ) -> Tuple[M.ShreddedProgram, CG.CompiledProgram]:
        sp = M.shred_program(lifted, self.input_types,
                             domain_elimination=self.domain_elim)
        cp = CG.compile_program(sp, self.catalog,
                                skew_mode=self.skew_mode,
                                skew_partitions=self.skew_partitions,
                                skew_threshold=self.skew_threshold,
                                hypercube_mode=self.hypercube_mode,
                                cost_mode=self.cost_mode)
        return sp, cp

    def _compile(self, key: tuple, lifted: N.Program,
                 class_caps: Dict[str, int],
                 n_params: int = 0) -> CacheEntry:
        with _span("query.compile", path="local",
                   assignments=len(lifted.assignments)):
            sp, cp = self._compile_cp(lifted)
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
        ``storage.StoredDataset`` (routed through ``execute_stored``)."""
        if hasattr(env, "load_env"):       # storage.StoredDataset
            return self.execute_stored(program, env,
                                       skew_hints=skew_hints)
        assert not hasattr(env, "ensure_loaded"), (
            "QueryService.execute received a lazy StorageEnv; pass the "
            "StoredDataset itself (execute / execute_stored), or run "
            "the eager path via codegen.run_flat_program")
        with _span("query.execute", path="local"):
            entry, params, env_c = self._lookup(program, env, skew_hints)
            return entry.exe(env_c, params)

    def execute_many(self, programs: Sequence[N.Program],
                     env: Dict[str, FlatBag]) -> List[Dict[str, FlatBag]]:
        """Batched invocations of one query family (the reference runs
        them under ``jax.vmap``). Not ported yet."""
        raise _unported("execute_many (batching over parameters)",
                        "item 7")

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

    def _lookup_stored(self, program: N.Program, dataset,
                       skew_hints: Optional[dict] = None,
                       no_skip: bool = False, verify: bool = False
                       ) -> Tuple[CacheEntry, Dict[str, object],
                                  Dict[str, FlatBag]]:
        from repro_torch.storage import storage_requirements
        key, lifted, values = self.fingerprint_stored(program, dataset,
                                                      skew_hints)
        entry = self._cache.get(key)
        if entry is not None:
            self._touch(key, entry)
        else:
            with _span("query.compile", path="stored",
                       assignments=len(lifted.assignments)):
                sp, cp = self._compile_cp(lifted)
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
        base, lifted, values = self.fingerprint_stored(program, dataset,
                                                       skew_hints)
        key = base + (("morsel", root, int(morsel_rows)),)
        entry = self._cache.get(key)
        if entry is not None:
            self._touch(key, entry)
        else:
            sp, cp = self._compile_cp(lifted)
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
        """Populate the cache by running the program once."""
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
