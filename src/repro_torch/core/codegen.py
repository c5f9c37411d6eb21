"""Code generation (paper §3.2/§4.6) — running compiled plans over the
columnar backend, locally or on the sites of a virtual mesh (PyTorch twin
of ``repro.core.codegen``).

* ``compile_program``   — compiles a materialized shredded program
  (output of ``materialization.shred_program``) into a ``ProgramGraph``:
  per-assignment plan passes, then the whole-program passes (dead
  assignment/column elimination driven by what ``unshred_parts``
  consumes, cross-assignment CSE — see core.plans).
* ``run_flat_program``  — evaluates the compiled node sequence eagerly,
  returning the environment of FlatBags.
* ``jit_program``       — the plan-cached executable of a whole program:
  ``N.Param`` bindings arrive as runtime arguments, and ``TRACE_STATS``
  counts one "trace" per new input signature, as ``jax.jit``'s cache
  would, so a warm call with new parameter values counts nothing.
* ``vmap_program``      — that executable's body run once over a batch
  axis of stacked parameter bindings (``torch.func.vmap``), the
  reference's ``jax.jit(jax.vmap(raw_fn, in_axes=(None, 0)))``.
* ``columnar_shred_inputs`` — value-shreds nested Python rows into
  FlatBags (the columnar twin of interpreter.shred_value).
* ``unshred_parts``     — the cogroup step: clusters every dictionary by
  label and derives CSR offsets (the UNSHRED cost in the paper).
* ``compile_program_distributed`` — the same schedule on every site of
  a virtual mesh (``exec.dist``), with ``DistRunner`` as its warm path.
* ``run_standard``      — executes a StandardPlan (wide flattening +
  bottom-up Gamma_u nest rebuild), returning nested *parts*.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.columnar.table import FlatBag, resolve_device
from repro_torch.errors import CompileError
from repro_torch.faults import FAULTS
from repro_torch.exec import ops as X
from . import interpreter as I
from . import nrc as N
from .materialization import ShreddedProgram, mat_input_name
from .plans import ExecSettings, Plan, ProgramGraph, \
    annotate_orders, annotate_partitioning, apply_hypercube_program, \
    apply_skew_program, as_scalar_tensor, build_program_graph, \
    collect_params, cse_program, dce_program, eval_plan, \
    prune_program_columns, push_aggregation, push_order, push_partitioning
from .unnesting import Catalog, StandardPlan, compile_flat_query


# ---------------------------------------------------------------------------
# schemas / ingest
# ---------------------------------------------------------------------------

def schema_of(elem: N.TupleT, where: str = "") -> Dict[str, str]:
    """Columnar schema of a flat tuple type. ``where`` names the
    assignment / input and attribute path for error messages."""
    out = {}
    ctx = f" (in {where})" if where else ""
    for n, t in elem.fields:
        if isinstance(t, N.LabelT):
            out[n] = "label"
        elif isinstance(t, N.ScalarT):
            out[n] = t.kind
        else:
            raise TypeError(
                f"schema_of: attribute {n!r}{ctx} has non-flat type "
                f"{t!r}; a FlatBag column must be scalar- or "
                f"label-typed — nested bags belong in their own "
                f"materialized dictionary (R__D_<path>), so this "
                f"usually means the value was not shredded before "
                f"ingest (use shred_program / columnar_shred_inputs)")
    return out


def columnar_shred_inputs(inputs: Dict[str, list],
                          input_types: Dict[str, N.BagT],
                          capacities: Optional[Dict[str, int]] = None,
                          encoders: Optional[dict] = None,
                          device=None) -> Dict[str, FlatBag]:
    """Value-shred nested inputs to FlatBags keyed by the materialized
    names (R__F / R__D_<path>) on ``device`` (None = the GPU). Flat
    inputs load directly as R__F."""
    dev = resolve_device(device)
    capacities = capacities or {}
    encoders = encoders if encoders is not None else {}
    env: Dict[str, FlatBag] = {}
    for name, rows in inputs.items():
        ty = input_types[name]
        parts = I.shred_value(rows, ty, root=name)
        for path, bag_rows in parts.items():
            key = mat_input_name(name, path)
            flat = _flat_elem(ty, path, root=name)
            schema = schema_of(flat, where=f"input {key}")
            if path:
                schema["label"] = "label"
            env[key] = FlatBag.from_rows(bag_rows, schema,
                                         capacity=capacities.get(key),
                                         encoders=encoders, device=dev)
    return env


def _flat_elem(ty: N.BagT, path: tuple, root: str) -> N.TupleT:
    cur: N.Type = ty
    for a in path:
        assert isinstance(cur, N.BagT)
        elem = cur.elem
        assert isinstance(elem, N.TupleT)
        cur = elem.field(a)
    assert isinstance(cur, N.BagT)
    tagroot = f"{root}.{'.'.join(path)}" if path else root
    flat = N.flat_type(cur, path=tagroot)
    assert isinstance(flat.elem, N.TupleT)
    return flat.elem


# ---------------------------------------------------------------------------
# shredded route execution
# ---------------------------------------------------------------------------

@dataclass
class CompiledProgram:
    plans: List[Tuple[str, Plan]]          # (node name, plan), topo order
    shredded: ShreddedProgram
    graph: Optional[ProgramGraph] = None   # whole-program DAG (post-passes)
    outputs: tuple = ()                    # externally consumed names
    # SkewJoinP provenance: heavy-key param name -> (bag, attr)
    skew_params: Dict[str, Tuple[str, str]] = dc_field(
        default_factory=dict)
    # cost-based planning: per-node root-row estimates
    estimates: Dict[str, Optional[int]] = dc_field(default_factory=dict)

    def pretty(self) -> str:
        from .plans import plan_pretty
        out = []
        for name, p in self.plans:
            out.append(f"{name} <=")
            out.append(plan_pretty(p, 1))
            out.append("")
        return "\n".join(out)


def program_outputs(sp: ShreddedProgram) -> tuple:
    """The names ``unshred_parts`` consumes: every manifest's top bag
    and materialized dictionaries (order-preserving, deduplicated)."""
    outs: List[str] = []
    for man in sp.manifests.values():
        outs.append(man.top)
        outs.extend(man.dicts.values())
    return tuple(dict.fromkeys(outs))


def compile_program(sp: ShreddedProgram, catalog: Optional[Catalog] = None,
                    optimize: bool = True, cse: bool = True,
                    outputs: Optional[tuple] = None,
                    skew_stats: Optional[dict] = None,
                    skew_mode: str = "auto",
                    skew_partitions: int = 8,
                    skew_threshold: float = 0.025,
                    hypercube_mode: str = "auto",
                    cost_mode: str = "off",
                    observed_rows: Optional[dict] = None
                    ) -> CompiledProgram:
    with _span("compile", kind="plan",
               assignments=len(sp.program.assignments)):
        return _compile_program_impl(
            sp, catalog, optimize, cse, outputs, skew_stats, skew_mode,
            skew_partitions, skew_threshold, hypercube_mode, cost_mode,
            observed_rows)


def _compile_program_impl(sp, catalog, optimize, cse, outputs, skew_stats,
                          skew_mode, skew_partitions, skew_threshold,
                          hypercube_mode, cost_mode="off",
                          observed_rows=None) -> CompiledProgram:
    """Compile the assignment sequence into a ProgramGraph.

    Per-assignment passes (aggregation/order/partitioning pushdown) run
    first; then the whole-program passes: dead-assignment elimination
    and dead-column pruning driven by ``outputs`` (default: everything
    unshredding consumes), and cross-assignment CSE so structurally
    identical subplans between TOP and dictionary assignments are
    hash-consed into shared nodes.

    ``skew_stats`` ({bag: skew.TableStats}, typically from
    ``storage.table_stats``) turns on the automatic skew pass
    (``skew_mode="auto"``): joins whose probe-side heavy-hitter
    statistics predict imbalance over ``skew_partitions`` become
    ``SkewJoinP`` nodes with the heavy-key set lifted as a runtime
    parameter. ``skew_mode="off"`` disables the pass regardless of
    statistics (the forced-off baseline).

    ``hypercube_mode="auto"`` additionally lets the HyperCube pass
    rewrite multiway equi-join chains to one-round ``MultiJoinP``
    exchanges when the statistics predict the replicated single round
    ships fewer rows than the binary cascade; ``"off"`` keeps the
    cascade (the comparison baseline).

    ``cost_mode="auto"`` turns on cost-based planning
    (``repro_torch.core.cost``, a copy of the reference's): a
    cardinality estimator over ``skew_stats`` reorders inner fk
    equi-join chains before the skew / hypercube passes peel them,
    prices the hypercube-vs-cascade gate with estimated intermediates,
    makes fuse-vs-unfuse under skew a costed choice, and annotates every
    plan node with ``est_rows``. ``observed_rows`` ({plan-signature
    digest: measured rows}) overrides formula estimates on recompile.
    ``cost_mode="off"`` (the default) keeps every decision identical to
    the cost-free compiler."""
    assert skew_mode in ("auto", "off"), skew_mode
    assert hypercube_mode in ("auto", "off"), hypercube_mode
    assert cost_mode in ("auto", "off"), cost_mode
    catalog = catalog or Catalog()
    named: List[Tuple[str, Plan]] = []
    roles: Dict[str, str] = {}
    for a in sp.program.assignments:
        plan = compile_flat_query(a.expr, catalog)
        if optimize:
            plan = push_aggregation(plan)
            plan = push_order(plan)
            plan = push_partitioning(plan)
        named.append((a.name, plan))
        roles[a.name] = a.role
    outs = tuple(outputs) if outputs is not None else program_outputs(sp)
    graph = build_program_graph(named, outs, roles)
    skew_info: Dict[str, tuple] = {}
    estimator = None
    estimates: Dict[str, Optional[int]] = {}
    if cost_mode == "auto":
        from .cost import CardinalityEstimator, order_join_chains
        estimator = CardinalityEstimator(skew_stats or {},
                                         n_partitions=skew_partitions,
                                         observed=observed_rows)
    if optimize:
        graph = dce_program(graph)
        graph = prune_program_columns(graph)
        if cse:
            graph = cse_program(graph)
        if estimator is not None:
            # decision (a): costed join ordering, before the skew and
            # hypercube passes so both see the chosen chain order
            order_join_chains(graph, estimator)
        if skew_stats is not None and skew_mode == "auto":
            skew_info = apply_skew_program(graph, skew_stats,
                                           n_partitions=skew_partitions,
                                           threshold=skew_threshold,
                                           estimator=estimator)
        if skew_stats is not None and hypercube_mode == "auto":
            # after the skew pass: chains absorb SkewJoinP heavy-key
            # params into per-dimension hypercube spreading, keeping
            # the same parameter names (warm rebinds stay retrace-free)
            apply_hypercube_program(graph, skew_stats,
                                    n_partitions=skew_partitions,
                                    estimator=estimator)
        # annotate last: the pruning pass rebuilds every node, which
        # would discard the EXPLAIN attributes
        for nd in graph.nodes:
            annotate_orders(nd.plan)
            annotate_partitioning(nd.plan)
    if estimator is not None:
        # est_rows on every node, post-passes (the serving cache
        # snapshots the per-node roots)
        estimates = estimator.annotate_graph(graph)
    return CompiledProgram([(nd.name, nd.plan) for nd in graph.nodes],
                           sp, graph, outs,
                           skew_params={k: (bag, attr) for
                                        k, (bag, attr, _) in
                                        skew_info.items()},
                           estimates=estimates)


def run_flat_program(cp: CompiledProgram, env: Dict[str, FlatBag],
                     settings: Optional[ExecSettings] = None
                     ) -> Dict[str, FlatBag]:
    """Eager evaluation of the program DAG (one eval per node in topo
    order — shared CSE nodes therefore evaluate once)."""
    settings = settings or ExecSettings()
    env = dict(env)
    for name, plan in cp.plans:
        env[name] = eval_plan(plan, env, settings)
    return env


# ---------------------------------------------------------------------------
# whole-program executable (the plan-cache unit)
# ---------------------------------------------------------------------------

from repro_torch.obs.metrics import REGISTRY as _METRICS  # noqa: E402
from repro_torch.obs.metrics import host_recording_as  # noqa: E402
from repro_torch.obs.trace import span as _span  # noqa: E402

TRACE_STATS = _METRICS.view("trace")
"""Host-side trace counter — live view onto the metrics registry under
the ``trace.`` domain. It moves once per input signature an executable
has not seen (what ``jax.jit`` would retrace for); warm plan-cache calls
keep it flat."""


def reset_trace_stats() -> None:
    TRACE_STATS.clear()


def _compile_fault(what: str) -> None:
    """``codegen.compile`` fault site: ``fail`` models a failed compile
    (raises transient ``CompileError``), ``delay`` a cold-compile latency
    spike (sleeps ``arg`` seconds)."""
    rule = FAULTS.hit("codegen.compile", what=what)
    if rule is None:
        return
    if rule.kind == "fail":
        raise CompileError(f"injected compile failure ({what})")
    if rule.kind == "delay":
        import time
        time.sleep(float(rule.arg or 0.01))


def _signature(env: Dict[str, FlatBag], params: Dict[str, torch.Tensor]
               ) -> tuple:
    """What a ``jax.jit`` cache keys on: every input bag's column names,
    dtypes and capacity (and device), and every parameter's dtype and
    shape — never the values."""
    bags = tuple((name, bag.capacity, str(bag.device),
                  tuple(sorted((c, str(a.dtype))
                               for c, a in bag.data.items())))
                 for name, bag in sorted(env.items()))
    ps = tuple((k, str(v.dtype), tuple(v.shape))
               for k, v in sorted(params.items()))
    return bags, ps


@dataclass
class ProgramExecutable:
    """The executable of a whole shredded program. Calling it with an
    environment (and optional parameter bindings for the program's
    ``N.Param``s) returns the output bags. PyTorch runs eagerly, so
    there is nothing to compile; ``TRACE_STATS`` still counts each new
    input signature once, so warm calls show zero "traces"."""
    cp: CompiledProgram
    outputs: tuple
    param_defaults: Dict[str, object]
    _fn: Callable
    raw_fn: Callable                       # the program body itself
    # names accepted by bind() beyond the referenced params: lifted
    # constants whose expression the dead-code/column passes eliminated
    accepted: frozenset = frozenset()

    def bind(self, params: Optional[Dict[str, object]] = None
             ) -> Dict[str, torch.Tensor]:
        """Full binding dict for a call: defaults overridden by
        ``params``, as host tensors with the reference's dtypes."""
        p = dict(self.param_defaults)
        if params:
            unknown = set(params) - set(p) - self.accepted
            assert not unknown, (
                f"unknown parameter(s) {sorted(unknown)}; this program "
                f"binds {sorted(p)}"
                + (f" and tolerates eliminated {sorted(self.accepted)}"
                   if self.accepted else ""))
            p.update({k: v for k, v in params.items() if k in p})
        return {k: as_scalar_tensor(v, "cpu") for k, v in p.items()}

    def __call__(self, env: Dict[str, FlatBag],
                 params: Optional[Dict[str, object]] = None
                 ) -> Dict[str, FlatBag]:
        return self._fn(env, self.bind(params))


def jit_program(cp: CompiledProgram,
                settings: Optional[ExecSettings] = None,
                jit: bool = True, donate_env: bool = False
                ) -> ProgramExecutable:
    """The program DAG as ONE topologically scheduled callable. With
    ``jit=True`` calls are keyed on their input signature, and a
    signature seen before counts no trace (the plan-cache contract);
    ``jit=False`` counts every call, as an un-jitted function would.

    ``donate_env=True`` donates the input environment: after each call
    the executable empties the ``env`` dict it was given, dropping its
    references to the env's tensors, so that on the card their memory
    can be reused once the caller holds no other reference. One-shot
    pipelines only: a donated env is unusable afterwards, as the
    reference's donated buffers are."""
    _compile_fault("jit_program")
    base = settings or ExecSettings()
    outputs = tuple(cp.outputs) or tuple(n for n, _ in cp.plans)

    def fn(env, params):
        s = ExecSettings(use_kernel=base.use_kernel,
                         default_expansion=base.default_expansion,
                         dist=None, params=params)
        # a fresh FlatBag per input drops the physical-props caches, as
        # the reference's jit boundary does: every call starts cold
        local = {k: FlatBag(b.data, b.valid) for k, b in env.items()}
        for name, plan in cp.plans:
            local[name] = eval_plan(plan, local, s)
        return {o: local[o] for o in outputs}

    seen: set = set()

    def cfn(env, params):
        sig = _signature(env, params) if jit else None
        if sig is None or sig not in seen:
            TRACE_STATS["traces"] = TRACE_STATS.get("traces", 0) + 1
            with _span("compile", kind="xla_trace", path="local",
                       plans=len(cp.plans)):
                out = fn(env, params)
            if sig is not None:
                seen.add(sig)
        else:
            out = fn(env, params)
        if donate_env:
            env.clear()
        return out

    defaults = collect_params(cp.graph) if cp.graph is not None else {}
    return ProgramExecutable(cp, outputs, defaults, cfn, fn)


def vmap_program(exe: ProgramExecutable) -> Callable:
    """The program body run ONCE over a batch axis of its parameters:
    the reference's ``jax.jit(jax.vmap(exe.raw_fn, in_axes=(None, 0)))``.
    The callable takes an environment of FlatBags, shared by the batch,
    and stacked bindings ({name: tensor with a leading axis of B}), and
    returns the output bags with that leading axis on every column and
    on ``valid``.

    ``torch.func.vmap`` maps ``exe.raw_fn``, the bags crossing its
    boundary as plain (data, valid) pairs, inside
    ``kernels.ops.batched_pass()``: a kernel call with a batched operand
    launches the batched kernel once for the whole batch. Work that no
    parameter reaches runs once, unbatched. As the reference's jitted
    vmap, the callable counts a trace (``TRACE_STATS``, a ``compile``
    span) for each input signature it has not seen, and a warm call
    records no host telemetry from inside the body (``SORT_STATS``,
    ``EVAL_STATS``, spans), as a warm jitted call runs no Python."""
    from repro_torch.kernels import ops as kops

    def body(env, params):
        return {o: (b.data, b.valid)
                for o, b in exe.raw_fn(env, params).items()}

    vbody = torch.func.vmap(body, in_dims=(None, 0))
    seen: set = set()

    def run(env, stacked):
        with kops.batched_pass():
            return vbody(env, stacked)

    def call(env, stacked):
        sig = _signature(env, stacked)
        if sig in seen:
            with host_recording_as(False):
                out = run(env, stacked)
        else:
            TRACE_STATS["traces"] = TRACE_STATS.get("traces", 0) + 1
            with _span("compile", kind="xla_trace", path="local_batched",
                       plans=len(exe.cp.plans)):
                out = run(env, stacked)
            seen.add(sig)
        return {o: FlatBag(data, valid) for o, (data, valid) in out.items()}

    return call


def compile_program_distributed(
        cp: CompiledProgram, env: Dict[str, FlatBag], mesh,
        use_kernel: bool = False, outputs: Optional[tuple] = None,
        params: Optional[Dict[str, object]] = None,
        **dist_kwargs):
    """Run the SAME program schedule on every site of a virtual mesh:
    one ``exec.dist.compile_distributed`` run evaluates every node of
    the DAG (shared subplans once, exchanges elided across assignment
    boundaries via delivered partitionings). Returns ``(DistRunner,
    outputs, metrics)`` — the runner is the warm path, and
    ``adaptive=True`` resolves bucket capacities before the runner is
    handed out (the serving warmup).

    Runtime parameters — every ``N.Param`` of the program plus every
    ``SkewJoinP`` heavy-key set — reach every site (defaults overridden
    by ``params``), so a warm ``runner(env, params=new_bindings)``
    rebinds new values with ZERO retracing, exactly like the local path
    (``TRACE_STATS`` moves only on a compile attempt)."""
    _compile_fault("dist")
    from repro_torch.exec import dist as D
    outs = tuple(outputs) if outputs is not None \
        else (tuple(cp.outputs) or tuple(n for n, _ in cp.plans))
    defaults = collect_params(cp.graph) if cp.graph is not None else {}
    if params:
        unknown = set(params) - set(defaults)
        assert not unknown, (
            f"unknown parameter(s) {sorted(unknown)}; this program "
            f"binds {sorted(defaults)}")
        defaults.update(params)
    # a defaultless N.Param the caller did not bind stays out of the
    # bindings — evaluation then raises its own clear unbound error
    defaults = {k: v for k, v in defaults.items() if v is not None}

    def fn(env_local, ctx, params_local):
        # host-side, like the reference's counter inside the traced
        # function: only site 0 of a compile attempt records it
        TRACE_STATS["traces"] = TRACE_STATS.get("traces", 0) + 1
        with _span("compile", kind="xla_trace", path="dist",
                   plans=len(cp.plans)):
            s = ExecSettings(use_kernel=use_kernel, dist=ctx,
                             params=params_local)
            local = dict(env_local)
            for name, plan in cp.plans:
                local[name] = eval_plan(plan, local, s)
            return {o: local[o] for o in outs}

    return D.compile_distributed(fn, env, mesh, use_kernel=use_kernel,
                                 params=defaults, **dist_kwargs)


# ---------------------------------------------------------------------------
# standard route execution
# ---------------------------------------------------------------------------

def run_standard(sp: StandardPlan, env: Dict[str, FlatBag],
                 settings: Optional[ExecSettings] = None
                 ) -> Dict[tuple, FlatBag]:
    """Execute a StandardPlan; returns nested output as parts
    {path: FlatBag} (non-root parts carry a ``label`` column)."""
    settings = settings or ExecSettings()
    bag = eval_plan(sp.wide, env, settings)
    parts: Dict[tuple, FlatBag] = {}

    def flags_and(b: FlatBag, cols: tuple) -> torch.Tensor:
        m = torch.ones(b.capacity, dtype=torch.bool, device=b.device)
        for c in cols:
            if c in b.data:
                m = m & b.col(c)
        return m

    # nested-to-flat: single aggregate at the top, no nest levels
    if sp.flat_agg is not None:
        keys, vals = sp.flat_agg
        ext = {out: bag.col(col) for out, col in sp.top_rename}
        all_matched = tuple(c for c in bag.data if c.startswith("__m."))
        mask = flags_and(bag, all_matched)
        bag = bag.with_columns(**ext).mask(mask)
        out = X.sum_by(bag, keys, vals, use_kernel=settings.use_kernel)
        parts[()] = out.select_columns(list(keys) + list(vals))
        return parts

    for spec in sp.nests:  # bottom-up
        mflag = flags_and(bag, spec.matched_cols)
        if spec.sum_agg is not None:
            agg_keys, agg_vals = spec.sum_agg
            ext = {}
            for out_name, col in spec.rename:
                if out_name in agg_keys:
                    ext[out_name] = bag.col(col)
                elif out_name in agg_vals:
                    v = bag.col(col)
                    ext[out_name] = torch.where(mflag, v, torch.zeros_like(v))
            ext["__mcnt"] = mflag.to(torch.int64)
            bag2 = bag.with_columns(**ext)
            agg = X.sum_by(bag2, tuple(spec.group_cols) + tuple(agg_keys),
                           tuple(agg_vals) + ("__mcnt",),
                           use_kernel=settings.use_kernel)
            agg = agg.with_columns(__cv=agg.col("__mcnt") > 0)
            child_cols = tuple(agg_keys) + tuple(agg_vals)
            parents, children = X.nest_level(
                agg, spec.group_cols, child_cols, spec.label_col,
                child_valid_col="__cv", use_kernel=settings.use_kernel)
        else:
            ext = {out_name: bag.col(col) for out_name, col in spec.rename
                   if col in bag.data}
            bag2 = bag.with_columns(**ext, __cv=mflag)
            child_cols = tuple(out for out, _ in spec.rename)
            parents, children = X.nest_level(
                bag2, spec.group_cols, child_cols, spec.label_col,
                child_valid_col="__cv", use_kernel=settings.use_kernel)
        parts[spec.path] = FlatBag(
            {"label": children.col(spec.label_col),
             **{c: children.col(c) for c in child_cols}},
            children.valid)
        # parent label column becomes available for the level above
        bag = parents

    # top level
    top_matched = tuple(c for c in bag.data if c.startswith("__m."))
    mask = flags_and(bag, top_matched)
    data = {}
    for out_name, col in sp.top_rename:
        src = col if col in bag.data else out_name
        data[out_name] = bag.col(src)
    parts[()] = FlatBag(data, bag.valid & mask)
    return parts


# ---------------------------------------------------------------------------
# unshredding (cogroup): cluster dictionaries by label + CSR offsets
# ---------------------------------------------------------------------------

@dataclass
class CSRLevel:
    bag: FlatBag              # rows clustered by label
    sorted_labels: Optional[torch.Tensor]


def unshred_parts(parts: Dict[tuple, FlatBag]) -> Dict[tuple, CSRLevel]:
    """The UNSHRED step (paper §6): for each dictionary, cluster rows by
    label (sort) so each parent's bag is adjacent, and keep the sorted
    label array for CSR range lookup (searchsorted)."""
    out: Dict[tuple, CSRLevel] = {}
    for path, bag in parts.items():
        if path == ():
            out[path] = CSRLevel(bag, None)
            continue
        key = bag.col("label").to(torch.int64)
        key = torch.where(bag.valid, key, X.I64_MAX)
        if X.ORDER_AWARE and bag.props.invalid_last \
                and bag.props.sorted_prefix(("label",)):
            # dictionary already clustered by label (Gamma_u children of
            # an invalid-last input): the cogroup sort is free
            out[path] = CSRLevel(bag, key)
            continue
        order = torch.argsort(key, stable=True)
        data = {n: a[order] for n, a in bag.data.items()}
        out[path] = CSRLevel(FlatBag(data, bag.valid[order]), key[order])
    return out


def parts_to_rows(parts: Dict[tuple, FlatBag], ty: N.BagT,
                  decoders: Optional[dict] = None) -> list:
    """Host-side reconstruction of nested rows from parts (tests)."""
    host = {path: bag.to_rows(decoders) for path, bag in parts.items()}

    def attach(rows: list, elem: N.TupleT, path: tuple) -> list:
        out = []
        for r in rows:
            row = {}
            for n, t in elem.fields:
                if isinstance(t, N.BagT):
                    sub = path + (n,)
                    lab = r[n]
                    kids = [dict(k) for k in host.get(sub, [])
                            if k["label"] == lab]
                    for k in kids:
                        k.pop("label")
                    sub_elem = t.elem
                    assert isinstance(sub_elem, N.TupleT)
                    row[n] = attach(kids, sub_elem, sub)
                else:
                    row[n] = r[n]
            out.append(row)
        return out

    top = [dict(r) for r in host[()]]
    elem = ty.elem
    assert isinstance(elem, N.TupleT)
    return attach(top, elem, ())
