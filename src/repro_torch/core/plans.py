"""Plan language (paper §2.2) — algebraic IR between NRC and columnar
execution, with the optimizer hooks of §3.3.

Plan nodes reference *columns* of wide bags. Column names are
``alias.attr`` (alias = the NRC loop variable that introduced the bag).
Scalar expressions inside nodes (predicates, projections) reuse the NRC
expression AST with Var(name=<column>).

The evaluator (``eval_plan``) runs a plan over an environment of
FlatBags on one device (PyTorch twin of ``repro.core.plans``; the
distributed context and the skew and HyperCube passes come with later
slices of the port). ``morsel_fold`` says how a morsel-streamed run's
per-morsel outputs re-fold into the one-shot answer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.columnar.table import FlatBag
from repro_torch.exec import ops as X
from . import nrc as N

I64_MAX = torch.iinfo(torch.int64).max


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

class Plan:
    pass


@dataclass
class ScanP(Plan):
    bag: str          # environment key
    alias: str        # column prefix for this bag's attributes
    with_rowid: bool = False  # add 'alias.__rowid' (paper's unique IDs)


@dataclass
class SelectP(Plan):
    child: Plan
    pred: N.Expr      # BOOL-typed column expression


@dataclass
class MapP(Plan):
    child: Plan
    outputs: tuple    # ((out_col, N.Expr), ...) — full projection list
    extend: bool = False  # keep child columns, add outputs (derived cols)


@dataclass
class JoinP(Plan):
    left: Plan
    right: Plan
    left_on: tuple    # column names
    right_on: tuple
    how: str = "inner"           # inner | left_outer
    unique_right: bool = True    # fk join (capacity-preserving) if True
    expansion: float = 1.0       # general-join capacity factor
    broadcast: bool = False      # distribution hint: broadcast right side
    skew_aware: bool = False     # §5 skew-triple processing
    matched_col: str = "__matched"


@dataclass
class SumAggP(Plan):
    child: Plan
    keys: tuple
    vals: tuple
    local_preagg: bool = False   # aggregation pushdown: pre-agg per partition
    # distributed exchange key (a subset of ``keys`` chosen by
    # push_partitioning so downstream consumers can reuse the delivered
    # partitioning); None => exchange on the full key tuple
    exchange_on: Optional[tuple] = None


@dataclass
class DeDupP(Plan):
    child: Plan
    cols: Optional[tuple] = None
    exchange_on: Optional[tuple] = None


@dataclass
class UnionP(Plan):
    left: Plan
    right: Plan


@dataclass
class OuterUnnestP(Plan):
    """Pair parent rows wide with child rows (standard route mu-bar).
    ``child_bag`` is a parts bag whose ``child_label`` points at
    ``parent_label`` column of the parent plan."""
    parent: Plan
    child_bag: str
    alias: str
    parent_label: str   # column in parent output
    child_label: str    # attr in child bag
    expansion: float = 1.0
    matched_col: str = "__matched"
    rowid_col: Optional[str] = None


@dataclass
class FusedJoinAggP(Plan):
    """Physical fusion of a unique-build JoinP feeding Gamma+ (the
    ``join -> sum_by`` chain of every shredded benchmark plan). The
    evaluator runs join and aggregation as one pipeline: the join output
    stays row-aligned with the probe side, so its delivered ordering and
    packed-key caches flow into the aggregation and the probe side is
    sorted at most once (asserted by the SORT_STATS fusion tests)."""
    join: JoinP
    keys: tuple
    vals: tuple
    local_preagg: bool = False
    exchange_on: Optional[tuple] = None


@dataclass
class SkewJoinP(Plan):
    """Compiler-selected skew-resilient join (paper §5 / Beame et al.):
    probe rows whose key is in the *heavy-key set* stay in place while
    the matching build rows broadcast; everything else takes the normal
    light-path hash exchange. Inserted by ``apply_skew_program`` when
    heavy-hitter statistics (storage zone maps + the streaming
    heavy-key sketch) predict partition imbalance.

    The heavy-key set is a RUNTIME PARAMETER: ``heavy_param`` names a
    padded ``(max_heavy,)`` int64 binding (``skew.pad_heavy``) supplied
    through ``ExecSettings.params``, with ``heavy_default`` as the
    plan-time value. One compiled plan therefore serves every heavy-key
    set of the family — warm calls rebind with zero retraces, exactly
    like ``N.Param``. Locally (no DistContext) the node evaluates as
    its plain embedded join: skew only changes data *placement*."""
    join: JoinP
    heavy_param: str
    heavy_default: tuple        # padded int64 key tuple (static shape)


@dataclass
class MultiJoinStage:
    """One build relation of a MultiJoinP: its plan plus the equi-join
    it contributes (left_on names columns of the accumulated spine)."""
    plan: Plan
    left_on: tuple
    right_on: tuple
    unique_right: bool = True
    expansion: float = 1.0


@dataclass
class MultiJoinP(Plan):
    """One-round multiway equi-join via HyperCube shuffle (Beame/
    Koutris/Suciu; D-FDB's exchange strategy). ``apply_hypercube_
    program`` rewrites an inner left-deep chain of JoinP/SkewJoinP into
    this node when TableStats predict the replicating single-round
    exchange is cheaper than the binary cascade.

    The device mesh is factored into per-join-attribute hash dimensions
    (``shares``, product <= P). Every participating relation —
    ``child`` (the probe spine) plus one per stage — is hashed on the
    dimensions whose key columns it carries and REPLICATED across the
    rest, so all stages probe locally after ONE packed collective.
    ``rel_routes[r]`` lists the routing of relation r (child first) as
    ``(dim, key_cols, role)`` with role "probe" (spine side of the
    equality) or "build" (the stage's right side).

    Heavy keys ride along per dimension: ``heavy_params[d]`` names the
    same runtime parameter the absorbed SkewJoinP carried (or None), so
    warm rebinds with new heavy-key sets stay zero-retrace. Heavy probe
    rows spread across their dimension by row index; the matching build
    rows replicate along it — the SkewJoinP broadcast residual,
    expressed in hypercube coordinates. Locally (no DistContext) the
    node degrades to the binary cascade: placement only, bit-for-bit
    parity."""
    child: Plan
    stages: tuple               # MultiJoinStage per join, chain order
    shares: tuple               # static per-dimension mesh share
    rel_routes: tuple           # per relation: ((dim, cols, role), ...)
    heavy_params: tuple         # per dimension: param name or None
    heavy_defaults: tuple       # per dimension: padded key tuple


@dataclass
class RefP(Plan):
    """Reference to a previously evaluated program node (a named
    assignment or a CSE-extracted shared subplan). Evaluates to the
    environment bag under a column rename:

    * ``rename``    — exact (old_col, new_col) pairs for explicitly
      named output columns (projections, derived keys);
    * ``alias_map`` — (old_alias, new_alias) pairs applied by prefix to
      scan-aliased columns (``old.attr`` -> ``new.attr``) whose full
      set is only known at runtime.

    Physical props are renamed, never copied — consumers of one shared
    node share its accumulated key/build/route caches."""
    name: str
    rename: tuple = ()
    alias_map: tuple = ()


def plan_pretty(p: Plan, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(p, ScanP):
        return f"{pad}Scan({p.bag} as {p.alias})"
    if isinstance(p, _PrunedScan):
        return (f"{pad}Scan({p.inner.bag} as {p.inner.alias}; "
                f"keep={sorted(p.keep)})")
    if isinstance(p, RefP):
        mods = []
        if p.alias_map:
            mods += [f"{a}->{b}" for a, b in p.alias_map]
        if p.rename:
            mods += [f"{a}->{b}" for a, b in p.rename]
        return f"{pad}Ref({p.name}" + (f"; {', '.join(mods)}" if mods
                                       else "") + ")"
    if isinstance(p, SelectP):
        return f"{pad}Select[{N.pretty(p.pred)}]\n{plan_pretty(p.child, indent+1)}"
    if isinstance(p, MapP):
        cols = ", ".join(c for c, _ in p.outputs)
        return f"{pad}Project[{cols}]\n{plan_pretty(p.child, indent+1)}"
    if isinstance(p, JoinP):
        kind = "Join" if p.how == "inner" else "OuterJoin"
        mods = []
        if p.broadcast:
            mods.append("broadcast")
        if p.skew_aware:
            mods.append("skew")
        if not p.unique_right:
            mods.append(f"general x{p.expansion}")
        mod = ("{" + ",".join(mods) + "}") if mods else ""
        return (f"{pad}{kind}{mod}[{p.left_on} = {p.right_on}]\n"
                f"{plan_pretty(p.left, indent+1)}\n"
                f"{plan_pretty(p.right, indent+1)}")
    if isinstance(p, SumAggP):
        pre = "{preagg}" if p.local_preagg else ""
        return (f"{pad}Gamma+{pre}[keys={p.keys} vals={p.vals}]\n"
                f"{plan_pretty(p.child, indent+1)}")
    if isinstance(p, DeDupP):
        return f"{pad}DeDup[{p.cols}]\n{plan_pretty(p.child, indent+1)}"
    if isinstance(p, UnionP):
        return (f"{pad}UnionAll\n{plan_pretty(p.left, indent+1)}\n"
                f"{plan_pretty(p.right, indent+1)}")
    if isinstance(p, OuterUnnestP):
        return (f"{pad}OuterUnnest[{p.child_bag} as {p.alias}, "
                f"{p.parent_label}={p.alias}.{p.child_label}]\n"
                f"{plan_pretty(p.parent, indent+1)}")
    if isinstance(p, FusedJoinAggP):
        return (f"{pad}FusedJoinAgg[keys={p.keys} vals={p.vals}]\n"
                f"{plan_pretty(p.join, indent+1)}")
    if isinstance(p, SkewJoinP):
        n = sum(1 for k in p.heavy_default if k != I64_MAX)
        return (f"{pad}SkewJoin[param={p.heavy_param} heavy={n}]\n"
                f"{plan_pretty(p.join, indent+1)}")
    if isinstance(p, MultiJoinP):
        hd = [d for d, h in enumerate(p.heavy_params) if h is not None]
        mod = f",heavy_dims={hd}" if hd else ""
        lines = [f"{pad}MultiJoin{{shares={p.shares}{mod}}}",
                 plan_pretty(p.child, indent + 1)]
        for st in p.stages:
            lines.append(f"{pad}  [{st.left_on} = {st.right_on}]")
            lines.append(plan_pretty(st.plan, indent + 2))
        return "\n".join(lines)
    return f"{pad}<{type(p).__name__}>"


# ---------------------------------------------------------------------------
# scalar column expressions -> torch
# ---------------------------------------------------------------------------

def as_scalar_tensor(v, device) -> torch.Tensor:
    """A constant or parameter value as a tensor on ``device``, with the
    dtype the reference gives it: float64 for a Python float, int64 for
    an int, bool for a bool (``torch.as_tensor(1.5)`` would be float32);
    numpy values and tensors keep their own dtype."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), dtype=torch.bool, device=device)
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int64, device=device)
    if isinstance(v, float):
        return torch.tensor(v, dtype=torch.float64, device=device)
    return torch.from_numpy(np.array(v)).to(device)


def _align(l: torch.Tensor, r: torch.Tensor):
    """A 0-d float constant meeting an integer or bool column promotes
    to the constant's float type in the reference; PyTorch would pick
    its default float32. Cast the column first."""
    if l.dim() == 0 and l.is_floating_point() and r.dim() > 0 \
            and not r.is_floating_point():
        r = r.to(l.dtype)
    elif r.dim() == 0 and r.is_floating_point() and l.dim() > 0 \
            and not l.is_floating_point():
        l = l.to(r.dtype)
    return l, r


def _true_divide(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``l / where(r == 0, 1, r)`` with the reference's result type:
    integer operands divide in float64 if they promote to int64, else
    in float32 (PyTorch would always pick float32)."""
    rt = torch.result_type(l, r)
    if not rt.is_floating_point:
        ft = torch.float64 if rt == torch.int64 else torch.float32
        l, r = l.to(ft), r.to(ft)
    return l / torch.where(r == 0, 1, r)


def eval_col_expr(e: N.Expr, bag: FlatBag,
                  params: Optional[Dict[str, object]] = None
                  ) -> torch.Tensor:
    if isinstance(e, N.Var):
        return bag.col(e.name)
    if isinstance(e, N.Const):
        return as_scalar_tensor(e.value, bag.device)
    if isinstance(e, N.Param):
        if params is not None and e.name in params:
            return as_scalar_tensor(params[e.name], bag.device)
        assert e.default is not None, (
            f"unbound parameter {e.name} with no default")
        return as_scalar_tensor(e.default, bag.device)
    if isinstance(e, N.Arith):
        l, r = _align(eval_col_expr(e.left, bag, params),
                      eval_col_expr(e.right, bag, params))
        if e.op == "/":
            return _true_divide(l, r)
        rt = torch.result_type(l, r)
        if rt != torch.bool:
            # a bool operand counts as 0/1 (PyTorch refuses bool "-")
            l, r = l.to(rt) if l.dtype == torch.bool else l, \
                r.to(rt) if r.dtype == torch.bool else r
        return {"+": torch.add, "-": torch.sub, "*": torch.mul}[e.op](l, r)
    if isinstance(e, N.Cmp):
        l, r = _align(eval_col_expr(e.left, bag, params),
                      eval_col_expr(e.right, bag, params))
        return {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                "<=": torch.le, ">": torch.gt, ">=": torch.ge}[e.op](l, r)
    if isinstance(e, N.BoolOp):
        l = eval_col_expr(e.left, bag, params)
        r = eval_col_expr(e.right, bag, params)
        return (l & r) if e.op == "&&" else (l | r)
    if isinstance(e, N.Not):
        return ~eval_col_expr(e.inner, bag, params)
    if isinstance(e, N.IfThen):
        c = eval_col_expr(e.cond, bag, params)
        t = eval_col_expr(e.then, bag, params)
        assert e.els is not None, "scalar if needs else in columnar exec"
        f = eval_col_expr(e.els, bag, params)
        t, f = _align(t, f)
        return torch.where(c, t, f)
    if isinstance(e, N.NewLabel):
        # columnar labels: one capture -> the key itself (exact);
        # multiple captures -> iterated splitmix64 combining. Captures
        # may themselves be 64-bit labels, so shift-packing is unsound;
        # construction and lookup sides evaluate the same expression, so
        # equality is preserved (collision odds ~2^-64, DESIGN §7).
        from repro_torch.exec.hashing import combine64, to_int64_like_xla
        return combine64([to_int64_like_xla(eval_col_expr(v, bag, params))
                          for _, v in e.captures])
    raise TypeError(f"eval_col_expr: {type(e).__name__} ({N.pretty(e)})")


def col_expr_deps(e: N.Expr) -> set:
    """Columns referenced by a column expression."""
    deps = set()

    def go(x):
        if isinstance(x, N.Var):
            deps.add(x.name)
        for c in N.children(x):
            go(c)

    go(e)
    return deps


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

from repro_torch.obs.metrics import REGISTRY as _METRICS

EVAL_STATS = _METRICS.view("eval")
"""Host-side operator-evaluation counters (like ``exec.ops.SORT_STATS``)
— a live view onto the metrics registry under the ``eval.`` domain. The
CSE tests assert a shared join subplan evaluates exactly once via
``EVAL_STATS['join']``."""


def reset_eval_stats() -> None:
    EVAL_STATS.clear()


def _ecount(name: str) -> None:
    _METRICS.inc("eval." + name)


@dataclass
class ExecSettings:
    """Execution knobs (the reference's fields). ``dist`` is one site's
    ``exec.dist.DistContext`` on the virtual mesh; ``explain`` is an
    ``obs.explain.ExplainRecorder`` that wraps every operator
    evaluation (EXPLAIN ANALYZE)."""
    use_kernel: bool = False        # CUDA kernels for Gamma+ and joins
    default_expansion: float = 1.0
    # distributed context (None => local, single partition)
    dist: Optional[object] = None
    # runtime parameter bindings for N.Param column expressions
    # (parameterized plan-cache execution; None => every Param falls
    # back to its lifted default)
    params: Optional[Dict[str, object]] = None
    # per-operator recorder for EXPLAIN ANALYZE
    explain: Optional[object] = None


def scan_keep_attrs(keep, alias: str) -> set:
    """Attribute names a pruned scan's keep set requests from its bag
    (strip the alias prefix; ``__rowid`` is generated, never stored).
    Shared by the evaluator, the program-level column pass and the
    storage requirements extraction so their namespaces cannot drift."""
    pre = alias + "."
    return {c[len(pre):] for c in keep
            if c.startswith(pre) and c[len(pre):] != "__rowid"}


def _storage_ensure(env, name: str, attrs: Optional[set],
                    params: Optional[Dict[str, object]] = None) -> None:
    """Storage-backed scan mode: a lazy environment (storage.StorageEnv)
    materializes missing input bags from disk on first scan, loading
    only ``attrs`` columns (None = all) and only the chunks its zone
    maps cannot refute — resolving ``N.Param`` predicates with the SAME
    bindings the evaluator will use (``ExecSettings.params``)."""
    ensure = getattr(env, "ensure_loaded", None)
    if ensure is not None:
        # called even when the bag is present: a later scan may need
        # MORE columns than the first pruned load brought in (the env
        # widens the loaded set; externally provided bags are left
        # untouched)
        ensure(name, attrs, params)


def _scan(env: Dict[str, FlatBag], name: str, alias: str,
          with_rowid: bool = False, ensure: bool = True,
          params: Optional[Dict[str, object]] = None) -> FlatBag:
    """Scan an environment bag under an alias. Memoized on the source
    bag's physical props: every ScanP of the same (bag, alias) across
    the assignment sequence returns ONE FlatBag instance, so key caches
    and build-side argsorts accumulate across the whole query bundle
    (a dictionary joined in three assignments argsorts once).
    ``ensure=False`` skips the full-column storage load — the pruned
    scan path has already ensured exactly its keep set."""
    if ensure:
        _storage_ensure(env, name, None, params)
    bag = env[name]
    memo_key = (alias, with_rowid)
    if X.ORDER_AWARE:
        hit = bag.props.scan_memo.get(memo_key)
        if hit is not None:
            return hit
    data = {f"{alias}.{c}": bag.data[c] for c in bag.data}
    if with_rowid:
        data[f"{alias}.__rowid"] = torch.arange(
            bag.capacity, dtype=torch.int64, device=bag.device)
    props = None
    if X.ORDER_AWARE:
        props = bag.props.renamed({c: f"{alias}.{c}" for c in bag.data})
    out = FlatBag(data, bag.valid, props)
    if X.ORDER_AWARE:
        bag.props.scan_memo[memo_key] = out
    return out


def eval_plan(p: Plan, env: Dict[str, FlatBag],
              s: Optional[ExecSettings] = None) -> FlatBag:
    s = s or ExecSettings()
    if s.explain is not None:
        # EXPLAIN ANALYZE: the recorder wraps every operator evaluation
        # (timing + metric deltas + row counts) and calls back into
        # _eval_plan_node; recursive child evaluations re-enter here,
        # so the whole subtree is recorded
        return s.explain.record(p, env, s, _eval_plan_node)
    return _eval_plan_node(p, env, s)


def _eval_plan_node(p: Plan, env: Dict[str, FlatBag],
                    s: ExecSettings) -> FlatBag:
    if isinstance(p, ScanP):
        return _scan(env, p.bag, p.alias, p.with_rowid, params=s.params)
    if isinstance(p, _PrunedScan):
        return _eval_pruned(p, env, s)
    if isinstance(p, RefP):
        return _eval_ref(p, env)
    if isinstance(p, SelectP):
        child = eval_plan(p.child, env, s)
        return X.select(child, eval_col_expr(p.pred, child, s.params))
    if isinstance(p, MapP):
        child = eval_plan(p.child, env, s)
        cols = {}
        for out, e in p.outputs:
            v = eval_col_expr(e, child, s.params)
            if v.dim() == 0:
                v = v.expand(child.capacity).contiguous()
            cols[out] = v
        if p.extend:
            return child.with_columns(**cols)
        out = X.project(child, cols)
        if X.ORDER_AWARE:
            # a projection is row-local (rows and validity unchanged):
            # physical properties survive for columns that pass through
            # as bare Vars, under the output name. Entries referencing
            # any non-passthrough column are dropped, which also guards
            # against an output name shadowing an unrelated child column.
            passthru = {e.name: o for o, e in p.outputs
                        if isinstance(e, N.Var)}
            cp = child.props
            sb = []
            for c in cp.sorted_by or ():
                if c not in passthru:
                    break
                sb.append(passthru[c])
            key_cache = {tuple(passthru[c] for c in cols_): v
                         for cols_, v in cp.key_cache.items()
                         if all(c in passthru for c in cols_)}
            part = cp.partitioning
            part = tuple(passthru[c] for c in part) \
                if part is not None and all(c in passthru for c in part) \
                else None
            if sb or key_cache or part:
                from repro_torch.columnar.props import PhysicalProps
                out = out.with_props(PhysicalProps(
                    key_cache=key_cache, sorted_by=tuple(sb) or None,
                    invalid_last=cp.invalid_last,
                    partitioning=part))
        return out
    if isinstance(p, JoinP):
        left = eval_plan(p.left, env, s)
        right = eval_plan(p.right, env, s)
        return _exec_join(p, left, right, s)
    if isinstance(p, SkewJoinP):
        left = eval_plan(p.join.left, env, s)
        right = eval_plan(p.join.right, env, s)
        return _exec_skew_join(p, left, right, s)
    if isinstance(p, MultiJoinP):
        return _exec_multi_join(p, env, s)
    if isinstance(p, SumAggP):
        child = eval_plan(p.child, env, s)
        _ecount("sum_by")
        if s.dist is not None:
            return s.dist.sum_by(child, p.keys, p.vals,
                                 local_preagg=p.local_preagg,
                                 use_kernel=s.use_kernel,
                                 exchange_on=p.exchange_on)
        return X.sum_by(child, p.keys, p.vals, use_kernel=s.use_kernel)
    if isinstance(p, DeDupP):
        child = eval_plan(p.child, env, s)
        cols = p.cols or tuple(child.columns)
        _ecount("dedup")
        if s.dist is not None:
            return s.dist.dedup(child, cols, exchange_on=p.exchange_on)
        return X.dedup(child, cols)
    if isinstance(p, UnionP):
        _ecount("union")
        return X.union_all(eval_plan(p.left, env, s),
                           eval_plan(p.right, env, s))
    if isinstance(p, OuterUnnestP):
        parent = eval_plan(p.parent, env, s)
        child = _scan(env, p.child_bag, p.alias, params=s.params)
        _ecount("unnest")
        out_cap = int(child.capacity * p.expansion) + parent.capacity
        bag, _ = X.flatten_child(parent, child, p.parent_label,
                                 f"{p.alias}.{p.child_label}", out_cap,
                                 outer=True, matched_col=p.matched_col,
                                 rowid_col=p.rowid_col,
                                 use_kernel=s.use_kernel)
        return bag
    if isinstance(p, FusedJoinAggP):
        left = eval_plan(p.join.left, env, s)
        right = eval_plan(p.join.right, env, s)
        joined = _exec_join(p.join, left, right, s)
        _ecount("sum_by")
        if s.dist is not None:
            return s.dist.sum_by(joined, p.keys, p.vals,
                                 local_preagg=p.local_preagg,
                                 use_kernel=s.use_kernel,
                                 exchange_on=p.exchange_on)
        return X.sum_by(joined, p.keys, p.vals, use_kernel=s.use_kernel)
    raise TypeError(f"eval_plan: {type(p).__name__}")


def _eval_ref(p: RefP, env: Dict[str, FlatBag]) -> FlatBag:
    """Fetch a shared program node's bag, renamed into this use site's
    column namespace. Arrays and physical-prop caches are shared."""
    _ecount("ref")
    if p.name not in env:
        raise KeyError(
            f"RefP: program node {p.name!r} not evaluated yet — shared "
            f"subplans must be scheduled before their first use")
    bag = env[p.name]
    exact = dict(p.rename)
    amap = dict(p.alias_map)
    mapping = {}
    for c in bag.data:
        if c in exact:
            mapping[c] = exact[c]
        else:
            head, sep, tail = c.partition(".")
            if sep and head in amap:
                mapping[c] = f"{amap[head]}.{tail}"
    if not mapping:
        return bag
    data = {mapping.get(c, c): a for c, a in bag.data.items()}
    props = None
    if X.ORDER_AWARE and bag._props is not None:
        props = bag.props.renamed(mapping)
    return FlatBag(data, bag.valid, props)


def _exec_skew_join(p: SkewJoinP, left: FlatBag, right: FlatBag,
                    s: ExecSettings) -> FlatBag:
    """Evaluate a planned skew join. Locally the heavy-key set is
    irrelevant (no rows to place) and the node degrades to its plain
    join — the differential parity guarantee. Under a DistContext the
    bound heavy-key array drives the light/heavy split."""
    j = p.join
    if s.dist is None:
        return _exec_join(j, left, right, s)
    _ecount("join")
    _ecount("skew_join")
    heavy = None
    if s.params is not None and p.heavy_param in s.params:
        heavy = _heavy_tensor(s.params[p.heavy_param], left.device)
    if heavy is None:
        heavy = _heavy_tensor(p.heavy_default, left.device)
    return s.dist.join(left, right, j.left_on, j.right_on, how=j.how,
                       unique_right=j.unique_right,
                       expansion=j.expansion, heavy_keys=heavy)


def _heavy_tensor(v, device) -> torch.Tensor:
    """A heavy-key binding (array, tensor or tuple) as int64 on
    ``device``."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)


def _exec_multi_join(p: MultiJoinP, env: Dict[str, FlatBag],
                     s: ExecSettings) -> FlatBag:
    """Evaluate a hypercube multiway join. Locally the hypercube is
    pure placement, so the node degrades to the binary cascade it
    replaced (the differential parity guarantee). Under a DistContext
    every relation is scattered to its hypercube slice in one packed
    replicating collective, then the stages probe locally."""
    spine = eval_plan(p.child, env, s)
    rights = [eval_plan(st.plan, env, s) for st in p.stages]
    if s.dist is not None:
        for _ in p.stages:
            _ecount("join")
        _ecount("multi_join")
        heavy = []
        for name, dflt in zip(p.heavy_params, p.heavy_defaults):
            if name is None:
                heavy.append(None)
            elif s.params is not None and name in s.params:
                heavy.append(_heavy_tensor(s.params[name], spine.device))
            else:
                heavy.append(_heavy_tensor(dflt, spine.device))
        return s.dist.multi_join(spine, rights, p.stages, p.shares,
                                 p.rel_routes, heavy,
                                 use_kernel=s.use_kernel)
    for st, right in zip(p.stages, rights):
        _ecount("join")
        if st.unique_right:
            spine = X.fk_join(spine, right, st.left_on, st.right_on,
                              how="inner", use_kernel=s.use_kernel)
        else:
            out_cap = int(max(spine.capacity, right.capacity)
                          * max(st.expansion, 1.0))
            spine, _ = X.general_join(
                spine, right, st.left_on, st.right_on, out_cap,
                how="inner", use_kernel=s.use_kernel)
    return spine


def _exec_join(p: JoinP, left: FlatBag, right: FlatBag,
               s: ExecSettings) -> FlatBag:
    _ecount("join")
    if s.dist is not None:
        return s.dist.join(left, right, p.left_on, p.right_on, how=p.how,
                           unique_right=p.unique_right,
                           broadcast=p.broadcast, skew_aware=p.skew_aware,
                           expansion=p.expansion)
    if p.unique_right:
        bag = X.fk_join(left, right, p.left_on, p.right_on, how=p.how,
                        use_kernel=s.use_kernel)
        if p.how == "left_outer" and p.matched_col != "__matched":
            bag.data[p.matched_col] = bag.data.pop("__matched")
        return bag
    # M:N capacity: dictionary joins fan out to the build side's
    # cardinality (1 label -> whole inner bag), so size by max of both
    out_cap = int(max(left.capacity, right.capacity) * max(p.expansion, 1.0))
    bag, _ = X.general_join(left, right, p.left_on, p.right_on, out_cap,
                            how=p.how, matched_col=p.matched_col,
                            use_kernel=s.use_kernel)
    return bag


# ---------------------------------------------------------------------------
# optimizer (§3.3): projection pushdown + aggregation pushdown
# ---------------------------------------------------------------------------

def required_columns(p: Plan, needed: Optional[set] = None,
                     ref_needs: Optional[dict] = None) -> Plan:
    """Projection pushdown: rebuild the plan so scans only carry columns
    that some ancestor actually uses. ``needed=None`` keeps everything
    (root).

    ``ref_needs`` (optional accumulator, used by the program-level
    dead-column pass): for every ``RefP`` encountered, the columns this
    plan needs from the referenced node are mapped back through the
    ref's rename into the *definition-site* namespace and unioned in as
    ``ref_needs[name] |= cols`` (``None`` = all)."""
    return _pushdown(p, needed, ref_needs)


def _ref_back(p: "RefP", needed: Optional[set]) -> Optional[set]:
    """Map use-site column names through a RefP's rename back to the
    referenced node's own column names. ``None`` passes through."""
    if needed is None:
        return None
    inv_exact = {new: old for old, new in p.rename}
    inv_alias = {new: old for old, new in p.alias_map}
    out = set()
    for c in needed:
        if c in inv_exact:
            out.add(inv_exact[c])
            continue
        head, sep, tail = c.partition(".")
        if sep and head in inv_alias:
            out.add(f"{inv_alias[head]}.{tail}")
        else:
            out.add(c)
    return out


def _pushdown(p: Plan, needed: Optional[set],
              ref_needs: Optional[dict] = None) -> Plan:
    if isinstance(p, RefP):
        if ref_needs is not None:
            back = _ref_back(p, needed)
            cur = ref_needs.get(p.name, set())
            ref_needs[p.name] = None if (back is None or cur is None) \
                else cur | back
        return p
    if isinstance(p, _PrunedScan):
        if needed is None:
            return p
        return _PrunedScan(p.inner, frozenset(set(p.keep) & needed))
    if isinstance(p, ScanP):
        if needed is None:
            return p
        # a scan only provides alias-prefixed columns: filter the junk
        # other branches contributed (a join pushes its full needed set
        # down both sides), keeping pruned-scan column sets canonical
        pre = p.alias + "."
        return _PrunedScan(p, frozenset(c for c in needed
                                        if c.startswith(pre)))
    if isinstance(p, SelectP):
        deps = col_expr_deps(p.pred)
        child_needed = None if needed is None else set(needed) | deps
        return SelectP(_pushdown(p.child, child_needed, ref_needs), p.pred)
    if isinstance(p, MapP):
        if p.extend:
            outs = p.outputs
            deps = set()
            for _, e in outs:
                deps |= col_expr_deps(e)
            if needed is None:
                child_needed = None
            else:
                child_needed = (set(needed) - {c for c, _ in outs}) | deps
            return MapP(_pushdown(p.child, child_needed, ref_needs), outs,
                        extend=True)
        if needed is not None:
            outs = tuple((c, e) for c, e in p.outputs if c in needed)
        else:
            outs = p.outputs
        deps = set()
        for _, e in outs:
            deps |= col_expr_deps(e)
        return MapP(_pushdown(p.child, deps, ref_needs), outs)
    if isinstance(p, JoinP):
        ln = None if needed is None else set(needed) | set(p.left_on)
        rn = None if needed is None else set(needed) | set(p.right_on)
        return JoinP(_pushdown(p.left, ln, ref_needs),
                     _pushdown(p.right, rn, ref_needs),
                     p.left_on, p.right_on, p.how, p.unique_right,
                     p.expansion, p.broadcast, p.skew_aware, p.matched_col)
    if isinstance(p, SumAggP):
        cn = set(p.keys) | set(p.vals)
        return SumAggP(_pushdown(p.child, cn, ref_needs), p.keys, p.vals,
                       p.local_preagg, p.exchange_on)
    if isinstance(p, DeDupP):
        cn = None if p.cols is None else set(p.cols)
        if needed is not None and cn is not None:
            cn |= needed
        return DeDupP(_pushdown(p.child, cn, ref_needs), p.cols,
                      p.exchange_on)
    if isinstance(p, UnionP):
        return UnionP(_pushdown(p.left, needed, ref_needs),
                      _pushdown(p.right, needed, ref_needs))
    if isinstance(p, OuterUnnestP):
        pn = None if needed is None else set(needed) | {p.parent_label}
        return OuterUnnestP(_pushdown(p.parent, pn, ref_needs), p.child_bag,
                            p.alias,
                            p.parent_label, p.child_label, p.expansion,
                            p.matched_col, p.rowid_col)
    if isinstance(p, FusedJoinAggP):
        cn = set(p.keys) | set(p.vals)
        j = p.join
        nj = JoinP(_pushdown(j.left, cn | set(j.left_on), ref_needs),
                   _pushdown(j.right, cn | set(j.right_on), ref_needs),
                   j.left_on, j.right_on, j.how, j.unique_right,
                   j.expansion, j.broadcast, j.skew_aware, j.matched_col)
        return FusedJoinAggP(nj, p.keys, p.vals, p.local_preagg,
                             p.exchange_on)
    if isinstance(p, SkewJoinP):
        return SkewJoinP(_pushdown(p.join, needed, ref_needs),
                         p.heavy_param, p.heavy_default)
    if isinstance(p, MultiJoinP):
        # every relation sees the full needed set plus all join keys;
        # scans filter to their own alias prefix, so the over-approx
        # costs nothing (same contract as JoinP pushing both sides)
        if needed is None:
            aug = None
        else:
            aug = set(needed)
            for st in p.stages:
                aug |= set(st.left_on) | set(st.right_on)
        return MultiJoinP(
            _pushdown(p.child, aug, ref_needs),
            tuple(MultiJoinStage(_pushdown(st.plan, aug, ref_needs),
                                 st.left_on, st.right_on,
                                 st.unique_right, st.expansion)
                  for st in p.stages),
            p.shares, p.rel_routes, p.heavy_params, p.heavy_defaults)
    raise TypeError(type(p).__name__)


@dataclass
class _PrunedScan(Plan):
    inner: ScanP
    keep: frozenset


def _eval_pruned(p: _PrunedScan, env, s) -> FlatBag:
    attrs = scan_keep_attrs(p.keep, p.inner.alias)
    _storage_ensure(env, p.inner.bag, attrs, s.params)
    bag = _scan(env, p.inner.bag, p.inner.alias, p.inner.with_rowid,
                ensure=False)
    keep = [c for c in bag.columns if c in p.keep]
    return bag.select_columns(keep)


def push_aggregation(p: Plan) -> Plan:
    """Aggregation pushdown (§3.3): when a Gamma+ sits above a join and
    the aggregate's value columns come entirely from the probe (left)
    side, compute partial sums below the join grouped by the join key +
    surviving key columns. Sound when the build side is unique on the
    join key (fk join), which the planner tracks via ``unique_right``."""
    if isinstance(p, SumAggP) and isinstance(p.child, JoinP):
        j = p.child
        left_cols = _plan_columns(j.left)
        if left_cols is None:
            return p
        vals_from_left = all(v in left_cols for v in p.vals)
        if j.unique_right and vals_from_left:
            keys_below = tuple(sorted((set(p.keys) & left_cols)
                                      | set(j.left_on)))
            inner = SumAggP(j.left, keys_below, p.vals)
            new_join = JoinP(inner, j.right, j.left_on, j.right_on, j.how,
                             j.unique_right, j.expansion, j.broadcast,
                             j.skew_aware, j.matched_col)
            return SumAggP(new_join, p.keys, p.vals)
    # recurse
    for attr in ("child", "left", "right", "parent"):
        if hasattr(p, attr):
            setattr(p, attr, push_aggregation(getattr(p, attr)))
    return p


def _plan_columns(p: Plan) -> Optional[set]:
    """Static column set of a plan's output (None if unknown)."""
    if isinstance(p, ScanP):
        return None  # unknown without env; treated as opaque
    if isinstance(p, _PrunedScan):
        return set(p.keep)
    if isinstance(p, MapP):
        return {c for c, _ in p.outputs}
    if isinstance(p, SelectP):
        return _plan_columns(p.child)
    if isinstance(p, SumAggP):
        return set(p.keys) | set(p.vals)
    if isinstance(p, JoinP):
        l, r = _plan_columns(p.left), _plan_columns(p.right)
        if l is None or r is None:
            return None
        return l | r
    if isinstance(p, DeDupP):
        return _plan_columns(p.child)
    if isinstance(p, FusedJoinAggP):
        return set(p.keys) | set(p.vals)
    if isinstance(p, SkewJoinP):
        return _plan_columns(p.join)
    if isinstance(p, MultiJoinP):
        cols = _plan_columns(p.child)
        if cols is None:
            return None
        for st in p.stages:
            rc = _plan_columns(st.plan)
            if rc is None:
                return None
            cols = cols | rc
        return cols
    return None


# ---------------------------------------------------------------------------
# physical ordering pass: annotate required/delivered orders, reorder
# key tuples for prefix sharing, fuse join->Gamma+ chains
# ---------------------------------------------------------------------------

def delivered_order(p: Plan) -> Optional[tuple]:
    """Ordering (column tuple, lexicographic over valid rows) the plan's
    output delivers at runtime — mirrors the FlatBag.props.sorted_by
    propagation of the physical operators."""
    if isinstance(p, SelectP):
        return delivered_order(p.child)   # masking preserves order
    if isinstance(p, MapP):
        d = delivered_order(p.child)
        if d is None:
            return None
        if p.extend:
            over = {c for c, _ in p.outputs}
            return d if not (set(d) & over) else None
        # non-extend: order columns survive via bare Var passthrough
        passthru = {e.name: out for out, e in p.outputs
                    if isinstance(e, N.Var)}
        pref = []
        for c in d:
            if c not in passthru:
                break
            pref.append(passthru[c])
        return tuple(pref) or None
    if isinstance(p, JoinP):
        return delivered_order(p.left)    # output is probe-side aligned
    if isinstance(p, SkewJoinP):
        return None     # distributed light+heavy union mixes row order
    if isinstance(p, (SumAggP, FusedJoinAggP)):
        return tuple(p.keys)
    if isinstance(p, DeDupP):
        return tuple(p.cols) if p.cols else None
    if isinstance(p, OuterUnnestP):
        return delivered_order(p.parent)  # left-major expansion
    return None


def required_order(p: Plan) -> Optional[tuple]:
    """Ordering the operator itself wants from its (probe-side) input —
    grouping ops want their key columns clustered."""
    if isinstance(p, (SumAggP, FusedJoinAggP)):
        return tuple(p.keys)
    if isinstance(p, DeDupP):
        return tuple(p.cols) if p.cols else None
    return None


def annotate_orders(p: Plan) -> Plan:
    """EXPLAIN support: attach ``p.required_ord`` / ``p.delivered_ord``
    to every node (the fusion tests and plan dumps read these)."""
    p.required_ord = required_order(p)
    p.delivered_ord = delivered_order(p)
    for c in _plan_children(p):
        annotate_orders(c)
    return p


def _prefix_reorder(keys: tuple, desired: Optional[tuple]) -> tuple:
    """Reorder a grouping key tuple (set semantics) so the columns the
    PARENT wants ordered come first, making the delivered ordering a
    usable prefix upstream. No-op when there is no overlap."""
    if not desired:
        return tuple(keys)
    ks = set(keys)
    head = [c for c in desired if c in ks]
    return tuple(head) + tuple(c for c in keys if c not in set(head))


def push_order(p: Plan, desired: Optional[tuple] = None) -> Plan:
    """Order-aware physical rewrite (run after push_aggregation, before
    projection pushdown):

    * grouping key tuples are reordered so a downstream grouping's keys
      form a *prefix* of the delivered lexicographic ordering — chains
      like Gamma+(G+A) -> Gamma_u(G) or dedup(K) above sum_by(K+...)
      then share one sort at runtime;
    * a Gamma+ directly above a unique-build join fuses into
      ``FusedJoinAggP`` — the one-pipeline join+aggregate whose probe
      side is sorted exactly once.
    """
    if isinstance(p, SumAggP):
        keys = _prefix_reorder(p.keys, desired)
        child = push_order(p.child, keys)
        if isinstance(child, JoinP) and child.unique_right:
            return FusedJoinAggP(child, keys, p.vals, p.local_preagg)
        return SumAggP(child, keys, p.vals, p.local_preagg)
    if isinstance(p, DeDupP):
        cols = _prefix_reorder(p.cols, desired) if p.cols else None
        return DeDupP(push_order(p.child, cols), cols)
    if isinstance(p, SelectP):
        return SelectP(push_order(p.child, desired), p.pred)
    if isinstance(p, MapP):
        if p.extend:
            over = {c for c, _ in p.outputs}
            down = tuple(c for c in desired or () if c not in over) or None
            return MapP(push_order(p.child, down), p.outputs, extend=True)
        # translate desired through bare-Var passthrough outputs
        srcs = {out: e.name for out, e in p.outputs if isinstance(e, N.Var)}
        down = tuple(srcs[c] for c in desired or () if c in srcs) or None
        return MapP(push_order(p.child, down), p.outputs)
    if isinstance(p, JoinP):
        return JoinP(push_order(p.left, desired),
                     push_order(p.right, tuple(p.right_on)),
                     p.left_on, p.right_on, p.how, p.unique_right,
                     p.expansion, p.broadcast, p.skew_aware, p.matched_col)
    if isinstance(p, OuterUnnestP):
        return OuterUnnestP(push_order(p.parent, desired), p.child_bag,
                            p.alias, p.parent_label, p.child_label,
                            p.expansion, p.matched_col, p.rowid_col)
    if isinstance(p, UnionP):
        return UnionP(push_order(p.left, None), push_order(p.right, None))
    if isinstance(p, SkewJoinP):
        return SkewJoinP(push_order(p.join, None), p.heavy_param,
                         p.heavy_default)
    if isinstance(p, MultiJoinP):
        return MultiJoinP(
            push_order(p.child, desired),
            tuple(MultiJoinStage(push_order(st.plan, tuple(st.right_on)),
                                 st.left_on, st.right_on,
                                 st.unique_right, st.expansion)
                  for st in p.stages),
            p.shares, p.rel_routes, p.heavy_params, p.heavy_defaults)
    return p


# ---------------------------------------------------------------------------
# physical partitioning pass: annotate required/delivered hash
# partitionings and pick exchange keys that maximize elision
# (mirrors push_order; see exec.dist for the runtime contract)
# ---------------------------------------------------------------------------

def delivered_partitioning(p: Plan) -> Optional[tuple]:
    """Column tuple the plan's distributed output is hash-partitioned on
    (the static mirror of ``FlatBag.props.partitioning``). Approximate
    in the elision direction only: it may under-report (runtime props
    are authoritative), never claims a partitioning the executor would
    not deliver."""
    if isinstance(p, SelectP):
        return delivered_partitioning(p.child)   # masking moves no rows
    if isinstance(p, MapP):
        d = delivered_partitioning(p.child)
        if d is None:
            return None
        if p.extend:
            over = {c for c, _ in p.outputs}
            return d if not (set(d) & over) else None
        passthru = {e.name: out for out, e in p.outputs
                    if isinstance(e, N.Var)}
        if all(c in passthru for c in d):
            return tuple(passthru[c] for c in d)
        return None
    if isinstance(p, SkewJoinP):
        return None         # light+heavy union mixes placements
    if isinstance(p, JoinP):
        if p.broadcast:
            return delivered_partitioning(p.left)  # probe side stays put
        if p.skew_aware:
            return None     # light+heavy union mixes placements
        ld = delivered_partitioning(p.left)
        if ld is not None and set(ld) <= set(p.left_on):
            return ld       # probe side elided: placement unchanged
        return tuple(p.left_on)
    if isinstance(p, (SumAggP, FusedJoinAggP)):
        return tuple(p.exchange_on) if p.exchange_on else tuple(p.keys)
    if isinstance(p, DeDupP):
        if p.exchange_on:
            return tuple(p.exchange_on)
        return tuple(p.cols) if p.cols else None
    if isinstance(p, OuterUnnestP):
        return delivered_partitioning(p.parent)  # left-major, row-local
    return None


def required_partitioning(p: Plan) -> Optional[tuple]:
    """Partitioning the operator wants from its (probe-side) input so
    its own exchange can be elided."""
    if isinstance(p, (SumAggP, FusedJoinAggP)):
        return tuple(p.exchange_on) if p.exchange_on else tuple(p.keys)
    if isinstance(p, DeDupP):
        if p.exchange_on:
            return tuple(p.exchange_on)
        return tuple(p.cols) if p.cols else None
    if isinstance(p, JoinP) and not p.broadcast:
        return tuple(p.left_on)
    return None


def annotate_partitioning(p: Plan) -> Plan:
    """EXPLAIN support: attach ``p.required_part`` / ``p.delivered_part``
    to every node (plan dumps and the shuffle tests read these)."""
    p.required_part = required_partitioning(p)
    p.delivered_part = delivered_partitioning(p)
    for c in _plan_children(p):
        annotate_partitioning(c)
    return p


def push_partitioning(p: Plan, desired: Optional[tuple] = None) -> Plan:
    """Partitioning-aware physical rewrite (run after push_order):

    * grouping ops (Gamma+ / dedup) pick their distributed
      ``exchange_on`` key: co-location on any subset of the grouping
      keys is sufficient for correctness, so when the PARENT wants the
      output partitioned on ``desired`` (a subset of the keys), the
      exchange uses exactly that tuple — the delivered partitioning then
      matches downstream and the next exchange elides;
    * joins push their own join keys down each side, so producers
      (earlier assignments of the bundle, other grouping ops) deliver
      pre-partitioned inputs and the join exchanges nothing at runtime.
    """
    def pick(keys: tuple) -> tuple:
        if desired and set(desired) <= set(keys):
            return tuple(desired)
        return tuple(keys)

    if isinstance(p, SumAggP):
        ex = pick(tuple(p.keys))
        return SumAggP(push_partitioning(p.child, ex), p.keys, p.vals,
                       p.local_preagg, exchange_on=ex)
    if isinstance(p, DeDupP):
        if p.cols is None:
            return DeDupP(push_partitioning(p.child, None), None)
        ex = pick(tuple(p.cols))
        return DeDupP(push_partitioning(p.child, ex), p.cols,
                      exchange_on=ex)
    if isinstance(p, FusedJoinAggP):
        ex = pick(tuple(p.keys))
        j = p.join
        nj = JoinP(push_partitioning(j.left, tuple(j.left_on)),
                   push_partitioning(j.right, tuple(j.right_on)),
                   j.left_on, j.right_on, j.how, j.unique_right,
                   j.expansion, j.broadcast, j.skew_aware, j.matched_col)
        return FusedJoinAggP(nj, p.keys, p.vals, p.local_preagg,
                             exchange_on=ex)
    if isinstance(p, JoinP):
        return JoinP(push_partitioning(p.left, tuple(p.left_on)),
                     push_partitioning(p.right, tuple(p.right_on)),
                     p.left_on, p.right_on, p.how, p.unique_right,
                     p.expansion, p.broadcast, p.skew_aware, p.matched_col)
    if isinstance(p, SelectP):
        return SelectP(push_partitioning(p.child, desired), p.pred)
    if isinstance(p, MapP):
        if p.extend:
            over = {c for c, _ in p.outputs}
            down = tuple(c for c in desired or () if c not in over) or None
            return MapP(push_partitioning(p.child, down), p.outputs,
                        extend=True)
        srcs = {out: e.name for out, e in p.outputs if isinstance(e, N.Var)}
        down = tuple(srcs[c] for c in desired or () if c in srcs) or None
        return MapP(push_partitioning(p.child, down), p.outputs)
    if isinstance(p, OuterUnnestP):
        return OuterUnnestP(push_partitioning(p.parent, desired),
                            p.child_bag, p.alias, p.parent_label,
                            p.child_label, p.expansion, p.matched_col,
                            p.rowid_col)
    if isinstance(p, UnionP):
        return UnionP(push_partitioning(p.left, None),
                      push_partitioning(p.right, None))
    if isinstance(p, SkewJoinP):
        return SkewJoinP(push_partitioning(p.join, None), p.heavy_param,
                         p.heavy_default)
    if isinstance(p, MultiJoinP):
        # the hypercube exchange partitions on composite coordinates, so
        # nothing upstream can pre-place rows and nothing downstream can
        # rely on a single-key placement: push None everywhere
        return MultiJoinP(
            push_partitioning(p.child, None),
            tuple(MultiJoinStage(push_partitioning(st.plan, None),
                                 st.left_on, st.right_on,
                                 st.unique_right, st.expansion)
                  for st in p.stages),
            p.shares, p.rel_routes, p.heavy_params, p.heavy_defaults)
    return p


# ---------------------------------------------------------------------------
# ProgramGraph: whole-program IR (paper Fig. 5 sequences as an explicit
# DAG of named subplans with def/use edges). The shredded materialization
# deliberately produces assignments whose TOP and dictionary plans share
# large subplans; the passes below make that sharing physical:
#
#   * ``cse_program``       — hash-conses structurally identical subplans
#     ACROSS assignments (modulo alias renaming) into shared nodes
#     evaluated once, generalizing the per-alias ScanP memoization;
#   * ``dce_program``       — drops assignments unreachable from the
#     outputs ``unshred_parts`` actually consumes;
#   * ``prune_program_columns`` — program-level dead-column elimination:
#     each non-output assignment only computes columns some downstream
#     consumer reads;
#   * ``lift_plan_parameters`` — replaces literal constants with runtime
#     ``N.Param``s so one compiled executable serves a parameterized
#     query family (the plan-cache contract, serve.query_service).
# ---------------------------------------------------------------------------

@dataclass
class ProgramNode:
    """One named subplan of a program DAG."""
    name: str
    plan: Plan
    role: str = "plain"      # "top" | "dict" | "plain" | "shared"
    deps: tuple = ()         # program/env names this plan reads


@dataclass
class ProgramGraph:
    """Assignments as named subplans, in a valid evaluation order.
    ``outputs`` are the externally consumed names (what unshredding /
    the caller reads); everything else is an intermediate the optimizer
    may prune or share."""
    nodes: List[ProgramNode]
    outputs: tuple

    def names(self) -> list:
        return [nd.name for nd in self.nodes]

    def node(self, name: str) -> ProgramNode:
        for nd in self.nodes:
            if nd.name == name:
                return nd
        raise KeyError(name)

    def pretty(self) -> str:
        out = []
        for nd in self.nodes:
            out.append(f"{nd.name} <=  # role={nd.role} deps={nd.deps}")
            out.append(plan_pretty(nd.plan, 1))
            out.append("")
        out.append(f"outputs: {self.outputs}")
        return "\n".join(out)


_CHILD_ATTRS = ("child", "left", "right", "parent", "join")


def _plan_children(p: Plan) -> list:
    out = [getattr(p, a) for a in _CHILD_ATTRS if hasattr(p, a)]
    if isinstance(p, MultiJoinP):
        out.extend(st.plan for st in p.stages)
    return out


def _walk_plan(p: Plan):
    yield p
    for c in _plan_children(p):
        yield from _walk_plan(c)


def plan_deps(p: Plan) -> set:
    """Environment names a plan reads (def/use edges of the DAG)."""
    out: set = set()
    for sub in _walk_plan(p):
        if isinstance(sub, ScanP):
            out.add(sub.bag)
        elif isinstance(sub, _PrunedScan):
            out.add(sub.inner.bag)
        elif isinstance(sub, OuterUnnestP):
            out.add(sub.child_bag)
        elif isinstance(sub, RefP):
            out.add(sub.name)
    return out


def build_program_graph(named_plans: Sequence[Tuple[str, Plan]],
                        outputs: Sequence[str],
                        roles: Optional[Dict[str, str]] = None
                        ) -> ProgramGraph:
    roles = roles or {}
    nodes = [ProgramNode(name, plan, roles.get(name, "plain"),
                         tuple(sorted(plan_deps(plan))))
             for name, plan in named_plans]
    return ProgramGraph(nodes, tuple(outputs))


# -- canonical plan signatures (structural identity modulo alias names) ----

class _Canon:
    """Canonical renaming context for one subplan: scan aliases and
    explicitly defined output columns get position-based ids, so two
    structurally identical subplans that differ only in generated names
    (fresh loop vars, derived key columns) produce the SAME signature.
    The alias/column maps double as the rename recipe between a shared
    definition site and each use site."""

    def __init__(self):
        self.aliases: Dict[str, str] = {}
        self.defined: Dict[str, str] = {}

    def define_alias(self, a: str) -> str:
        if a not in self.aliases:
            self.aliases[a] = f"@{len(self.aliases)}"
        return self.aliases[a]

    def define_col(self, c: str) -> str:
        if c not in self.defined:
            self.defined[c] = f"#{len(self.defined)}"
        return self.defined[c]

    def col(self, c: str) -> str:
        if c in self.defined:
            return self.defined[c]
        head, sep, tail = c.partition(".")
        if sep and head in self.aliases:
            return f"{self.aliases[head]}.{tail}"
        return c

    def cols(self, cs) -> tuple:
        return tuple(self.col(c) for c in cs)


def _expr_sig(e: N.Expr, canon: _Canon):
    if isinstance(e, N.Var):
        return ("v", canon.col(e.name))
    if isinstance(e, N.Const):
        return ("c", e.value, repr(e.ty))
    if isinstance(e, N.Param):
        return ("p", e.name)
    if isinstance(e, (N.Arith, N.Cmp, N.BoolOp)):
        return (type(e).__name__, e.op, _expr_sig(e.left, canon),
                _expr_sig(e.right, canon))
    if isinstance(e, N.Not):
        return ("not", _expr_sig(e.inner, canon))
    if isinstance(e, N.IfThen):
        return ("if", _expr_sig(e.cond, canon), _expr_sig(e.then, canon),
                _expr_sig(e.els, canon) if e.els is not None else None)
    if isinstance(e, N.NewLabel):
        # tag and capture names are trace metadata: the runtime label is
        # combine64 of the capture values only, so they are excluded —
        # labels built from equal captures are interchangeable.
        return ("lbl", tuple(_expr_sig(v, canon) for _, v in e.captures))
    raise TypeError(f"_expr_sig: {type(e).__name__}")


def _plan_sig(p: Plan, canon: _Canon):
    if isinstance(p, ScanP):
        canon.define_alias(p.alias)
        return ("scan", p.bag, p.with_rowid)
    if isinstance(p, _PrunedScan):
        # keep sets are EXCLUDED: occurrences that differ only in which
        # columns projection pushdown kept still merge — the shared
        # definition widens each scan to the union of its use sites'
        # keeps (see cse_program), and every operator above is
        # insensitive to extra carried columns (assignment roots project
        # explicitly; DeDupP(None) only ever sits above such a root).
        canon.define_alias(p.inner.alias)
        return ("pscan", p.inner.bag, p.inner.with_rowid)
    if isinstance(p, RefP):
        return ("ref", p.name, tuple(sorted(p.rename)),
                tuple(sorted(p.alias_map)))
    if isinstance(p, SelectP):
        c = _plan_sig(p.child, canon)
        return ("select", c, _expr_sig(p.pred, canon))
    if isinstance(p, MapP):
        c = _plan_sig(p.child, canon)
        outs = tuple((canon.define_col(o), _expr_sig(e, canon))
                     for o, e in p.outputs)
        return ("map", c, outs, p.extend)
    if isinstance(p, JoinP):
        l = _plan_sig(p.left, canon)
        r = _plan_sig(p.right, canon)
        mc = canon.define_col(p.matched_col) if p.how == "left_outer" \
            else p.matched_col
        return ("join", l, r, canon.cols(p.left_on),
                canon.cols(p.right_on), p.how, p.unique_right,
                p.expansion, p.broadcast, p.skew_aware, mc)
    if isinstance(p, SumAggP):
        c = _plan_sig(p.child, canon)
        return ("sum", c, canon.cols(p.keys), canon.cols(p.vals),
                p.local_preagg,
                canon.cols(p.exchange_on) if p.exchange_on else None)
    if isinstance(p, DeDupP):
        c = _plan_sig(p.child, canon)
        return ("dedup", c, canon.cols(p.cols) if p.cols else None,
                canon.cols(p.exchange_on) if p.exchange_on else None)
    if isinstance(p, UnionP):
        return ("union", _plan_sig(p.left, canon),
                _plan_sig(p.right, canon))
    if isinstance(p, OuterUnnestP):
        par = _plan_sig(p.parent, canon)
        canon.define_alias(p.alias)
        return ("unnest", par, p.child_bag, canon.col(p.parent_label),
                p.child_label, p.expansion, canon.define_col(p.matched_col),
                canon.define_col(p.rowid_col) if p.rowid_col else None)
    if isinstance(p, FusedJoinAggP):
        j = _plan_sig(p.join, canon)
        return ("fja", j, canon.cols(p.keys), canon.cols(p.vals),
                p.local_preagg,
                canon.cols(p.exchange_on) if p.exchange_on else None)
    if isinstance(p, SkewJoinP):
        # heavy_default excluded: it is a runtime-parameter binding,
        # structurally irrelevant exactly like N.Param defaults
        return ("skewjoin", _plan_sig(p.join, canon), p.heavy_param)
    if isinstance(p, MultiJoinP):
        c = _plan_sig(p.child, canon)
        sts = tuple((_plan_sig(st.plan, canon), canon.cols(st.left_on),
                     canon.cols(st.right_on), st.unique_right,
                     st.expansion) for st in p.stages)
        return ("multijoin", c, sts, p.shares, p.heavy_params)
    raise TypeError(f"_plan_sig: {type(p).__name__}")


def plan_signature(p: Plan) -> Tuple[tuple, _Canon]:
    """Context-free canonical signature of a subplan. Equal signatures
    mean: evaluating both yields bags identical up to the column rename
    derived from the two canons (``_renames_between``)."""
    canon = _Canon()
    sig = _plan_sig(p, canon)
    return sig, canon


def _renames_between(dcanon: _Canon, ucanon: _Canon
                     ) -> Tuple[tuple, tuple]:
    """(rename, alias_map) turning the DEFINITION site's column names
    into the USE site's names. Both canons come from equal signatures,
    so their canonical id sets coincide."""
    dai = {v: k for k, v in dcanon.aliases.items()}
    uai = {v: k for k, v in ucanon.aliases.items()}
    alias_map = tuple((dai[c], uai[c]) for c in sorted(dai)
                      if dai[c] != uai[c])
    dci = {v: k for k, v in dcanon.defined.items()}
    uci = {v: k for k, v in ucanon.defined.items()}
    rename = tuple((dci[c], uci[c]) for c in sorted(dci)
                   if dci[c] != uci[c])
    return rename, alias_map


_HEAVY_KINDS = (JoinP, SumAggP, DeDupP, OuterUnnestP, FusedJoinAggP)


def _cse_eligible(p: Plan) -> bool:
    """Worth sharing: the subtree performs real physical work (a join /
    aggregation / dedup / unnest somewhere). Bare scans are already
    memoized per (bag, alias) by ``_scan``."""
    return any(isinstance(sub, _HEAVY_KINDS) for sub in _walk_plan(p))


def cse_program(graph: ProgramGraph, min_count: int = 2) -> ProgramGraph:
    """Cross-assignment common-subexpression elimination: structurally
    identical subplans (modulo alias renaming — ``plan_signature``)
    appearing ``min_count``+ times anywhere in the program are extracted
    into shared ``__s<n>`` nodes evaluated once, scheduled immediately
    before their first use; every occurrence becomes a ``RefP`` carrying
    the rename into its own column namespace. A ``FusedJoinAggP`` whose
    embedded join is shared un-fuses into Gamma+ over the shared join
    (sharing beats fusion: the ref's physical props still carry the
    probe-side ordering into the aggregation)."""
    census: Dict[tuple, int] = {}
    keep_union: Dict[tuple, set] = {}   # (sig, canonical alias) -> cols
    for nd in graph.nodes:
        for sub in _walk_plan(nd.plan):
            if _cse_eligible(sub):
                sig, canon = plan_signature(sub)
                census[sig] = census.get(sig, 0) + 1
                for ps in _walk_plan(sub):
                    if isinstance(ps, _PrunedScan):
                        key = (sig, canon.aliases[ps.inner.alias])
                        keep_union.setdefault(key, set()).update(
                            canon.col(c) for c in ps.keep)

    shared: Dict[tuple, Tuple[str, _Canon]] = {}
    out_nodes: List[ProgramNode] = []

    def widen_keeps(body: Plan, sig, dcanon: _Canon) -> None:
        """Grow the shared definition's pruned scans to the union of
        every use site's keep set (translated back from canonical to
        definition-site names)."""
        inv = {v: k for k, v in dcanon.aliases.items()}
        for ps in _walk_plan(body):
            if isinstance(ps, _PrunedScan):
                u = keep_union.get((sig, dcanon.aliases[ps.inner.alias]))
                if not u:
                    continue
                keep = set()
                for c in u:
                    head, sep, tail = c.partition(".")
                    keep.add(f"{inv[head]}.{tail}"
                             if sep and head in inv else c)
                ps.keep = frozenset(keep)

    def make_ref(p: Plan, sig, canon: _Canon) -> RefP:
        if sig not in shared:
            name = f"__s{len(shared)}"
            shared[sig] = (name, canon)
            widen_keeps(p, sig, canon)
            body = rewrite_children(p)
            out_nodes.append(ProgramNode(
                name, body, "shared", tuple(sorted(plan_deps(body)))))
        sname, dcanon = shared[sig]
        rename, alias_map = _renames_between(dcanon, canon)
        return RefP(sname, rename=rename, alias_map=alias_map)

    def rewrite(p: Plan) -> Plan:
        if _cse_eligible(p):
            sig, canon = plan_signature(p)
            if census.get(sig, 0) >= min_count:
                return make_ref(p, sig, canon)
        if isinstance(p, FusedJoinAggP):
            jsig, jcanon = plan_signature(p.join)
            if census.get(jsig, 0) >= min_count:
                ref = make_ref(p.join, jsig, jcanon)
                return SumAggP(ref, p.keys, p.vals, p.local_preagg,
                               p.exchange_on)
        return rewrite_children(p)

    def rewrite_children(p: Plan) -> Plan:
        for attr in _CHILD_ATTRS:
            if hasattr(p, attr):
                if attr == "join":      # FusedJoinAggP: keep the fused
                    rewrite_children(getattr(p, attr))  # join, share below
                else:
                    setattr(p, attr, rewrite(getattr(p, attr)))
        return p

    for nd in graph.nodes:
        plan = rewrite(nd.plan)
        out_nodes.append(ProgramNode(nd.name, plan, nd.role,
                                     tuple(sorted(plan_deps(plan)))))
    return ProgramGraph(out_nodes, graph.outputs)


# -- dead-assignment / dead-column elimination ------------------------------

def dce_program(graph: ProgramGraph) -> ProgramGraph:
    """Drop assignments unreachable from the program outputs via the
    def/use edges (e.g. a pipeline stage whose manifest nobody reads)."""
    by_name = {nd.name: nd for nd in graph.nodes}
    live: set = set()
    stack = list(graph.outputs)
    while stack:
        n = stack.pop()
        if n in live or n not in by_name:
            continue
        live.add(n)
        stack.extend(by_name[n].deps)
    return ProgramGraph([nd for nd in graph.nodes if nd.name in live],
                        graph.outputs)


def _scan_needs(p: Plan) -> Dict[str, Optional[set]]:
    """Per environment bag, the attributes a plan reads (None = all)."""
    out: Dict[str, Optional[set]] = {}

    def add(bag: str, attrs: Optional[set]):
        cur = out.get(bag, set())
        out[bag] = None if (attrs is None or cur is None) else cur | attrs

    for sub in _walk_plan(p):
        if isinstance(sub, _PrunedScan):
            add(sub.inner.bag, scan_keep_attrs(sub.keep, sub.inner.alias))
        elif isinstance(sub, ScanP):
            add(sub.bag, None)
        elif isinstance(sub, OuterUnnestP):
            add(sub.child_bag, None)
    return out


def prune_program_columns(graph: ProgramGraph) -> ProgramGraph:
    """Program-level dead-column elimination: walking the DAG in reverse
    evaluation order, each non-output assignment is re-pruned so it only
    computes the columns its downstream consumers (plans scanning it, or
    shared-node refs) actually read. Output assignments keep everything
    (``unshred_parts`` consumes their full schema)."""
    needed: Dict[str, Optional[set]] = {o: None for o in graph.outputs}
    rebuilt: List[ProgramNode] = []
    for nd in reversed(graph.nodes):
        my = needed.get(nd.name, set())
        ref_needs: Dict[str, Optional[set]] = {}
        plan = required_columns(nd.plan, my, ref_needs)
        for bag, attrs in _scan_needs(plan).items():
            cur = needed.get(bag, set())
            needed[bag] = None if (attrs is None or cur is None) \
                else cur | attrs
        for name, attrs in ref_needs.items():
            cur = needed.get(name, set())
            needed[name] = None if (attrs is None or cur is None) \
                else cur | attrs
        rebuilt.append(ProgramNode(nd.name, plan, nd.role,
                                   tuple(sorted(plan_deps(plan)))))
    rebuilt.reverse()
    return ProgramGraph(rebuilt, graph.outputs)


# -- parameter lifting / collection ----------------------------------------

def lift_plan_parameters(graph: ProgramGraph,
                         prefix: str = "__c") -> Dict[str, object]:
    """Replace liftable literal constants inside plan expressions with
    ``N.Param`` nodes (in place); returns {param_name: default}. A plan
    compiled from the lifted graph executes a whole family of queries —
    bind different values via ``ExecSettings.params``. Structural
    constants are kept inline: the ``__one`` cross-product key and
    constant-only predicates (their value decides plan shape, not a
    runtime comparison operand)."""
    defaults: Dict[str, object] = {}

    def lift_e(e: N.Expr) -> N.Expr:
        def f(x: N.Expr) -> N.Expr:
            if N.liftable_const(x):
                name = f"{prefix}{len(defaults)}"
                defaults[name] = x.value
                return N.Param(name, x.ty, default=x.value)
            return x
        return N.map_expr(e, f)

    for nd in graph.nodes:
        for sub in _walk_plan(nd.plan):
            if isinstance(sub, SelectP) and not isinstance(sub.pred,
                                                           N.Const):
                sub.pred = lift_e(sub.pred)
            elif isinstance(sub, MapP):
                sub.outputs = tuple(
                    (o, e if o == "__one" else lift_e(e))
                    for o, e in sub.outputs)
    return defaults


def collect_params(graph: ProgramGraph) -> Dict[str, object]:
    """{param_name: default} over every N.Param referenced by the
    program's plan expressions, plus every plan-level parameter
    (``SkewJoinP`` heavy-key sets)."""
    out: Dict[str, object] = {}

    def visit(e: N.Expr):
        if isinstance(e, N.Param):
            out[e.name] = e.default
        for c in N.children(e):
            visit(c)

    for nd in graph.nodes:
        for sub in _walk_plan(nd.plan):
            if isinstance(sub, SelectP):
                visit(sub.pred)
            elif isinstance(sub, MapP):
                for _, e in sub.outputs:
                    visit(e)
    out.update(collect_plan_params(graph))
    return out


def collect_plan_params(graph: ProgramGraph) -> Dict[str, object]:
    """Plan-level runtime parameters: {heavy_param: padded int64 array}
    over every ``SkewJoinP`` of the program."""
    out: Dict[str, object] = {}
    for nd in graph.nodes:
        for sub in _walk_plan(nd.plan):
            if isinstance(sub, SkewJoinP):
                out[sub.heavy_param] = np.asarray(sub.heavy_default,
                                                  dtype=np.int64)
            elif isinstance(sub, MultiJoinP):
                for name, dflt in zip(sub.heavy_params,
                                      sub.heavy_defaults):
                    if name is not None:
                        out[name] = np.asarray(dflt, dtype=np.int64)
    return out


# ---------------------------------------------------------------------------
# automated skew pass: JoinP -> SkewJoinP where heavy-hitter statistics
# predict partition imbalance (DESIGN.md "Automated skew handling")
# ---------------------------------------------------------------------------

def _scan_aliases(p: Plan) -> Dict[str, str]:
    """alias -> environment bag for every scan in a subtree (the map the
    skew pass uses to tie join key columns back to stored parts)."""
    out: Dict[str, str] = {}
    for sub in _walk_plan(p):
        if isinstance(sub, ScanP):
            out[sub.alias] = sub.bag
        elif isinstance(sub, _PrunedScan):
            out[sub.inner.alias] = sub.inner.bag
        elif isinstance(sub, OuterUnnestP):
            out[sub.alias] = sub.child_bag
    return out


def apply_skew_program(graph: ProgramGraph, stats: Dict[str, object],
                       n_partitions: int, threshold: float = 0.025,
                       max_heavy: Optional[int] = None,
                       param_prefix: str = "__hk",
                       estimator=None) -> Dict[str, object]:
    """The automatic skew decision, applied program-wide (in place).

    For every hash join whose probe-side key is a single column scanned
    from a bag with statistics (``skew.TableStats``, typically derived
    from a stored dataset's zone maps + heavy-key sketch), ask
    ``skew.stats_heavy_array`` whether the predicted heavy-hitter set
    is non-empty; if so the join becomes a ``SkewJoinP`` whose heavy-key
    set is lifted as the runtime parameter ``__hk<i>``. A
    ``FusedJoinAggP`` whose embedded join qualifies un-fuses into
    Gamma+ over the skew join (placement beats fusion under skew — the
    heavy rows never cross the wire at all).

    With a ``cost.CardinalityEstimator`` (``estimator``), the un-fuse
    is a COSTED choice (``cost.choose_unfuse``): the fused pipeline's
    priced imbalance vs. the light exchange + heavy-build replication
    + an extra aggregation pass. Mild skew keeps the fusion; without an
    estimator the PR 5 rule (always un-fuse when heavy keys exist)
    applies unchanged. The decision uses only ``probe_heavy`` — no
    ``__hk`` parameter is registered for a join that stays fused.

    Zero predicted heavy keys => the plan is left byte-identical (the
    degenerate no-op contract asserted by the skew unit tests).
    Returns {param_name: (bag, attr, padded heavy-key array)} — the
    provenance lets a serving layer rebind fresh heavy-key sets for the
    same (bag, attr) on warm calls."""
    from . import skew as SK
    mh = max_heavy if max_heavy is not None else SK.MAX_HEAVY
    defaults: Dict[str, object] = {}
    # one sketch decision AND one lifted parameter per (bag, attr):
    # shared relations (a dictionary probed by several joins, the same
    # part under CSE) are consulted once per program compile, and every
    # join keyed on them rebinds through the SAME __hk<i> name
    decided: Dict[Tuple[str, str], Optional[object]] = {}
    param_of: Dict[Tuple[str, str], str] = {}

    def probe_heavy(j: JoinP):
        if j.broadcast or j.skew_aware or len(j.left_on) != 1:
            return None
        head, sep, attr = j.left_on[0].partition(".")
        if not sep:
            return None
        bag = _scan_aliases(j.left).get(head)
        if bag is None:
            return None
        key = (bag, attr)
        if key not in decided:
            decided[key] = SK.stats_heavy_array(stats, bag, attr,
                                                n_partitions, threshold,
                                                mh)
        heavy = decided[key]
        return None if heavy is None else (bag, attr, heavy)

    def lift(j: JoinP):
        hit = probe_heavy(j)
        if hit is None:
            return None
        bag, attr, heavy = hit
        name = param_of.get((bag, attr))
        if name is None:
            name = f"{param_prefix}{len(defaults)}"
            param_of[(bag, attr)] = name
            defaults[name] = (bag, attr, heavy)
        return SkewJoinP(j, name, tuple(int(x) for x in heavy))

    def fusion_wins(p: FusedJoinAggP, hit) -> bool:
        """Costed decision (c): does keeping the fused join+aggregate
        beat un-fusing into Gamma+ over a SkewJoinP? Heavy-key
        frequencies come from the sketch, scaled by the estimated
        probe survival ratio (the probe may be filtered)."""
        from . import cost as C
        bag, attr, heavy = hit
        ts = stats.get(bag)
        if ts is None:
            return False
        hset = {int(x) for x in heavy}
        freqs = [float(c) for k, c in getattr(ts, "heavy", {}).get(attr,
                                                                   ())
                 if int(k) in hset]
        base_rows = max(float(getattr(ts, "effective_rows", ts.rows)),
                        1.0)
        probe = estimator.estimate(p.join.left)
        probe_rows = probe.rows if probe.known else base_rows
        ratio = min(probe_rows / base_rows, 1.0)
        return not C.choose_unfuse(probe_rows,
                                   [f * ratio for f in freqs],
                                   n_partitions)

    def rewrite(p: Plan) -> Plan:
        if isinstance(p, (SkewJoinP, MultiJoinP)):
            return p            # idempotent: never double-wrap
        if isinstance(p, JoinP):
            p.left = rewrite(p.left)
            p.right = rewrite(p.right)
            return lift(p) or p
        if isinstance(p, FusedJoinAggP):
            p.join.left = rewrite(p.join.left)
            p.join.right = rewrite(p.join.right)
            if estimator is not None:
                hit = probe_heavy(p.join)
                if hit is not None and fusion_wins(p, hit):
                    return p    # costed: keep the fusion, no param
            sj = lift(p.join)
            if sj is not None:
                return SumAggP(sj, p.keys, p.vals, p.local_preagg,
                               p.exchange_on)
            return p
        for attr in _CHILD_ATTRS:
            if hasattr(p, attr):
                setattr(p, attr, rewrite(getattr(p, attr)))
        return p

    for nd in graph.nodes:
        nd.plan = rewrite(nd.plan)
    return defaults


# ---------------------------------------------------------------------------
# HyperCube pass: inner equi-join chains -> one-round MultiJoinP when
# TableStats say the replicating exchange beats the binary cascade
# (DESIGN.md "HyperCube exchange")
# ---------------------------------------------------------------------------

def _peel_join_chain(p: Plan, min_joins: int):
    """Maximal left-deep chain of directly nested inner JoinP /
    SkewJoinP under ``p``: returns (base, [(JoinP, heavy_param,
    heavy_default), ...] innermost-first) or None. Outer joins,
    broadcast and legacy skew_aware joins break the chain — only the
    inner hash-exchange cascade is replaceable by one round."""
    stages = []
    cur = p
    while True:
        hp, hd = None, ()
        j = cur
        if isinstance(j, SkewJoinP):
            hp, hd = j.heavy_param, j.heavy_default
            j = j.join
        if not isinstance(j, JoinP) or j.how != "inner" or j.broadcast \
                or j.skew_aware:
            break
        stages.append((j, hp, hd))
        cur = j.left
    if len(stages) < min_joins:
        return None
    stages.reverse()
    return cur, stages


def _hypercube_rewrite_chain(p: Plan, stats: Dict[str, object],
                             n_partitions: int, min_joins: int,
                             estimator=None) -> Optional["MultiJoinP"]:
    """Try to rewrite the chain rooted at ``p`` into a MultiJoinP.
    Conservative: any relation without TableStats, any join key not
    traceable to a single source relation, or a share assignment whose
    replicated wire volume exceeds the cascade's leaves the plan
    untouched.

    With a ``cost.CardinalityEstimator`` (``estimator``) the cascade
    side of the gate is priced from ESTIMATED intermediate
    cardinalities (``skew.cascade_send_rows_est``) — a shrinking chain
    makes the cascade cheaper than the stats-free "every intermediate
    ~ spine" assumption, an expanding one dearer; relation row counts
    also refine through the estimator (a filtered base relation ships
    its selected rows, not the full scan)."""
    from . import skew as SK
    peeled = _peel_join_chain(p, min_joins)
    if peeled is None:
        return None
    base, stages = peeled
    rels = [base] + [j.right for (j, _, _) in stages]
    amap: Dict[str, int] = {}
    rel_bags = []
    for ri, rp in enumerate(rels):
        al = _scan_aliases(rp)
        for alias in al:
            if alias in amap:
                return None     # alias reused across relations: bail
            amap[alias] = ri
        rel_bags.append(set(al.values()))

    def owner_of(cols) -> Optional[int]:
        owners = set()
        for c in cols:
            head, sep, _ = c.partition(".")
            if not sep or head not in amap:
                return None     # derived column: not routable
            owners.add(amap[head])
        return owners.pop() if len(owners) == 1 else None

    dim_of: Dict[tuple, int] = {}
    dim_heavy: List[list] = []
    stage_dim: List[int] = []
    for i, (j, hp, hd) in enumerate(stages):
        o = owner_of(j.left_on)
        if o is None or o > i:
            return None         # key must live on the accumulated spine
        k = (o, tuple(j.left_on))
        if k not in dim_of:
            dim_of[k] = len(dim_of)
            dim_heavy.append([None, ()])
        d = dim_of[k]
        stage_dim.append(d)
        if hp is not None:
            if dim_heavy[d][0] is None:
                dim_heavy[d] = [hp, tuple(hd)]
            elif dim_heavy[d][0] != hp:
                dim_heavy[d] = [None, ()]   # conflicting params: drop

    routes: List[list] = [[] for _ in rels]
    for (o, cols), d in dim_of.items():
        routes[o].append((d, tuple(cols), "probe"))
    for i, (j, _, _) in enumerate(stages):
        routes[i + 1].append((stage_dim[i], tuple(j.right_on), "build"))

    rows = []
    for rp, bags in zip(rels, rel_bags):
        est_rows = estimator.rows_of(rp) if estimator is not None \
            else None
        if est_rows is not None:
            rows.append(max(int(est_rows), 1))
            continue
        if not bags:
            return None
        rs = []
        for b in bags:
            ts = stats.get(b)
            if ts is None or not hasattr(ts, "rows"):
                return None
            # observed (fed-back) cardinality wins over the estimate
            rs.append(int(getattr(ts, "effective_rows", ts.rows)))
        rows.append(max(rs))
    rel_dim_sets = [tuple(sorted({d for d, _, _ in r})) for r in routes]
    shares, _load = SK.plan_hypercube_shares(rel_dim_sets, rows,
                                             n_partitions)
    cascade = SK.cascade_send_rows(rows)
    if estimator is not None:
        inters = estimator.chain_intermediates(
            base, [j for (j, _, _) in stages])
        if inters is not None:
            cascade = SK.cascade_send_rows_est(rows, inters)
    if SK.hypercube_send_rows(rel_dim_sets, rows, shares) > cascade:
        return None             # replication would out-cost the cascade
    sts = tuple(MultiJoinStage(j.right, tuple(j.left_on),
                               tuple(j.right_on), j.unique_right,
                               j.expansion) for (j, _, _) in stages)
    return MultiJoinP(base, sts, tuple(int(s) for s in shares),
                      tuple(tuple(r) for r in routes),
                      tuple(h[0] for h in dim_heavy),
                      tuple(tuple(h[1]) for h in dim_heavy))


def apply_hypercube_program(graph: ProgramGraph, stats: Dict[str, object],
                            n_partitions: int, min_joins: int = 2,
                            estimator=None) -> int:
    """Rewrite multiway inner equi-join chains to one-round hypercube
    ``MultiJoinP`` nodes, program-wide (in place, after the skew pass —
    SkewJoinP wrappers are absorbed and their heavy-key parameters keep
    their names, so serving-layer rebinds are untouched). Returns the
    number of chains rewritten."""
    count = 0

    def rewrite(p: Plan) -> Plan:
        nonlocal count
        if isinstance(p, MultiJoinP):
            return p
        mj = _hypercube_rewrite_chain(p, stats, n_partitions, min_joins,
                                      estimator)
        if mj is not None:
            count += 1
            mj.child = rewrite(mj.child)
            for st in mj.stages:
                st.plan = rewrite(st.plan)
            return mj
        if isinstance(p, FusedJoinAggP):
            mj = _hypercube_rewrite_chain(p.join, stats, n_partitions,
                                          min_joins, estimator)
            if mj is not None:
                count += 1
                mj.child = rewrite(mj.child)
                for st in mj.stages:
                    st.plan = rewrite(st.plan)
                # un-fuse: Gamma+ above the one-round join (placement
                # beats fusion, same trade the skew pass makes)
                return SumAggP(mj, p.keys, p.vals, p.local_preagg,
                               p.exchange_on)
        for attr in _CHILD_ATTRS:
            if hasattr(p, attr):
                setattr(p, attr, rewrite(getattr(p, attr)))
        return p

    for nd in graph.nodes:
        nd.plan = rewrite(nd.plan)
    return count


# ---------------------------------------------------------------------------
# morsel streaming: how per-morsel partial outputs re-fold
# ---------------------------------------------------------------------------

def _fold_rename(col: str, rename: tuple, alias_map: tuple) -> str:
    for old, new in rename:
        if col == old:
            return new
    for oa, na in alias_map:
        if col.startswith(oa + "."):
            return na + col[len(oa):]
    return col


def morsel_fold(plans: Sequence[Tuple[str, "Plan"]],
                outputs: Sequence[str],
                streamed: set) -> Dict[str, tuple]:
    """Per program output: how per-morsel partial results re-fold into
    the one-shot answer when the parts in ``streamed`` are fed morsel
    windows (all other environment bags resident and identical across
    morsels).

    Fold specs:

    * ``("first",)``            — the output never reads a streamed
      part: every morsel computes the same bag, keep the first.
    * ``("concat",)``           — row-local subtree (scans, selects,
      maps, joins, unnests): the one-shot rows are exactly the
      disjoint union of the morsel rows, because morsel windows keep
      each parent row co-resident with ALL its children (label
      intervals) and joins against resident parts see full build sides.
    * ``("sum", keys, vals)``   — a SumAggP/FusedJoinAggP at the output
      ROOT: morsels emit partial group sums; re-aggregating the
      concatenated partials with the same keys/vals is the one-shot
      result (grand-total grouping is associative).
    * ``("dedup", cols)``       — a DeDupP at the output root: dedup of
      the concatenated per-morsel dedups.

    An aggregate anywhere BELOW the output root over streamed rows is
    ``StreamingUnsupportedError``: its per-morsel value is a partial,
    and whatever consumes it would fold partials through a non-linear
    operator. (RefP chains into CSE-shared nodes are followed; shared
    subtrees that never touch a streamed part are harmless — they are
    resident-identical every morsel.)
    """
    from repro_torch.errors import StreamingUnsupportedError
    by_name = dict(plans)

    def _touches(name: str, seen: frozenset = frozenset()) -> bool:
        if name in streamed:
            return True
        plan = by_name.get(name)
        if plan is None or name in seen:
            return False
        return any(_touches(d, seen | {name}) for d in plan_deps(plan))

    touch_cache: Dict[str, bool] = {}

    def touches(name: str) -> bool:
        if name not in touch_cache:
            touch_cache[name] = _touches(name)
        return touch_cache[name]

    def subtree_has_streamed_agg(p: "Plan") -> bool:
        """An aggregate/dedup whose OWN subtree reads streamed rows,
        anywhere under ``p`` (following references)."""
        for sub in _walk_plan(p):
            if isinstance(sub, (SumAggP, FusedJoinAggP, DeDupP)):
                if any(touches(d) for d in plan_deps(sub)):
                    return True
            elif isinstance(sub, RefP):
                ref = by_name.get(sub.name)
                if ref is not None and touches(sub.name) \
                        and subtree_has_streamed_agg(ref):
                    return True
        return False

    def spec_for(name: str) -> tuple:
        plan = by_name.get(name)
        if plan is None:            # a raw environment part
            return ("concat",) if name in streamed else ("first",)
        if not touches(name):
            return ("first",)
        if isinstance(plan, RefP):
            inner = spec_for(plan.name)
            if inner[0] == "sum":
                return ("sum",
                        tuple(_fold_rename(c, plan.rename, plan.alias_map)
                              for c in inner[1]),
                        tuple(_fold_rename(c, plan.rename, plan.alias_map)
                              for c in inner[2]))
            if inner[0] == "dedup":
                cols = inner[1]
                return ("dedup",
                        None if cols is None else
                        tuple(_fold_rename(c, plan.rename, plan.alias_map)
                              for c in cols))
            return inner
        if isinstance(plan, (SumAggP, FusedJoinAggP)):
            below = plan.child if isinstance(plan, SumAggP) else plan.join
            if subtree_has_streamed_agg(below):
                raise StreamingUnsupportedError(
                    f"{name}: aggregate over streamed rows below the "
                    f"output aggregate — partials would not re-fold")
            return ("sum", tuple(plan.keys), tuple(plan.vals))
        if isinstance(plan, DeDupP):
            if subtree_has_streamed_agg(plan.child):
                raise StreamingUnsupportedError(
                    f"{name}: aggregate over streamed rows below the "
                    f"output dedup — partials would not re-fold")
            return ("dedup",
                    None if plan.cols is None else tuple(plan.cols))
        if subtree_has_streamed_agg(plan):
            raise StreamingUnsupportedError(
                f"{name}: aggregate over streamed rows in non-root "
                f"position — its per-morsel value is a partial")
        return ("concat",)

    return {out: spec_for(out) for out in outputs}
