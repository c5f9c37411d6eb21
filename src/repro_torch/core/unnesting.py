"""Unnesting (paper §3.1) — NRC to plan-language compilation.

Two routes:

* ``compile_flat_query``   — the shredded route: each materialized
  assignment is a *flat* comprehension (for-chains over flat bags +
  MatLookups + predicates + tuple head, optionally under sumBy/dedup).
  Comprehension normalization (monad associativity + conditional
  hoisting) yields a left-deep join plan — the flat fragment of the
  Fegaras–Maier algorithm.

* ``compile_standard``     — the standard route over *nested* values
  (Fig. 3): navigation generators become outer-unnests (wide flattening
  with ancestor columns and fresh unique IDs), correlated subqueries in
  the head become nest (Gamma_u) levels keyed by the grouping attributes
  G, and sumBy at a level becomes Gamma+ keyed by G + the sumBy keys.

Nested values are stored as *parts*: {path: FlatBag}, each non-root
level keyed by a ``label`` column pointing at its parent (physically the
same layout as the shredded representation — the two routes differ in
operator composition, which is where their costs diverge; DESIGN.md §2).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import nrc as N
from .plans import (DeDupP, JoinP, MapP, OuterUnnestP, Plan, ScanP, SelectP,
                    SumAggP, UnionP)


# ---------------------------------------------------------------------------
# Catalog: schema/uniqueness hints used by the planner
# ---------------------------------------------------------------------------

@dataclass
class Catalog:
    """Planner metadata. ``unique_keys[name]`` — attrs on which the bag is
    unique (enables fk_join). ``small`` — bags cheap to broadcast.
    ``expansion`` — per-bag general-join capacity factors."""
    unique_keys: Dict[str, tuple] = dc_field(default_factory=dict)
    small: frozenset = frozenset()
    expansion: Dict[str, float] = dc_field(default_factory=dict)
    default_expansion: float = 4.0

    def is_unique_on(self, bag: str, attrs: Sequence[str]) -> bool:
        uk = self.unique_keys.get(bag)
        return uk is not None and set(uk) == set(attrs)

    def exp(self, bag: str) -> float:
        return self.expansion.get(bag, self.default_expansion)


def _cols_of(alias: str, ty: N.TupleT) -> N.TupleE:
    """Substitution image of a loop variable: attr -> Var('alias.attr')."""
    return N.TupleE(tuple(
        (n, N.Var(f"{alias}.{n}", t)) for n, t in ty.fields))


def _expr_aliases(e: N.Expr) -> set:
    out = set()

    def go(x):
        if isinstance(x, N.Var) and "." in x.name:
            out.add(x.name.split(".", 1)[0])
        for c in N.children(x):
            go(c)

    go(e)
    return out


def _as_column(plan: Plan, expr: N.Expr) -> Tuple[Plan, str]:
    """Ensure ``expr`` is available as a physical column."""
    if isinstance(expr, N.Var):
        return plan, expr.name
    col = N.fresh("__k")
    return MapP(plan, ((col, expr),), extend=True), col


# ---------------------------------------------------------------------------
# Flat route (shredded assignments)
# ---------------------------------------------------------------------------

@dataclass
class _Gen:
    alias: str
    kind: str            # "scan" | "dictjoin" | "agg"
    bag: str
    label_expr: Optional[N.Expr] = None
    # kind == "agg": correlated aggregate subquery (baseline
    # materialization route — no domain elimination)
    agg_keys: tuple = ()
    agg_vals: tuple = ()
    agg_head: Optional[N.TupleE] = None


@dataclass
class Comp:
    gens: List[_Gen]
    preds: List[N.Expr]
    head: Optional[N.TupleE]


def _split_conj(c: N.Expr) -> List[N.Expr]:
    """Flatten a conjunction into its conjuncts, so an equi-join key
    buried inside ``a && b`` is recognized by the join-key extraction
    (the rest stays behind as ordinary selections). Without this the
    planner silently falls back to a capacity-bounded cross product."""
    if isinstance(c, N.BoolOp) and c.op == "&&":
        return _split_conj(c.left) + _split_conj(c.right)
    return [c]


def normalize(e: N.Expr) -> Comp:
    """Normalize a flat bag expression to generators+predicates+head."""
    gens: List[_Gen] = []
    preds: List[N.Expr] = []

    def go(x: N.Expr, sub: Dict[str, N.Expr]) -> Optional[N.TupleE]:
        if isinstance(x, N.ForUnion):
            src = N.subst(x.source, sub)
            v = x.var
            if isinstance(src, N.Var):
                alias = v.name
                elem = src.ty.elem
                assert isinstance(elem, N.TupleT), elem
                gens.append(_Gen(alias, "scan", src.name))
                sub2 = dict(sub)
                sub2[v.name] = _cols_of(alias, elem)
                return go(x.body, sub2)
            if isinstance(src, N.MatLookup):
                md = src.matdict
                assert isinstance(md, N.Var), "MatLookup over named dicts only"
                alias = v.name
                elem = src.ty.elem
                assert isinstance(elem, N.TupleT)
                gens.append(_Gen(alias, "dictjoin", md.name,
                                 label_expr=src.label))
                sub2 = dict(sub)
                sub2[v.name] = _cols_of(alias, elem)
                return go(x.body, sub2)
            if isinstance(src, N.MatchLabel):
                assert len(src.params) == 1, (
                    "columnar route requires single-capture labels")
                inner = N.subst(src.body, {src.params[0].name: src.label})
                return go(N.ForUnion(v, inner, x.body), sub)
            if isinstance(src, N.IfThen) and src.els is None:
                preds.extend(_split_conj(src.cond))
                return go(N.ForUnion(v, src.then, x.body), sub)
            if isinstance(src, (N.ForUnion, N.Singleton)):
                head_inner = go(src, sub)
                if head_inner is None:
                    return None
                sub2 = dict(sub)
                sub2[v.name] = head_inner
                return go(x.body, sub2)
            if isinstance(src, N.SumBy):
                # correlated aggregate generator (baseline materialization):
                # process the inner comprehension inline, then group by the
                # correlation columns + the sumBy keys at compile time.
                inner_head = go(src.bag_expr, sub)
                assert inner_head is not None
                alias = v.name
                gens.append(_Gen(alias, "agg", "",
                                 agg_keys=tuple(src.keys),
                                 agg_vals=tuple(src.values),
                                 agg_head=inner_head))
                elem = src.ty.elem
                assert isinstance(elem, N.TupleT)
                sub2 = dict(sub)
                sub2[v.name] = N.TupleE(tuple(
                    (n, N.Var(f"{alias}.{n}", t)) for n, t in elem.fields))
                return go(x.body, sub2)
            raise TypeError(
                f"normalize: unsupported generator source {type(src).__name__}")
        if isinstance(x, N.IfThen) and x.els is None:
            preds.extend(_split_conj(N.subst(x.cond, sub)))
            return go(x.then, sub)
        if isinstance(x, N.Singleton):
            elem = N.subst(x.elem, sub)
            assert isinstance(elem, N.TupleE), (
                f"head must be a tuple constructor, got {N.pretty(elem)}")
            return elem
        if isinstance(x, N.EmptyBag):
            return None
        if isinstance(x, N.Var):
            src = N.subst(x, sub)
            assert isinstance(src, N.Var)
            elem = src.ty.elem
            assert isinstance(elem, N.TupleT)
            alias = N.fresh("pass")
            gens.append(_Gen(alias, "scan", src.name))
            return _cols_of(alias, elem)
        if isinstance(x, N.MatLookup):
            src = N.subst(x, sub)
            alias = N.fresh("lk")
            v = N.Var(alias, src.ty.elem)
            return go(N.ForUnion(v, src, N.Singleton(
                N.TupleE(tuple((n, N.Field(v, n))
                               for n, _ in src.ty.elem.fields)))), sub)
        raise TypeError(f"normalize: unsupported node {type(x).__name__}")

    head = go(e, {})
    return Comp(gens, preds, head)


def compile_flat_query(e: N.Expr, catalog: Optional[Catalog] = None) -> Plan:
    """Compile a materialized (flat) NRC query to a plan."""
    catalog = catalog or Catalog()
    if isinstance(e, N.UnionE):
        return UnionP(compile_flat_query(e.left, catalog),
                      compile_flat_query(e.right, catalog))
    if isinstance(e, N.SumBy):
        child = compile_flat_query(e.bag_expr, catalog)
        return SumAggP(child, tuple(e.keys), tuple(e.values))
    if isinstance(e, N.DeDup):
        child = compile_flat_query(e.bag_expr, catalog)
        return DeDupP(child, None)

    comp = normalize(e)
    assert comp.gens, f"no generators in {N.pretty(e)}"
    plan: Optional[Plan] = None
    bound: set = set()
    pending: List[N.Expr] = list(comp.preds)

    for g in comp.gens:
        if g.kind == "agg":
            # correlated aggregate: group by (columns still needed later)
            # + the aggregate keys. "Needed later" = deps of the head and
            # remaining predicates, minus the aggregate's own outputs.
            for k in g.agg_keys + g.agg_vals:
                plan, col = _as_column(plan, g.agg_head.item(k))
                plan = MapP(plan, ((f"{g.alias}.{k}", N.Var(col, N.REAL)),),
                            extend=True)
            later: set = set()
            if comp.head is not None:
                from .plans import col_expr_deps
                later |= col_expr_deps(comp.head)
                for p in pending:
                    later |= col_expr_deps(p)
            later = {c for c in later
                     if not c.startswith(f"{g.alias}.")}
            group_keys = tuple(sorted(later)) + tuple(
                f"{g.alias}.{k}" for k in g.agg_keys)
            plan = SumAggP(plan, group_keys,
                           tuple(f"{g.alias}.{k}" for k in g.agg_vals))
            bound.add(g.alias)
            continue
        right = ScanP(g.bag, g.alias)
        if plan is None:
            assert g.kind == "scan", "first generator must scan a bag"
            plan = right
            bound.add(g.alias)
            continue
        if g.kind == "dictjoin":
            plan, lab_col = _as_column(plan, g.label_expr)
            plan = JoinP(plan, right, (lab_col,), (f"{g.alias}.label",),
                         how="inner", unique_right=False,
                         expansion=catalog.exp(g.bag))
            bound.add(g.alias)
            continue
        lkeys, rkeys, used = [], [], []
        for p in pending:
            if isinstance(p, N.Cmp) and p.op == "==":
                la, ra = _expr_aliases(p.left), _expr_aliases(p.right)
                if la <= bound and ra == {g.alias}:
                    lhs, rhs = p.left, p.right
                elif ra <= bound and la == {g.alias}:
                    lhs, rhs = p.right, p.left
                else:
                    continue
                plan, lc = _as_column(plan, lhs)
                assert isinstance(rhs, N.Var), "new-side join key must be a column"
                lkeys.append(lc)
                rkeys.append(rhs.name)
                used.append(p)
        for p in used:
            pending.remove(p)
        if not lkeys:
            # genuine cross product (e.g. per-sample x whole network in
            # the biomedical pipeline): constant-key general join with
            # |L| x expansion capacity.
            plan = MapP(plan, (("__one", N.Const(0, N.INT)),), extend=True)
            right_one = MapP(right, (("__one", N.Const(0, N.INT)),),
                             extend=True)
            plan = JoinP(plan, right_one, ("__one",), ("__one",),
                         how="inner", unique_right=False,
                         expansion=catalog.exp(g.bag))
        else:
            uniq = catalog.is_unique_on(g.bag,
                                        [k.split(".", 1)[1] for k in rkeys])
            plan = JoinP(plan, right, tuple(lkeys), tuple(rkeys),
                         how="inner", unique_right=uniq,
                         expansion=catalog.exp(g.bag),
                         broadcast=g.bag in catalog.small)
        bound.add(g.alias)

    for p in pending:
        plan = SelectP(plan, p)
    if comp.head is None:
        return SelectP(plan, N.Const(False, N.BOOL))
    return MapP(plan, tuple(comp.head.items))


# ---------------------------------------------------------------------------
# Standard route (paper Fig. 3)
# ---------------------------------------------------------------------------

@dataclass
class NestSpec:
    """One Gamma_u level rebuilt bottom-up after the wide plan."""
    path: tuple            # output nesting path, e.g. ("corders","oparts")
    group_cols: tuple      # G: ancestor ids + ancestor scalar columns
    rename: tuple          # ((out_name, wide_col), ...) child level fields
    label_col: str         # fresh label column for this level
    matched_cols: tuple    # flags whose AND marks a real (non-empty) child
    sum_agg: Optional[Tuple[tuple, tuple]] = None  # leaf Gamma+ (keys, vals)


@dataclass
class StandardPlan:
    wide: Plan
    nests: List[NestSpec]            # bottom-up order
    top_rename: tuple                # ((out_name, wide_col), ...)
    flat_agg: Optional[Tuple[tuple, tuple]] = None


def compile_standard(e: N.Expr, input_roots: Dict[str, N.BagT],
                     flat_inputs: Dict[str, N.BagT],
                     parts_name: Callable[[str, tuple], str],
                     catalog: Optional[Catalog] = None) -> StandardPlan:
    """Standard-route compilation (see module docstring).

    ``input_roots``  — nested inputs (stored as parts bags).
    ``flat_inputs``  — flat auxiliary inputs (e.g. Part), stored whole.
    """
    catalog = catalog or Catalog()
    state = {"plan": None, "uid": 0}
    nav: Dict[str, Tuple[str, tuple]] = {}
    bound: set = set()
    nests: List[NestSpec] = []
    pending: List[N.Expr] = []

    def fresh_col(prefix: str) -> str:
        state["uid"] += 1
        return f"__{prefix}{state['uid']}"

    def nested_elem_of(root: str, path: tuple) -> N.TupleT:
        """Element type at a nesting path, bag attributes KEPT nested —
        used for substitution images so subqueries keep navigating;
        physical columns share the same 'alias.attr' names (bag-typed
        images read as the label column when used as scalars)."""
        ty: N.Type = input_roots[root]
        for a in path:
            assert isinstance(ty, N.BagT)
            elem = ty.elem
            assert isinstance(elem, N.TupleT)
            ty = elem.field(a)
        assert isinstance(ty, N.BagT)
        elem = ty.elem
        assert isinstance(elem, N.TupleT)
        return elem

    def add_join_for(alias: str, bag_name: str, elem: N.TupleT) -> None:
        right = ScanP(bag_name, alias)
        lkeys, rkeys, used = [], [], []
        for p in pending:
            if isinstance(p, N.Cmp) and p.op == "==":
                la, ra = _expr_aliases(p.left), _expr_aliases(p.right)
                if la <= bound and ra == {alias}:
                    lhs, rhs = p.left, p.right
                elif ra <= bound and la == {alias}:
                    lhs, rhs = p.right, p.left
                else:
                    continue
                state["plan"], lc = _as_column(state["plan"], lhs)
                lkeys.append(lc)
                rkeys.append(rhs.name)
                used.append(p)
        for p in used:
            pending.remove(p)
        assert lkeys, f"no equi-join predicate for {bag_name}"
        uniq = catalog.is_unique_on(bag_name,
                                    [k.split(".", 1)[1] for k in rkeys])
        state["plan"] = JoinP(state["plan"], right, tuple(lkeys),
                              tuple(rkeys), how="left_outer",
                              unique_right=uniq,
                              broadcast=bag_name in catalog.small,
                              matched_col=f"__m.{alias}")
        bound.add(alias)

    def walk(x: N.Expr, sub: Dict[str, N.Expr], inherited_g: tuple,
             path: tuple) -> tuple:
        """Compile one nesting level; returns rename pairs for its head.
        Side effects: extends the wide plan, appends NestSpecs bottom-up."""
        local_ids: List[str] = []
        local_matched: List[str] = []
        while True:
            if isinstance(x, N.ForUnion):
                src = N.subst(x.source, sub)
                v = x.var
                if (isinstance(src, N.Var) and "." in src.name
                        and isinstance(src.ty, N.BagT)):
                    # navigation generator: for y in x.a  (outer-unnest)
                    parent_alias, attr = src.name.split(".", 1)
                    root, ppath = nav[parent_alias]
                    cpath = ppath + (attr,)
                    elem = nested_elem_of(root, cpath)
                    rowid = f"{v.name}.__rowid"
                    mcol = f"__m.{v.name}"
                    state["plan"] = OuterUnnestP(
                        state["plan"], parts_name(root, cpath), v.name,
                        f"{parent_alias}.{attr}", "label",
                        expansion=catalog.exp(parts_name(root, cpath)),
                        matched_col=mcol, rowid_col=rowid)
                    bound.add(v.name)
                    nav[v.name] = (root, cpath)
                    local_ids.append(rowid)
                    local_matched.append(mcol)
                    sub = dict(sub)
                    sub[v.name] = _cols_of(v.name, elem)
                    x = x.body
                    continue
                if isinstance(src, N.Var) and src.name in input_roots:
                    assert state["plan"] is None, "top scan must come first"
                    elem = nested_elem_of(src.name, ())
                    state["plan"] = ScanP(parts_name(src.name, ()), v.name,
                                          with_rowid=True)
                    bound.add(v.name)
                    nav[v.name] = (src.name, ())
                    local_ids.append(f"{v.name}.__rowid")
                    sub = dict(sub)
                    sub[v.name] = _cols_of(v.name, elem)
                    x = x.body
                    continue
                if isinstance(src, N.Var):
                    elem = src.ty.elem
                    assert isinstance(elem, N.TupleT)
                    if state["plan"] is None:
                        # flat top-level input (flat-to-nested queries)
                        state["plan"] = ScanP(f"{src.name}__F", v.name,
                                              with_rowid=True)
                        bound.add(v.name)
                        local_ids.append(f"{v.name}.__rowid")
                        sub = dict(sub)
                        sub[v.name] = _cols_of(v.name, elem)
                        x = x.body
                        continue
                    # peel predicates first — they carry the join keys
                    sub2 = dict(sub)
                    sub2[v.name] = _cols_of(v.name, elem)
                    while isinstance(x.body, N.IfThen) and x.body.els is None:
                        pending.append(N.subst(x.body.cond, sub2))
                        x = N.ForUnion(v, x.source, x.body.then)
                    add_join_for(v.name, f"{src.name}__F"
                                 if src.name in flat_inputs else src.name,
                                 elem)
                    local_matched.append(f"__m.{v.name}")
                    sub = sub2
                    x = x.body
                    continue
                raise TypeError(
                    f"standard: generator over {type(src).__name__}")
            if isinstance(x, N.IfThen) and x.els is None:
                pending.append(N.subst(x.cond, sub))
                x = x.then
                continue
            if isinstance(x, N.Singleton):
                head = N.subst(x.elem, sub)
                assert isinstance(head, N.TupleE)
                break
            raise TypeError(f"standard: unsupported {type(x).__name__}")

        # head: scalars first (they join G for child levels), then bags
        scalar_pairs: List[Tuple[str, str]] = []
        bag_fields: List[Tuple[str, N.Expr]] = []
        for name, fe in head.items:
            if isinstance(fe.ty, N.BagT):
                bag_fields.append((name, fe))
            else:
                state["plan"], col = _as_column(state["plan"], fe)
                scalar_pairs.append((name, col))
        # G (grouping attributes, paper §3.1): inherited ancestor ids +
        # this level's unique IDs + scalar output columns. Matched flags
        # ride along so upper nest levels can cast NULL -> empty bag.
        g_here = inherited_g + tuple(local_ids) + tuple(
            col for _, col in scalar_pairs) + tuple(local_matched)

        assert len(bag_fields) <= 1, (
            "standard route supports one nested bag per level "
            "(sibling subqueries require independent subplans)")

        bag_pairs: List[Tuple[str, str]] = []
        for name, fe in bag_fields:
            agg = None
            sub_q = fe
            if isinstance(sub_q, N.SumBy):
                agg = (tuple(sub_q.keys), tuple(sub_q.values))
                sub_q = sub_q.bag_expr
            label_col = fresh_col("lbl")
            child_rename, child_matched = walk(sub_q, {}, g_here,
                                               path + (name,))
            nests.append(NestSpec(
                path=path + (name,), group_cols=g_here,
                rename=child_rename, label_col=label_col,
                matched_cols=child_matched, sum_agg=agg))
            bag_pairs.append((name, label_col))

        return (tuple(scalar_pairs) + tuple(bag_pairs),
                tuple(local_matched))

    flat_agg = None
    if isinstance(e, N.SumBy):
        flat_agg = (tuple(e.keys), tuple(e.values))
        e = e.bag_expr

    top_rename, _top_matched = walk(e, {}, (), ())
    plan = state["plan"]
    for p in pending:
        plan = SelectP(plan, p)
    return StandardPlan(wide=plan, nests=list(nests),
                        top_rename=top_rename, flat_agg=flat_agg)
