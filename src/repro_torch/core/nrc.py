"""NRC — Nested Relational Calculus AST and type system.

This is the paper's source language (Figure 1) plus the shredded
intermediate language NRC^{Lbl+lambda} (Section 4.1): labels, label
matching, dictionary lookups, and materialized-dictionary lookups.

Types
-----
  T ::= S | Bag(F | S) | <a1:T1, ..., an:Tn> | Label | Label -> Bag(F)
  S ::= int | real | string | bool | date

Design notes (TPU adaptation, see DESIGN.md §2):
  * every expression node carries its type (`.ty`), computed eagerly at
    construction — queries are therefore type-checked as they are built;
  * strings/dates are scalar kinds here; the columnar backend encodes
    them as int32 (dictionary encoding) without changing NRC semantics;
  * labels carry a *tag* naming their NewLabel site (or input path), the
    mechanism the paper uses to keep label domains monomorphic (§4.3
    "we form separate label domains for each tag").
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence


# ---------------------------------------------------------------------------
# Types
# ---------------------------------------------------------------------------

class Type:
    """Base class for NRC types."""

    def is_bag(self) -> bool:
        return isinstance(self, BagT)

    def is_tuple(self) -> bool:
        return isinstance(self, TupleT)

    def is_scalar(self) -> bool:
        return isinstance(self, ScalarT)

    def is_label(self) -> bool:
        return isinstance(self, LabelT)


@dataclass(frozen=True)
class ScalarT(Type):
    kind: str  # int | real | string | bool | date

    def __repr__(self) -> str:
        return self.kind


INT = ScalarT("int")
REAL = ScalarT("real")
STRING = ScalarT("string")
BOOL = ScalarT("bool")
DATE = ScalarT("date")

SCALARS = {"int": INT, "real": REAL, "string": STRING, "bool": BOOL,
           "date": DATE}


@dataclass(frozen=True)
class LabelT(Type):
    """Type of labels. ``tag`` identifies the NewLabel site or input path,
    so that every label domain is monomorphic (paper §4.3)."""
    tag: str = "?"

    def __repr__(self) -> str:
        return f"Label[{self.tag}]"


@dataclass(frozen=True)
class TupleT(Type):
    fields: tuple  # tuple[(name, Type), ...] — ordered

    def __post_init__(self):
        assert all(isinstance(t, Type) for _, t in self.fields), self.fields

    @property
    def names(self) -> tuple:
        return tuple(n for n, _ in self.fields)

    def field(self, name: str) -> Type:
        for n, t in self.fields:
            if n == name:
                return t
        raise KeyError(f"tuple type has no field {name!r}; has {self.names}")

    def has(self, name: str) -> bool:
        return any(n == name for n, _ in self.fields)

    def bag_fields(self) -> tuple:
        return tuple((n, t) for n, t in self.fields if t.is_bag())

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}: {t!r}" for n, t in self.fields)
        return f"<{inner}>"


@dataclass(frozen=True)
class BagT(Type):
    elem: Type

    def __post_init__(self):
        assert isinstance(self.elem, (TupleT, ScalarT, LabelT)), self.elem

    def __repr__(self) -> str:
        return f"Bag({self.elem!r})"


@dataclass(frozen=True)
class DictT(Type):
    """Dictionary type Label -> Bag(F)."""
    label: LabelT
    value: BagT

    def __repr__(self) -> str:
        return f"{self.label!r} -> {self.value!r}"


def tuple_t(**fields: Type) -> TupleT:
    return TupleT(tuple(fields.items()))


def bag(elem: Type) -> BagT:
    return BagT(elem)


def is_flat_type(t: Type) -> bool:
    """A *flat* bag has tuple elements whose attributes are all scalars or
    labels (no nested bags)."""
    if isinstance(t, BagT):
        return is_flat_type(t.elem)
    if isinstance(t, TupleT):
        return all(isinstance(ft, (ScalarT, LabelT)) for _, ft in t.fields)
    return isinstance(t, (ScalarT, LabelT))


def flat_type(t: Type, path: str = "") -> Type:
    """T^F from paper §4: replace each bag-valued attribute with a Label."""
    if isinstance(t, BagT):
        return BagT(flat_type(t.elem, path))
    if isinstance(t, TupleT):
        out = []
        for n, ft in t.fields:
            if isinstance(ft, BagT):
                out.append((n, LabelT(f"{path}.{n}" if path else n)))
            else:
                out.append((n, flat_type(ft, f"{path}.{n}" if path else n)))
        return TupleT(tuple(out))
    return t


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class Expr:
    """Base class. Every node has ``.ty``. Convenience accessors build
    field projections / comparisons so queries read close to the paper."""

    ty: Type

    # -- sugar ---------------------------------------------------------
    def f(self, name: str) -> "Field":
        return Field(self, name)

    def __getattr__(self, name: str):
        # Only for lowercase non-dunder names, to keep dataclass internals safe.
        if name.startswith("_") or name in ("ty",):
            raise AttributeError(name)
        ty = object.__getattribute__(self, "ty")
        if isinstance(ty, TupleT) and ty.has(name):
            return Field(self, name)
        raise AttributeError(name)

    def eq(self, other: "Expr") -> "Cmp":
        return Cmp("==", self, as_expr(other))

    def ne(self, other: "Expr") -> "Cmp":
        return Cmp("!=", self, as_expr(other))

    def lt(self, other: "Expr") -> "Cmp":
        return Cmp("<", self, as_expr(other))

    def le(self, other: "Expr") -> "Cmp":
        return Cmp("<=", self, as_expr(other))

    def gt(self, other: "Expr") -> "Cmp":
        return Cmp(">", self, as_expr(other))

    def ge(self, other: "Expr") -> "Cmp":
        return Cmp(">=", self, as_expr(other))

    def __add__(self, other) -> "Arith":
        return Arith("+", self, as_expr(other))

    def __sub__(self, other) -> "Arith":
        return Arith("-", self, as_expr(other))

    def __mul__(self, other) -> "Arith":
        return Arith("*", self, as_expr(other))

    def __truediv__(self, other) -> "Arith":
        return Arith("/", self, as_expr(other))


def as_expr(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return Const(v, BOOL)
    if isinstance(v, int):
        return Const(v, INT)
    if isinstance(v, float):
        return Const(v, REAL)
    if isinstance(v, str):
        return Const(v, STRING)
    raise TypeError(f"cannot lift {v!r} to an NRC expression")


@dataclass(frozen=True)
class Const(Expr):
    value: Any
    ty: Type


@dataclass(frozen=True)
class Var(Expr):
    name: str
    ty: Type

    def __repr__(self) -> str:
        return f"Var({self.name})"


@dataclass(frozen=True)
class Param(Expr):
    """A runtime parameter — a constant lifted out of the query text so
    one compiled program serves a whole family of parameterized queries
    (the plan-cache contract, DESIGN.md "Whole-program compilation").

    Scalar-typed only. ``default`` is the value the parameter was lifted
    from; execution paths substitute it whenever no binding is supplied,
    so a lifted program evaluated without parameters behaves exactly
    like the original."""
    name: str
    ty: Type
    default: Any = None

    def __repr__(self) -> str:
        return f"Param({self.name}={self.default!r})"


LIFTABLE_KINDS = ("int", "real", "bool", "date")


def liftable_const(e: Expr) -> bool:
    """Constants eligible for parameter lifting: scalar kinds whose
    runtime value is a plain number (strings stay inline — they are
    dictionary-encoded at ingest and have no stable runtime image)."""
    return (isinstance(e, Const) and isinstance(e.ty, ScalarT)
            and e.ty.kind in LIFTABLE_KINDS)


@dataclass(frozen=True)
class Field(Expr):
    base: Expr
    attr: str

    @property
    def ty(self) -> Type:  # type: ignore[override]
        bt = self.base.ty
        assert isinstance(bt, TupleT), f".{self.attr} on non-tuple {bt!r}"
        return bt.field(self.attr)


@dataclass(frozen=True)
class TupleE(Expr):
    items: tuple  # tuple[(name, Expr), ...]

    @property
    def ty(self) -> TupleT:  # type: ignore[override]
        return TupleT(tuple((n, e.ty) for n, e in self.items))

    def item(self, name: str) -> Expr:
        for n, e in self.items:
            if n == name:
                return e
        raise KeyError(name)


def record(**items) -> TupleE:
    return TupleE(tuple((n, as_expr(e)) for n, e in items.items()))


@dataclass(frozen=True)
class Singleton(Expr):
    elem: Expr

    @property
    def ty(self) -> BagT:  # type: ignore[override]
        return BagT(self.elem.ty)


@dataclass(frozen=True)
class EmptyBag(Expr):
    ty: Type


@dataclass(frozen=True)
class GetE(Expr):
    """get(e): extract the element of a singleton bag."""
    bag_expr: Expr

    @property
    def ty(self) -> Type:  # type: ignore[override]
        bt = self.bag_expr.ty
        assert isinstance(bt, BagT)
        return bt.elem


@dataclass(frozen=True)
class ForUnion(Expr):
    """for var in source union body  — body must be bag-typed."""
    var: Var
    source: Expr
    body: Expr

    def __post_init__(self):
        st = self.source.ty
        assert isinstance(st, BagT), f"for-source must be a bag, got {st!r}"
        assert self.var.ty == st.elem, (
            f"loop var {self.var.name}:{self.var.ty!r} != elem {st.elem!r}")
        assert isinstance(self.body.ty, BagT), "for-body must be bag-typed"

    @property
    def ty(self) -> BagT:  # type: ignore[override]
        return self.body.ty  # type: ignore[return-value]


def for_in(name: str, source: Expr, body_fn: Callable[[Var], Expr]) -> ForUnion:
    st = source.ty
    assert isinstance(st, BagT)
    v = Var(name, st.elem)
    return ForUnion(v, source, body_fn(v))


@dataclass(frozen=True)
class UnionE(Expr):
    left: Expr
    right: Expr

    def __post_init__(self):
        assert self.left.ty == self.right.ty, (self.left.ty, self.right.ty)

    @property
    def ty(self) -> Type:  # type: ignore[override]
        return self.left.ty


@dataclass(frozen=True)
class LetE(Expr):
    var: Var
    value: Expr
    body: Expr

    @property
    def ty(self) -> Type:  # type: ignore[override]
        return self.body.ty


def let(name: str, value: Expr, body_fn: Callable[[Var], Expr]) -> LetE:
    v = Var(name, value.ty)
    return LetE(v, value, body_fn(v))


@dataclass(frozen=True)
class IfThen(Expr):
    cond: "CondExpr"
    then: Expr
    els: Optional[Expr] = None  # None => empty bag (bag type) / 0-ish scalar

    @property
    def ty(self) -> Type:  # type: ignore[override]
        return self.then.ty


# -- conditions --------------------------------------------------------------

class CondExpr(Expr):
    """Boolean conditions (RelOp / BoolOp / negation). Also usable as a
    BOOL-typed scalar expression."""
    ty: Type = BOOL


@dataclass(frozen=True)
class Cmp(CondExpr):
    op: str  # == != < <= > >=
    left: Expr
    right: Expr
    ty: Type = BOOL


@dataclass(frozen=True)
class BoolOp(CondExpr):
    op: str  # && ||
    left: Expr
    right: Expr
    ty: Type = BOOL


@dataclass(frozen=True)
class Not(CondExpr):
    inner: Expr
    ty: Type = BOOL


@dataclass(frozen=True)
class Arith(Expr):
    op: str  # + - * /
    left: Expr
    right: Expr

    @property
    def ty(self) -> Type:  # type: ignore[override]
        lt, rt = self.left.ty, self.right.ty
        if REAL in (lt, rt) or self.op == "/":
            return REAL
        return lt


@dataclass(frozen=True)
class DeDup(Expr):
    """dedup(e) — input restricted to a *flat* bag (paper §2.1)."""
    bag_expr: Expr

    def __post_init__(self):
        assert is_flat_type(self.bag_expr.ty), (
            f"dedup input must be flat, got {self.bag_expr.ty!r}")

    @property
    def ty(self) -> Type:  # type: ignore[override]
        return self.bag_expr.ty


@dataclass(frozen=True)
class GroupBy(Expr):
    """groupBy_keys(e): per distinct key, a bag GROUP of remaining attrs."""
    bag_expr: Expr
    keys: tuple  # attribute names

    @property
    def ty(self) -> BagT:  # type: ignore[override]
        et = self.bag_expr.ty
        assert isinstance(et, BagT) and isinstance(et.elem, TupleT)
        kf, vf = [], []
        for n, t in et.elem.fields:
            (kf if n in self.keys else vf).append((n, t))
        assert all(isinstance(t, (ScalarT, LabelT)) for _, t in kf), (
            "grouping keys must be flat")
        return BagT(TupleT(tuple(kf) + (("GROUP", BagT(TupleT(tuple(vf)))),)))


@dataclass(frozen=True)
class SumBy(Expr):
    """sumBy^{values}_{keys}(e): per distinct key, sum of value attrs."""
    bag_expr: Expr
    keys: tuple
    values: tuple

    @property
    def ty(self) -> BagT:  # type: ignore[override]
        et = self.bag_expr.ty
        assert isinstance(et, BagT) and isinstance(et.elem, TupleT)
        fields = []
        for n, t in et.elem.fields:
            if n in self.keys:
                assert isinstance(t, (ScalarT, LabelT)), "sumBy keys must be flat"
                fields.append((n, t))
            elif n in self.values:
                fields.append((n, t))
        return BagT(TupleT(tuple(fields)))


# ---------------------------------------------------------------------------
# NRC^{Lbl+lambda} — shredding extensions (paper §4.1)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NewLabel(Expr):
    """NewLabel_tag(a1 := e1, ...): a label capturing flat values.

    Following the paper's refinement, we capture only the *relevant*
    attributes of free variables (name -> scalar/label-typed expression).
    """
    tag: str
    captures: tuple  # tuple[(name, Expr), ...]

    @property
    def ty(self) -> LabelT:  # type: ignore[override]
        return LabelT(self.tag)


@dataclass(frozen=True)
class MatchLabel(Expr):
    """match l = NewLabel_tag(x...) then body — deconstructs a label,
    binding ``params`` (fresh Vars, same order as the site's captures)."""
    label: Expr
    tag: str
    params: tuple  # tuple[Var, ...]
    body: Expr

    @property
    def ty(self) -> Type:  # type: ignore[override]
        return self.body.ty


@dataclass(frozen=True)
class LambdaE(Expr):
    """lambda l. body — dictionaries as label functions."""
    param: Var
    body: Expr

    @property
    def ty(self) -> DictT:  # type: ignore[override]
        assert isinstance(self.param.ty, LabelT)
        bt = self.body.ty
        assert isinstance(bt, BagT)
        return DictT(self.param.ty, bt)


@dataclass(frozen=True)
class InputDictRef(Expr):
    """A reference to an *input* symbolic dictionary (e.g. COP^D.corders^fun).

    ``name`` is the input object, ``path`` the nesting path. Materialization
    resolves these against the value-shredded inputs (MatLookup)."""
    name: str
    path: tuple  # attribute path, e.g. ("corders",) or ("corders","oparts")
    ty: DictT


@dataclass(frozen=True)
class LookupE(Expr):
    """Lookup(dict, label): function application for symbolic dictionaries."""
    dict_expr: Expr
    label: Expr

    @property
    def ty(self) -> BagT:  # type: ignore[override]
        dt = self.dict_expr.ty
        assert isinstance(dt, DictT), dt
        return dt.value


@dataclass(frozen=True)
class MatLookup(Expr):
    """MatLookup(matdict, label): lookup of a label inside a *materialized*
    dictionary — a flat bag carrying a ``label`` column (paper §4.6).
    Result: matching rows with the label column projected away."""
    matdict: Expr
    label: Expr

    @property
    def ty(self) -> BagT:  # type: ignore[override]
        bt = self.matdict.ty
        assert isinstance(bt, BagT) and isinstance(bt.elem, TupleT)
        rest = tuple((n, t) for n, t in bt.elem.fields if n != "label")
        return BagT(TupleT(rest))


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

@dataclass
class Assignment:
    name: str
    expr: Expr
    # role annotations used by the shredded pipeline / unshredding:
    #   "top"   — top-level flat bag of a shredded output
    #   "dict"  — materialized dictionary (has a `label` column)
    #   "plain" — ordinary value
    role: str = "plain"
    # for role == "dict": the nesting path this dictionary materializes,
    # e.g. ("corders",) — used by unshredding and downstream consumers.
    path: tuple = ()
    parent: Optional[str] = None  # name of parent assignment (dict chain)
    label_attr: Optional[str] = None  # attr in parent holding this dict's labels


@dataclass
class Program:
    assignments: list

    def names(self) -> list:
        return [a.name for a in self.assignments]

    def get(self, name: str) -> Assignment:
        for a in self.assignments:
            if a.name == name:
                return a
        raise KeyError(name)

    def __iter__(self):
        return iter(self.assignments)


# ---------------------------------------------------------------------------
# Traversal utilities
# ---------------------------------------------------------------------------

def children(e: Expr) -> list:
    """Immediate sub-expressions of a node."""
    if isinstance(e, (Const, Var, Param, EmptyBag, InputDictRef)):
        return []
    if isinstance(e, Field):
        return [e.base]
    if isinstance(e, TupleE):
        return [x for _, x in e.items]
    if isinstance(e, Singleton):
        return [e.elem]
    if isinstance(e, GetE):
        return [e.bag_expr]
    if isinstance(e, ForUnion):
        return [e.source, e.body]
    if isinstance(e, UnionE):
        return [e.left, e.right]
    if isinstance(e, LetE):
        return [e.value, e.body]
    if isinstance(e, IfThen):
        return [e.cond, e.then] + ([e.els] if e.els is not None else [])
    if isinstance(e, Cmp):
        return [e.left, e.right]
    if isinstance(e, BoolOp):
        return [e.left, e.right]
    if isinstance(e, Not):
        return [e.inner]
    if isinstance(e, Arith):
        return [e.left, e.right]
    if isinstance(e, (DeDup, GroupBy, SumBy)):
        return [e.bag_expr]
    if isinstance(e, NewLabel):
        return [x for _, x in e.captures]
    if isinstance(e, MatchLabel):
        return [e.label, e.body]
    if isinstance(e, LambdaE):
        return [e.body]
    if isinstance(e, LookupE):
        return [e.dict_expr, e.label]
    if isinstance(e, MatLookup):
        return [e.matdict, e.label]
    raise TypeError(f"unknown node {type(e).__name__}")


def free_vars(e: Expr) -> dict:
    """Free variables of ``e`` as {name: Type}."""
    out: dict = {}

    def go(x: Expr, bound: frozenset):
        if isinstance(x, Var):
            if x.name not in bound:
                out.setdefault(x.name, x.ty)
            return
        if isinstance(x, ForUnion):
            go(x.source, bound)
            go(x.body, bound | {x.var.name})
            return
        if isinstance(x, LetE):
            go(x.value, bound)
            go(x.body, bound | {x.var.name})
            return
        if isinstance(x, LambdaE):
            go(x.body, bound | {x.param.name})
            return
        if isinstance(x, MatchLabel):
            go(x.label, bound)
            go(x.body, bound | {p.name for p in x.params})
            return
        for c in children(x):
            go(c, bound)

    go(e, frozenset())
    return out


def used_attrs(e: Expr, var_name: str) -> set:
    """Attributes of variable ``var_name`` referenced as ``var.attr``
    anywhere in ``e`` (the paper's label-capture refinement). If the
    variable is used *whole* (not under a Field), returns None-marker
    '*'. Shadowing-aware."""
    out: set = set()

    def go(x: Expr, bound: frozenset):
        if isinstance(x, Field) and isinstance(x.base, Var) \
                and x.base.name == var_name and var_name not in bound:
            out.add(x.attr)
            return
        if isinstance(x, Var) and x.name == var_name and var_name not in bound:
            out.add("*")
            return
        if isinstance(x, ForUnion):
            go(x.source, bound)
            go(x.body, bound | {x.var.name})
            return
        if isinstance(x, LetE):
            go(x.value, bound)
            go(x.body, bound | {x.var.name})
            return
        if isinstance(x, LambdaE):
            go(x.body, bound | {x.param.name})
            return
        if isinstance(x, MatchLabel):
            go(x.label, bound)
            go(x.body, bound | {p.name for p in x.params})
            return
        for c in children(x):
            go(c, bound)

    go(e, frozenset())
    return out


def subst(e: Expr, mapping: Mapping[str, Expr]) -> Expr:
    """Capture-avoiding-enough substitution of variables by expressions.
    Bound variables are assumed globally fresh (we generate fresh names
    everywhere), so no alpha-renaming is performed."""
    if not mapping:
        return e
    if isinstance(e, Var):
        return mapping.get(e.name, e)
    if isinstance(e, (Const, Param, EmptyBag, InputDictRef)):
        return e
    if isinstance(e, Field):
        base = subst(e.base, mapping)
        # beta-reduce tuple projection for cleanliness
        if isinstance(base, TupleE):
            return base.item(e.attr)
        return Field(base, e.attr)
    if isinstance(e, TupleE):
        return TupleE(tuple((n, subst(x, mapping)) for n, x in e.items))
    if isinstance(e, Singleton):
        return Singleton(subst(e.elem, mapping))
    if isinstance(e, GetE):
        return GetE(subst(e.bag_expr, mapping))
    if isinstance(e, ForUnion):
        m2 = {k: v for k, v in mapping.items() if k != e.var.name}
        return ForUnion(e.var, subst(e.source, mapping), subst(e.body, m2))
    if isinstance(e, UnionE):
        return UnionE(subst(e.left, mapping), subst(e.right, mapping))
    if isinstance(e, LetE):
        m2 = {k: v for k, v in mapping.items() if k != e.var.name}
        return LetE(e.var, subst(e.value, mapping), subst(e.body, m2))
    if isinstance(e, IfThen):
        return IfThen(subst(e.cond, mapping), subst(e.then, mapping),
                      subst(e.els, mapping) if e.els is not None else None)
    if isinstance(e, Cmp):
        return Cmp(e.op, subst(e.left, mapping), subst(e.right, mapping))
    if isinstance(e, BoolOp):
        return BoolOp(e.op, subst(e.left, mapping), subst(e.right, mapping))
    if isinstance(e, Not):
        return Not(subst(e.inner, mapping))
    if isinstance(e, Arith):
        return Arith(e.op, subst(e.left, mapping), subst(e.right, mapping))
    if isinstance(e, DeDup):
        return DeDup(subst(e.bag_expr, mapping))
    if isinstance(e, GroupBy):
        return GroupBy(subst(e.bag_expr, mapping), e.keys)
    if isinstance(e, SumBy):
        return SumBy(subst(e.bag_expr, mapping), e.keys, e.values)
    if isinstance(e, NewLabel):
        return NewLabel(e.tag, tuple((n, subst(x, mapping)) for n, x in e.captures))
    if isinstance(e, MatchLabel):
        m2 = {k: v for k, v in mapping.items()
              if k not in {p.name for p in e.params}}
        return MatchLabel(subst(e.label, mapping), e.tag, e.params,
                          subst(e.body, m2))
    if isinstance(e, LambdaE):
        m2 = {k: v for k, v in mapping.items() if k != e.param.name}
        return LambdaE(e.param, subst(e.body, m2))
    if isinstance(e, LookupE):
        return LookupE(subst(e.dict_expr, mapping), subst(e.label, mapping))
    if isinstance(e, MatLookup):
        return MatLookup(subst(e.matdict, mapping), subst(e.label, mapping))
    raise TypeError(f"subst: unknown node {type(e).__name__}")


def inline_lets(e: Expr) -> Expr:
    """Recursively inline let bindings (paper Fig. 5 NORMALIZE)."""
    if isinstance(e, LetE):
        return inline_lets(subst(e.body, {e.var.name: inline_lets(e.value)}))
    if isinstance(e, (Const, Var, Param, EmptyBag, InputDictRef)):
        return e
    if isinstance(e, Field):
        base = inline_lets(e.base)
        if isinstance(base, TupleE):
            return inline_lets(base.item(e.attr))
        return Field(base, e.attr)
    if isinstance(e, TupleE):
        return TupleE(tuple((n, inline_lets(x)) for n, x in e.items))
    if isinstance(e, Singleton):
        return Singleton(inline_lets(e.elem))
    if isinstance(e, GetE):
        return GetE(inline_lets(e.bag_expr))
    if isinstance(e, ForUnion):
        return ForUnion(e.var, inline_lets(e.source), inline_lets(e.body))
    if isinstance(e, UnionE):
        return UnionE(inline_lets(e.left), inline_lets(e.right))
    if isinstance(e, IfThen):
        return IfThen(inline_lets(e.cond), inline_lets(e.then),
                      inline_lets(e.els) if e.els is not None else None)
    if isinstance(e, Cmp):
        return Cmp(e.op, inline_lets(e.left), inline_lets(e.right))
    if isinstance(e, BoolOp):
        return BoolOp(e.op, inline_lets(e.left), inline_lets(e.right))
    if isinstance(e, Not):
        return Not(inline_lets(e.inner))
    if isinstance(e, Arith):
        return Arith(e.op, inline_lets(e.left), inline_lets(e.right))
    if isinstance(e, DeDup):
        return DeDup(inline_lets(e.bag_expr))
    if isinstance(e, GroupBy):
        return GroupBy(inline_lets(e.bag_expr), e.keys)
    if isinstance(e, SumBy):
        return SumBy(inline_lets(e.bag_expr), e.keys, e.values)
    if isinstance(e, NewLabel):
        return NewLabel(e.tag, tuple((n, inline_lets(x)) for n, x in e.captures))
    if isinstance(e, MatchLabel):
        return MatchLabel(inline_lets(e.label), e.tag, e.params,
                          inline_lets(e.body))
    if isinstance(e, LambdaE):
        return LambdaE(e.param, inline_lets(e.body))
    if isinstance(e, LookupE):
        return LookupE(inline_lets(e.dict_expr), inline_lets(e.label))
    if isinstance(e, MatLookup):
        return MatLookup(inline_lets(e.matdict), inline_lets(e.label))
    raise TypeError(f"inline_lets: unknown node {type(e).__name__}")


def map_expr(e: Expr, f: Callable[[Expr], Expr]) -> Expr:
    """Bottom-up rebuild: children first, then ``f`` at every node.
    ``f`` must preserve the node's type (used by parameter lifting and
    other local rewrites)."""
    def go(x: Expr) -> Expr:
        if isinstance(x, (Const, Var, Param, EmptyBag, InputDictRef)):
            return f(x)
        if isinstance(x, Field):
            return f(Field(go(x.base), x.attr))
        if isinstance(x, TupleE):
            return f(TupleE(tuple((n, go(v)) for n, v in x.items)))
        if isinstance(x, Singleton):
            return f(Singleton(go(x.elem)))
        if isinstance(x, GetE):
            return f(GetE(go(x.bag_expr)))
        if isinstance(x, ForUnion):
            return f(ForUnion(x.var, go(x.source), go(x.body)))
        if isinstance(x, UnionE):
            return f(UnionE(go(x.left), go(x.right)))
        if isinstance(x, LetE):
            return f(LetE(x.var, go(x.value), go(x.body)))
        if isinstance(x, IfThen):
            return f(IfThen(go(x.cond), go(x.then),
                            go(x.els) if x.els is not None else None))
        if isinstance(x, Cmp):
            return f(Cmp(x.op, go(x.left), go(x.right)))
        if isinstance(x, BoolOp):
            return f(BoolOp(x.op, go(x.left), go(x.right)))
        if isinstance(x, Not):
            return f(Not(go(x.inner)))
        if isinstance(x, Arith):
            return f(Arith(x.op, go(x.left), go(x.right)))
        if isinstance(x, DeDup):
            return f(DeDup(go(x.bag_expr)))
        if isinstance(x, GroupBy):
            return f(GroupBy(go(x.bag_expr), x.keys))
        if isinstance(x, SumBy):
            return f(SumBy(go(x.bag_expr), x.keys, x.values))
        if isinstance(x, NewLabel):
            return f(NewLabel(x.tag,
                              tuple((n, go(v)) for n, v in x.captures)))
        if isinstance(x, MatchLabel):
            return f(MatchLabel(go(x.label), x.tag, x.params, go(x.body)))
        if isinstance(x, LambdaE):
            return f(LambdaE(x.param, go(x.body)))
        if isinstance(x, LookupE):
            return f(LookupE(go(x.dict_expr), go(x.label)))
        if isinstance(x, MatLookup):
            return f(MatLookup(go(x.matdict), go(x.label)))
        raise TypeError(f"map_expr: unknown node {type(x).__name__}")

    return go(e)


def lift_constants(e: Expr, prefix: str = "__p",
                   values: Optional[list] = None) -> tuple:
    """Replace every liftable constant with a ``Param`` named by its
    pre-order position; appends the lifted values to ``values``.
    Returns ``(lifted_expr, values)``.

    Two queries that differ only in liftable constant values lift to the
    SAME expression with the SAME parameter names — the basis of the
    plan-cache fingerprint (serve.query_service)."""
    vals: list = values if values is not None else []

    def f(x: Expr) -> Expr:
        if liftable_const(x):
            p = Param(f"{prefix}{len(vals)}", x.ty, default=x.value)
            vals.append(x.value)
            return p
        return x

    # map_expr is bottom-up, which does not give pre-order numbering;
    # numbering only needs to be DETERMINISTIC, and bottom-up
    # left-to-right is.
    return map_expr(e, f), vals


def expr_fingerprint(e: Expr) -> tuple:
    """Structural fingerprint of an expression: a nested tuple that is
    equal iff the expressions are structurally identical (types
    included, Param defaults excluded). Hashable."""
    if isinstance(e, Const):
        return ("const", e.value, repr(e.ty))
    if isinstance(e, Param):
        return ("param", e.name, repr(e.ty))
    if isinstance(e, Var):
        return ("var", e.name, repr(e.ty))
    if isinstance(e, Field):
        return ("field", expr_fingerprint(e.base), e.attr)
    if isinstance(e, TupleE):
        return ("tuple",) + tuple((n, expr_fingerprint(v))
                                  for n, v in e.items)
    if isinstance(e, EmptyBag):
        return ("empty", repr(e.ty))
    if isinstance(e, ForUnion):
        return ("for", e.var.name, expr_fingerprint(e.source),
                expr_fingerprint(e.body))
    if isinstance(e, LetE):
        return ("let", e.var.name, expr_fingerprint(e.value),
                expr_fingerprint(e.body))
    if isinstance(e, IfThen):
        return ("if", expr_fingerprint(e.cond), expr_fingerprint(e.then),
                expr_fingerprint(e.els) if e.els is not None else None)
    if isinstance(e, (Cmp, BoolOp, Arith)):
        return (type(e).__name__, e.op, expr_fingerprint(e.left),
                expr_fingerprint(e.right))
    if isinstance(e, GroupBy):
        return ("groupby", expr_fingerprint(e.bag_expr), e.keys)
    if isinstance(e, SumBy):
        return ("sumby", expr_fingerprint(e.bag_expr), e.keys, e.values)
    if isinstance(e, NewLabel):
        return ("newlabel", e.tag,
                tuple((n, expr_fingerprint(v)) for n, v in e.captures))
    if isinstance(e, MatchLabel):
        return ("match", expr_fingerprint(e.label), e.tag,
                tuple(p.name for p in e.params), expr_fingerprint(e.body))
    if isinstance(e, LambdaE):
        return ("lam", e.param.name, expr_fingerprint(e.body))
    if isinstance(e, InputDictRef):
        return ("idict", e.name, e.path)
    if isinstance(e, (Singleton, GetE, Not, DeDup, UnionE, LookupE,
                      MatLookup)):
        return (type(e).__name__,) + tuple(expr_fingerprint(c)
                                           for c in children(e))
    raise TypeError(f"expr_fingerprint: unknown node {type(e).__name__}")


def program_fingerprint(p: Program) -> tuple:
    """Structural fingerprint of a whole program (assignment names,
    roles and expression structures)."""
    return tuple((a.name, a.role, a.path, expr_fingerprint(a.expr))
                 for a in p.assignments)


# ---------------------------------------------------------------------------
# Pretty printer (debugging / plan inspection)
# ---------------------------------------------------------------------------

def pretty(e: Expr, indent: int = 0) -> str:
    pad = "  " * indent

    if isinstance(e, Const):
        return repr(e.value)
    if isinstance(e, Param):
        return f"${e.name}"
    if isinstance(e, Var):
        return e.name
    if isinstance(e, Field):
        return f"{pretty(e.base)}.{e.attr}"
    if isinstance(e, TupleE):
        inner = ", ".join(f"{n} := {pretty(x, indent + 1)}" for n, x in e.items)
        return f"⟨{inner}⟩"
    if isinstance(e, Singleton):
        return f"{{{pretty(e.elem, indent)}}}"
    if isinstance(e, EmptyBag):
        return "∅"
    if isinstance(e, GetE):
        return f"get({pretty(e.bag_expr)})"
    if isinstance(e, ForUnion):
        return (f"for {e.var.name} in {pretty(e.source, indent)} union\n"
                f"{pad}  {pretty(e.body, indent + 1)}")
    if isinstance(e, UnionE):
        return f"({pretty(e.left, indent)} ⊎ {pretty(e.right, indent)})"
    if isinstance(e, LetE):
        return (f"let {e.var.name} := {pretty(e.value, indent)} in\n"
                f"{pad}  {pretty(e.body, indent + 1)}")
    if isinstance(e, IfThen):
        s = f"if {pretty(e.cond)} then {pretty(e.then, indent + 1)}"
        if e.els is not None:
            s += f" else {pretty(e.els, indent + 1)}"
        return s
    if isinstance(e, Cmp):
        return f"{pretty(e.left)} {e.op} {pretty(e.right)}"
    if isinstance(e, BoolOp):
        return f"({pretty(e.left)} {e.op} {pretty(e.right)})"
    if isinstance(e, Not):
        return f"¬({pretty(e.inner)})"
    if isinstance(e, Arith):
        return f"({pretty(e.left)} {e.op} {pretty(e.right)})"
    if isinstance(e, DeDup):
        return f"dedup({pretty(e.bag_expr, indent)})"
    if isinstance(e, GroupBy):
        return f"groupBy_{{{','.join(e.keys)}}}({pretty(e.bag_expr, indent)})"
    if isinstance(e, SumBy):
        return (f"sumBy_{{{','.join(e.keys)}}}^{{{','.join(e.values)}}}"
                f"({pretty(e.bag_expr, indent)})")
    if isinstance(e, NewLabel):
        inner = ", ".join(f"{n}={pretty(x)}" for n, x in e.captures)
        return f"NewLabel_{e.tag}({inner})"
    if isinstance(e, MatchLabel):
        ps = ", ".join(p.name for p in e.params)
        return (f"match {pretty(e.label)} = NewLabel_{e.tag}({ps}) then\n"
                f"{pad}  {pretty(e.body, indent + 1)}")
    if isinstance(e, LambdaE):
        return f"λ{e.param.name}. {pretty(e.body, indent)}"
    if isinstance(e, InputDictRef):
        return f"{e.name}^D.{'.'.join(e.path)}"
    if isinstance(e, LookupE):
        return f"Lookup({pretty(e.dict_expr)}, {pretty(e.label)})"
    if isinstance(e, MatLookup):
        return f"MatLookup({pretty(e.matdict)}, {pretty(e.label)})"
    return f"<{type(e).__name__}>"


def pretty_program(p: Program) -> str:
    lines = []
    for a in p.assignments:
        head = f"{a.name} ⇐  # role={a.role}" + (f" path={a.path}" if a.path else "")
        lines.append(head)
        lines.append("  " + pretty(a.expr, 1))
        lines.append("")
    return "\n".join(lines)


# fresh-name supply ----------------------------------------------------------

_counter = [0]


def fresh(prefix: str = "v") -> str:
    _counter[0] += 1
    return f"{prefix}_{_counter[0]}"
