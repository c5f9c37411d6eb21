"""Reference NRC interpreter — the pure-Python oracle.

Bags are Python lists, tuples are dicts, labels are ``Label(tag, values)``
namedtuples. Every other execution route (plan language, columnar JAX,
distributed shard_map) is validated against this interpreter.

Also provides *value shredding* and *value unshredding* (paper §4): the
conversion between nested objects and their shredded representation
(top-level flat bag + one materialized dictionary per nesting path, each
a flat bag with a ``label`` column, per §4.6).
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Dict, List, Optional, Tuple

from . import nrc as N

Label = namedtuple("Label", ["tag", "values"])


# ---------------------------------------------------------------------------
# Expression evaluation
# ---------------------------------------------------------------------------

class SymbolicDict:
    """Runtime value of a LambdaE — a recipe from labels to bags."""

    def __init__(self, fn):
        self.fn = fn

    def lookup(self, label):
        return self.fn(label)


class InputDict:
    """Runtime value of an input symbolic dictionary: explicit label->bag."""

    def __init__(self, mapping: Dict[Any, list]):
        self.mapping = mapping

    def lookup(self, label):
        return list(self.mapping.get(label, []))


def _default_for(ty: N.Type):
    if isinstance(ty, N.BagT):
        return []
    if isinstance(ty, N.TupleT):
        return {n: _default_for(t) for n, t in ty.fields}
    if isinstance(ty, N.ScalarT):
        return {"int": 0, "real": 0.0, "string": "", "bool": False,
                "date": 0}[ty.kind]
    if isinstance(ty, N.LabelT):
        return Label(ty.tag, ())
    return None


def eval_expr(e: N.Expr, env: Dict[str, Any]) -> Any:
    """Evaluate an NRC / NRC^{Lbl+lambda} expression under ``env``."""
    if isinstance(e, N.Const):
        return e.value
    if isinstance(e, N.Param):
        return env.get("__params__", {}).get(e.name, e.default)
    if isinstance(e, N.Var):
        if e.name not in env:
            raise NameError(f"unbound variable {e.name}")
        return env[e.name]
    if isinstance(e, N.Field):
        base = eval_expr(e.base, env)
        return base[e.attr]
    if isinstance(e, N.TupleE):
        return {n: eval_expr(x, env) for n, x in e.items}
    if isinstance(e, N.Singleton):
        return [eval_expr(e.elem, env)]
    if isinstance(e, N.EmptyBag):
        return []
    if isinstance(e, N.GetE):
        b = eval_expr(e.bag_expr, env)
        if len(b) == 1:
            return b[0]
        ty = e.ty
        return _default_for(ty)
    if isinstance(e, N.ForUnion):
        src = eval_expr(e.source, env)
        out: list = []
        for row in src:
            env2 = dict(env)
            env2[e.var.name] = row
            out.extend(eval_expr(e.body, env2))
        return out
    if isinstance(e, N.UnionE):
        return list(eval_expr(e.left, env)) + list(eval_expr(e.right, env))
    if isinstance(e, N.LetE):
        env2 = dict(env)
        env2[e.var.name] = eval_expr(e.value, env)
        return eval_expr(e.body, env2)
    if isinstance(e, N.IfThen):
        if eval_expr(e.cond, env):
            return eval_expr(e.then, env)
        if e.els is not None:
            return eval_expr(e.els, env)
        assert isinstance(e.then.ty, N.BagT), "if-then without else must be bag-typed"
        return []
    if isinstance(e, N.Cmp):
        l, r = eval_expr(e.left, env), eval_expr(e.right, env)
        return {"==": l == r, "!=": l != r, "<": l < r, "<=": l <= r,
                ">": l > r, ">=": l >= r}[e.op]
    if isinstance(e, N.BoolOp):
        if e.op == "&&":
            return bool(eval_expr(e.left, env)) and bool(eval_expr(e.right, env))
        return bool(eval_expr(e.left, env)) or bool(eval_expr(e.right, env))
    if isinstance(e, N.Not):
        return not eval_expr(e.inner, env)
    if isinstance(e, N.Arith):
        l, r = eval_expr(e.left, env), eval_expr(e.right, env)
        return {"+": lambda: l + r, "-": lambda: l - r,
                "*": lambda: l * r, "/": lambda: l / r}[e.op]()
    if isinstance(e, N.DeDup):
        rows = eval_expr(e.bag_expr, env)
        seen, out = set(), []
        for row in rows:
            key = _hashable(row)
            if key not in seen:
                seen.add(key)
                out.append(row)
        return out
    if isinstance(e, N.GroupBy):
        rows = eval_expr(e.bag_expr, env)
        keys = e.keys
        groups: Dict[Any, list] = {}
        order: list = []
        for row in rows:
            k = tuple(row[a] for a in keys)
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append({a: v for a, v in row.items() if a not in keys})
        return [dict(zip(keys, k), GROUP=groups[k]) for k in order]
    if isinstance(e, N.SumBy):
        rows = eval_expr(e.bag_expr, env)
        keys, vals = e.keys, e.values
        acc: Dict[Any, list] = {}
        order = []
        for row in rows:
            k = tuple(row[a] for a in keys)
            if k not in acc:
                acc[k] = [0] * len(vals)
                order.append(k)
            for i, v in enumerate(vals):
                acc[k][i] += row[v]
        return [dict(zip(keys, k), **dict(zip(vals, acc[k]))) for k in order]
    # ---- shredding extensions ------------------------------------
    if isinstance(e, N.NewLabel):
        return Label(e.tag, tuple(_hashable(eval_expr(x, env))
                                  for _, x in e.captures))
    if isinstance(e, N.MatchLabel):
        lab = eval_expr(e.label, env)
        if not isinstance(lab, Label) or lab.tag != e.tag:
            return [] if isinstance(e.body.ty, N.BagT) else _default_for(e.body.ty)
        env2 = dict(env)
        for p, v in zip(e.params, lab.values):
            env2[p.name] = v
        return eval_expr(e.body, env2)
    if isinstance(e, N.LambdaE):
        captured = dict(env)

        def fn(label, _e=e, _env=captured):
            env2 = dict(_env)
            env2[_e.param.name] = label
            return eval_expr(_e.body, env2)

        return SymbolicDict(fn)
    if isinstance(e, N.InputDictRef):
        store = env.get("__input_dicts__", {})
        key = (e.name, e.path)
        if key not in store:
            raise NameError(f"input dictionary {e.name}^D.{'.'.join(e.path)} "
                            f"not provided")
        return store[key]
    if isinstance(e, N.LookupE):
        d = eval_expr(e.dict_expr, env)
        lab = eval_expr(e.label, env)
        return d.lookup(lab)
    if isinstance(e, N.MatLookup):
        rows = eval_expr(e.matdict, env)
        lab = eval_expr(e.label, env)
        return [{a: v for a, v in row.items() if a != "label"}
                for row in rows if row["label"] == lab]
    raise TypeError(f"eval: unknown node {type(e).__name__}")


def _hashable(v):
    if isinstance(v, dict):
        return tuple((k, _hashable(x)) for k, x in sorted(v.items()))
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    return v


def eval_program(p: N.Program, env: Dict[str, Any]) -> Dict[str, Any]:
    """Execute a program's assignments sequentially; returns final env."""
    env = dict(env)
    for a in p.assignments:
        env[a.name] = eval_expr(a.expr, env)
    return env


# ---------------------------------------------------------------------------
# Value shredding / unshredding (paper §4; materialized flat encoding §4.6)
# ---------------------------------------------------------------------------

def shred_value(bag: list, ty: N.BagT, root: str) -> Dict[tuple, list]:
    """Shred a nested bag into {path: flat bag}.

    path () is the top-level bag; every other path is a materialized
    dictionary whose rows carry a ``label`` column. Labels are
    ``Label(f"{root}.{'.'.join(path)}", (row_id,))`` — integer identities,
    exactly the succinct-representation encoding (shared inner bags keep
    one label).
    """
    out: Dict[tuple, list] = {}
    counters: Dict[tuple, int] = {}

    def go(rows: list, elem_ty: N.Type, path: tuple) -> list:
        flat_rows = []
        assert isinstance(elem_ty, N.TupleT), (
            "shredding assumes tuple-element bags at every level")
        for row in rows:
            new_row = {}
            for name, fty in elem_ty.fields:
                if isinstance(fty, N.BagT):
                    sub_path = path + (name,)
                    tag = f"{root}.{'.'.join(sub_path)}"
                    rid = counters.get(sub_path, 0)
                    counters[sub_path] = rid + 1
                    lab = Label(tag, (rid,))
                    child_rows = go(row[name], fty.elem, sub_path)
                    dict_bag = out.setdefault(sub_path, [])
                    for cr in child_rows:
                        dict_bag.append(dict({"label": lab}, **cr))
                    new_row[name] = lab
                else:
                    new_row[name] = row[name]
            flat_rows.append(new_row)
        return flat_rows

    out[()] = go(bag, ty.elem, ())
    # ensure empty dictionaries exist for all paths in the type
    def ensure(elem_ty: N.Type, path: tuple):
        assert isinstance(elem_ty, N.TupleT)
        for name, fty in elem_ty.fields:
            if isinstance(fty, N.BagT):
                out.setdefault(path + (name,), [])
                ensure(fty.elem, path + (name,))
    ensure(ty.elem, ())
    return out


def unshred_value(shredded: Dict[tuple, list], ty: N.BagT) -> list:
    """Inverse of shred_value: rebuild the nested bag from flat bags."""
    # index dictionaries by label for O(1) lookup
    index: Dict[tuple, Dict[Any, list]] = {}
    for path, rows in shredded.items():
        if path == ():
            continue
        by_label: Dict[Any, list] = {}
        for row in rows:
            by_label.setdefault(row["label"], []).append(
                {a: v for a, v in row.items() if a != "label"})
        index[path] = by_label

    def go(rows: list, elem_ty: N.Type, path: tuple) -> list:
        assert isinstance(elem_ty, N.TupleT)
        out_rows = []
        for row in rows:
            new_row = {}
            for name, fty in elem_ty.fields:
                if isinstance(fty, N.BagT):
                    sub_path = path + (name,)
                    lab = row[name]
                    children = index.get(sub_path, {}).get(lab, [])
                    new_row[name] = go(children, fty.elem, sub_path)
                else:
                    new_row[name] = row[name]
            out_rows.append(new_row)
        return out_rows

    return go(shredded[()], ty.elem, ())


def input_dict_store(shredded_inputs: Dict[str, Dict[tuple, list]]
                     ) -> Dict[Tuple[str, tuple], InputDict]:
    """Build the __input_dicts__ store for symbolic-program evaluation:
    (name, path) -> InputDict(label -> bag-without-label-column)."""
    store: Dict[Tuple[str, tuple], InputDict] = {}
    for name, parts in shredded_inputs.items():
        for path, rows in parts.items():
            if path == ():
                continue
            mapping: Dict[Any, list] = {}
            for row in rows:
                mapping.setdefault(row["label"], []).append(
                    {a: v for a, v in row.items() if a != "label"})
            store[(name, path)] = InputDict(mapping)
    return store


# ---------------------------------------------------------------------------
# Bag comparison helpers (multiset equality, order-insensitive)
# ---------------------------------------------------------------------------

def normalize_value(v, float_digits: int = 6):
    """Canonical form for multiset comparison of nested values."""
    if isinstance(v, dict):
        return tuple(sorted((k, normalize_value(x, float_digits))
                            for k, x in v.items()))
    if isinstance(v, list):
        return tuple(sorted(normalize_value(x, float_digits) for x in v))
    if isinstance(v, float):
        return round(v, float_digits)
    if isinstance(v, Label):
        return ("__label__", v.tag, v.values)
    return v


def bags_equal(a: list, b: list, float_digits: int = 6) -> bool:
    na = sorted(normalize_value(x, float_digits) for x in a)
    nb = sorted(normalize_value(x, float_digits) for x in b)
    return na == nb
