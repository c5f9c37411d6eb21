"""Symbolic query shredding — paper Figure 4.

Given a source NRC expression ``e`` of type ``Bag(T)``, produce:

  *  ``F(e)`` — a flat NRC^{Lbl} expression computing the top-level bag
     (bag attributes replaced by labels), and
  *  ``D(e)`` — a *dictionary tree*: for each bag-valued attribute, a
     symbolic dictionary (a lambda from labels to flat bags) plus the
     child tree for its element type.

Following the paper's implementation refinement (§4.2 end), NewLabel
captures only the *relevant attributes* of the free variables of the
shredded sub-expression, which keeps labels narrow and is what makes the
succinct representation effective.

Dictionary trees are meta-level structures here (the paper encodes them
as NRC tuples and unwraps with ``get``; the two are isomorphic — a meta
tree avoids noise in materialization).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, Optional, Tuple

from . import nrc as N


# ---------------------------------------------------------------------------
# Dictionary trees
# ---------------------------------------------------------------------------

@dataclass
class DictEntry:
    fun: N.Expr            # LambdaE | InputDictRef  (type DictT)
    child: "DictTreeLike"


@dataclass
class DictTree:
    """Dictionary tree for a tuple type: one entry per bag-valued attr."""
    attrs: Dict[str, DictEntry] = dc_field(default_factory=dict)

    def is_empty(self) -> bool:
        return not self.attrs


@dataclass
class DictTreeUnionT:
    left: "DictTreeLike"
    right: "DictTreeLike"

    def is_empty(self) -> bool:
        return self.left.is_empty() and self.right.is_empty()


DictTreeLike = object  # DictTree | DictTreeUnionT

EMPTY_TREE = DictTree({})


# ---------------------------------------------------------------------------
# Input shredding environment
# ---------------------------------------------------------------------------

def input_flat_type(name: str, ty: N.BagT) -> N.BagT:
    """T^F for an input, with label tags rooted at the input name so they
    agree with interpreter.shred_value / columnar value shredding."""
    return N.flat_type(ty, path=name)  # type: ignore[return-value]


def input_dict_tree(name: str, ty: N.BagT, path: Tuple[str, ...] = ()
                    ) -> DictTree:
    """The symbolic dictionary tree of a shredded *input*: every entry is
    an InputDictRef resolved at materialization time."""
    elem = ty.elem
    tree = DictTree({})
    if not isinstance(elem, N.TupleT):
        return tree
    for attr, fty in elem.fields:
        if isinstance(fty, N.BagT):
            sub_path = path + (attr,)
            tag = f"{name}.{'.'.join(sub_path)}"
            flat_val = N.flat_type(fty, path=tag)
            assert isinstance(flat_val, N.BagT)
            ref = N.InputDictRef(
                name, sub_path, N.DictT(N.LabelT(tag), flat_val))
            tree.attrs[attr] = DictEntry(
                fun=ref, child=input_dict_tree(name, fty, sub_path))
    return tree


@dataclass
class ShredBinding:
    flat: N.Expr          # the ^F counterpart (often a Var)
    tree: DictTreeLike    # the ^D counterpart


ShredEnv = Dict[str, ShredBinding]


def input_env(input_types: Dict[str, N.BagT]) -> ShredEnv:
    """Shredding environment for program inputs."""
    env: ShredEnv = {}
    for name, ty in input_types.items():
        fv = N.Var(f"{name}__F", input_flat_type(name, ty))
        env[name] = ShredBinding(flat=fv, tree=input_dict_tree(name, ty))
    return env


# ---------------------------------------------------------------------------
# The shredding transformation (Figure 4)
# ---------------------------------------------------------------------------

class Shredder:
    def __init__(self, site_prefix: str = "Q"):
        self.site_prefix = site_prefix
        self._site_counter = 0

    def _fresh_tag(self, attr: str) -> str:
        self._site_counter += 1
        return f"{self.site_prefix}.{attr}#{self._site_counter}"

    # -- main dispatch ---------------------------------------------------
    def shred(self, e: N.Expr, env: ShredEnv) -> Tuple[N.Expr, DictTreeLike]:
        """Returns (F(e), D(e))."""
        # line 1: constants (runtime parameters shred like constants —
        # they are scalar-typed and carry no dictionary tree)
        if isinstance(e, (N.Const, N.Param)):
            return e, EMPTY_TREE
        if isinstance(e, N.EmptyBag):
            return N.EmptyBag(N.flat_type(e.ty)), EMPTY_TREE
        # line 2: variables
        if isinstance(e, N.Var):
            if e.name not in env:
                raise NameError(f"shred: unbound variable {e.name}")
            b = env[e.name]
            return b.flat, b.tree
        # lines 3/4: tuple construction
        if isinstance(e, N.TupleE):
            return self._shred_tuple(e, env)
        # lines 5/6: field access
        if isinstance(e, N.Field):
            fb, db = self.shred(e.base, env)
            fty = e.ty
            if isinstance(fty, N.BagT):
                assert isinstance(db, DictTree) and e.attr in db.attrs, (
                    f"no dictionary for bag attribute {e.attr}")
                entry = db.attrs[e.attr]
                flat = N.LookupE(entry.fun, N.Field(fb, e.attr))
                return flat, entry.child
            return N.Field(fb, e.attr), EMPTY_TREE
        # line 7: singleton
        if isinstance(e, N.Singleton):
            fe, de = self.shred(e.elem, env)
            return N.Singleton(fe), de
        # line 8: for-union
        if isinstance(e, N.ForUnion):
            f1, d1 = self.shred(e.source, env)
            st = f1.ty
            assert isinstance(st, N.BagT)
            var_f = N.Var(f"{e.var.name}__F", st.elem)
            env2 = dict(env)
            env2[e.var.name] = ShredBinding(flat=var_f, tree=d1)
            f2, d2 = self.shred(e.body, env2)
            return N.ForUnion(var_f, f1, f2), d2
        # line 9: let
        if isinstance(e, N.LetE):
            f1, d1 = self.shred(e.value, env)
            var_f = N.Var(f"{e.var.name}__F", f1.ty)
            env2 = dict(env)
            env2[e.var.name] = ShredBinding(flat=var_f, tree=d1)
            f2, d2 = self.shred(e.body, env2)
            return N.LetE(var_f, f1, f2), d2
        # line 10: conditional
        if isinstance(e, N.IfThen):
            fc, _ = self.shred(e.cond, env)
            ft, dt = self.shred(e.then, env)
            if e.els is None:
                return N.IfThen(fc, ft, None), dt
            fe2, de2 = self.shred(e.els, env)
            tree: DictTreeLike = dt
            if not de2.is_empty() or not dt.is_empty():
                tree = DictTreeUnionT(dt, de2)
            return N.IfThen(fc, ft, fe2), tree
        # line 11: union
        if isinstance(e, N.UnionE):
            f1, d1 = self.shred(e.left, env)
            f2, d2 = self.shred(e.right, env)
            if d1.is_empty() and d2.is_empty():
                return N.UnionE(f1, f2), EMPTY_TREE
            return N.UnionE(f1, f2), DictTreeUnionT(d1, d2)
        # lines 12/13: operators
        if isinstance(e, N.GetE):
            fe, de = self.shred(e.bag_expr, env)
            return N.GetE(fe), de
        if isinstance(e, N.DeDup):
            fe, de = self.shred(e.bag_expr, env)
            return N.DeDup(fe), de
        if isinstance(e, N.SumBy):
            fe, de = self.shred(e.bag_expr, env)
            # sumBy keys are flat and values are scalars: dict tree unused
            return N.SumBy(fe, e.keys, e.values), EMPTY_TREE
        if isinstance(e, N.GroupBy):
            fe, de = self.shred(e.bag_expr, env)
            assert de.is_empty() or isinstance(de, DictTree), de
            # we support shredding groupBy over flat input only; the GROUP
            # bag of a *shredded* groupBy output is handled natively by the
            # unshredding/standard route.
            assert N.is_flat_type(fe.ty), (
                "groupBy under shredding requires flat input (paper §2.1 "
                "restriction on keys; nested GROUP handled by standard route)")
            return N.GroupBy(fe, e.keys), EMPTY_TREE
        if isinstance(e, N.Cmp):
            fl, _ = self.shred(e.left, env)
            fr, _ = self.shred(e.right, env)
            return N.Cmp(e.op, fl, fr), EMPTY_TREE
        if isinstance(e, N.BoolOp):
            fl, _ = self.shred(e.left, env)
            fr, _ = self.shred(e.right, env)
            return N.BoolOp(e.op, fl, fr), EMPTY_TREE
        if isinstance(e, N.Not):
            fi, _ = self.shred(e.inner, env)
            return N.Not(fi), EMPTY_TREE
        if isinstance(e, N.Arith):
            fl, _ = self.shred(e.left, env)
            fr, _ = self.shred(e.right, env)
            return N.Arith(e.op, fl, fr), EMPTY_TREE
        raise TypeError(f"shred: unsupported node {type(e).__name__}")

    # -- tuple construction (the interesting case) -------------------------
    def _shred_tuple(self, e: N.TupleE, env: ShredEnv
                     ) -> Tuple[N.Expr, DictTreeLike]:
        out_items = []
        tree = DictTree({})
        for name, sub in e.items:
            if isinstance(sub.ty, N.BagT):
                fe, de = self.shred(sub, env)
                tag = self._fresh_tag(name)
                captures, lam = self._close_over(tag, fe)
                out_items.append((name, N.NewLabel(tag, captures)))
                tree.attrs[name] = DictEntry(fun=lam, child=de)
            else:
                fe, _ = self.shred(sub, env)
                out_items.append((name, fe))
        return N.TupleE(tuple(out_items)), tree

    def _close_over(self, tag: str, body: N.Expr
                    ) -> Tuple[tuple, N.LambdaE]:
        """Build the NewLabel captures and the symbolic dictionary

            lambda l. match l = NewLabel_tag(captures) then body'

        capturing only the *used attributes* of the free variables of
        ``body`` (the paper's succinctness refinement)."""
        fvs = sorted(N.free_vars(body).items())
        captures = []       # (capture_name, expr at construction site)
        substitution: Dict[str, N.Expr] = {}
        params = []
        for vname, vty in fvs:
            if isinstance(vty, (N.BagT, N.DictT)):
                # bag-typed free variables are globals (input relations or
                # materialized bags) — NewLabel captures *flat* values only
                # (paper §4.1), so these stay free in the lambda body.
                continue
            v = N.Var(vname, vty)
            if isinstance(vty, N.TupleT):
                used = N.used_attrs(body, vname)
                attrs = sorted(a for a in used if a != "*")
                if "*" in used:
                    attrs = [n for n, _ in vty.fields]
                fields = []
                for a in attrs:
                    cname = f"{vname}__{a}"
                    p = N.Var(cname, vty.field(a))
                    params.append(p)
                    captures.append((cname, N.Field(v, a)))
                    fields.append((a, p))
                substitution[vname] = N.TupleE(tuple(fields))
            else:
                cname = vname
                p = N.Var(cname, vty)
                params.append(p)
                captures.append((cname, v))
                substitution[vname] = p
        body2 = N.subst(body, substitution)
        lparam = N.Var(N.fresh("l"), N.LabelT(tag))
        lam = N.LambdaE(lparam,
                        N.MatchLabel(lparam, tag, tuple(params), body2))
        return tuple(captures), lam


def shred_query(e: N.Expr, env: ShredEnv, site_prefix: str = "Q"
                ) -> Tuple[N.Expr, DictTreeLike]:
    """Shred a bag-typed query. Returns (F(e), D(e))."""
    assert isinstance(e.ty, N.BagT), "queries must be bag-typed"
    return Shredder(site_prefix).shred(e, env)
