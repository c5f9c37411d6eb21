"""Materialization — paper Figure 5 + domain elimination (§4.4).

Turns the symbolic shredded form (flat expression + dictionary tree of
lambda-terms) into a *sequence of assignments* over flat bags only:

  TOP          <= flat expression (labels in place of inner bags)
  LabDomain_p  <= dedup(for x in PARENT union {<label := x.a>})   [baseline]
  MatDict_p    <= for l in LabDomain_p union ... fun(l.label) ...

Materialized dictionaries use the paper's flat encoding (§4.6): a bag
whose rows carry a ``label`` column — the per-label value bag is the set
of rows sharing the label. Consequently the groupBy in domain-elimination
rule 2 is *implicit* (no physical grouping is materialized), which is
exactly what the generated Spark code does in the paper.

Domain elimination implements both §4.4 rules plus the paper's sumBy
extension of rule 1 (the "localized aggregation" enabling optimization).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from . import nrc as N
from .shredding import (DictEntry, DictTree, DictTreeUnionT, ShredBinding,
                        ShredEnv, Shredder, input_dict_tree, input_env,
                        input_flat_type)


def mat_input_name(name: str, path: Tuple[str, ...]) -> str:
    return f"{name}__D_{'_'.join(path)}" if path else f"{name}__F"


@dataclass
class Manifest:
    """What a shredded query materialized: names of its parts."""
    source: str                      # source assignment name
    ty: N.BagT                       # original nested type
    top: str = ""                    # name of top-level flat assignment
    dicts: Dict[tuple, str] = dc_field(default_factory=dict)   # path -> name
    tags: Dict[tuple, str] = dc_field(default_factory=dict)    # path -> label tag


@dataclass
class Resolver:
    """Maps symbolic dictionaries to materialized assignment names."""
    inputs: Dict[Tuple[str, tuple], str] = dc_field(default_factory=dict)
    mat_types: Dict[str, N.BagT] = dc_field(default_factory=dict)

    def resolve_input(self, ref: N.InputDictRef) -> N.Var:
        key = (ref.name, ref.path)
        if key not in self.inputs:
            raise KeyError(f"unresolved input dictionary {key}")
        name = self.inputs[key]
        return N.Var(name, self.mat_types[name])

    def register(self, key: Tuple[str, tuple], name: str, ty: N.BagT):
        self.inputs[key] = name
        self.mat_types[name] = ty


def _with_label_type(value_bag: N.BagT, tag: str) -> N.BagT:
    elem = value_bag.elem
    assert isinstance(elem, N.TupleT)
    return N.BagT(N.TupleT((("label", N.LabelT(tag)),) + elem.fields))


# ---------------------------------------------------------------------------
# ReplaceSymbolicDicts (Fig. 5 helper)
# ---------------------------------------------------------------------------

def replace_symbolic_dicts(e: N.Expr, resolver: Resolver) -> N.Expr:
    """1) Lookup over an input dictionary -> MatLookup over its
    materialized bag; 2) beta-reduce Lookup over lambdas; 3) Lookup over a
    DictTreeUnion is meta-level here (handled in materialize). Lets are
    inlined first (NORMALIZE)."""
    e = N.inline_lets(e)

    def go(x: N.Expr) -> N.Expr:
        if isinstance(x, N.LookupE):
            d = go(x.dict_expr)
            lab = go(x.label)
            if isinstance(d, N.InputDictRef):
                return N.MatLookup(resolver.resolve_input(d), lab)
            if isinstance(d, N.LambdaE):
                body = N.subst(d.body, {d.param.name: lab})
                return go(_static_match(body))
            raise TypeError(f"Lookup over non-dictionary {type(d).__name__}")
        if isinstance(x, (N.Const, N.Param, N.Var, N.EmptyBag,
                          N.InputDictRef)):
            return x
        if isinstance(x, N.Field):
            return N.Field(go(x.base), x.attr)
        if isinstance(x, N.TupleE):
            return N.TupleE(tuple((n, go(v)) for n, v in x.items))
        if isinstance(x, N.Singleton):
            return N.Singleton(go(x.elem))
        if isinstance(x, N.GetE):
            return N.GetE(go(x.bag_expr))
        if isinstance(x, N.ForUnion):
            return N.ForUnion(x.var, go(x.source), go(x.body))
        if isinstance(x, N.UnionE):
            return N.UnionE(go(x.left), go(x.right))
        if isinstance(x, N.IfThen):
            return N.IfThen(go(x.cond), go(x.then),
                            go(x.els) if x.els is not None else None)
        if isinstance(x, N.Cmp):
            return N.Cmp(x.op, go(x.left), go(x.right))
        if isinstance(x, N.BoolOp):
            return N.BoolOp(x.op, go(x.left), go(x.right))
        if isinstance(x, N.Not):
            return N.Not(go(x.inner))
        if isinstance(x, N.Arith):
            return N.Arith(x.op, go(x.left), go(x.right))
        if isinstance(x, N.DeDup):
            return N.DeDup(go(x.bag_expr))
        if isinstance(x, N.GroupBy):
            return N.GroupBy(go(x.bag_expr), x.keys)
        if isinstance(x, N.SumBy):
            return N.SumBy(go(x.bag_expr), x.keys, x.values)
        if isinstance(x, N.NewLabel):
            return N.NewLabel(x.tag, tuple((n, go(v)) for n, v in x.captures))
        if isinstance(x, N.MatchLabel):
            return _static_match(
                N.MatchLabel(go(x.label), x.tag, x.params, go(x.body)))
        if isinstance(x, N.LambdaE):
            return N.LambdaE(x.param, go(x.body))
        if isinstance(x, N.MatLookup):
            return N.MatLookup(go(x.matdict), go(x.label))
        raise TypeError(f"replace_symbolic_dicts: {type(x).__name__}")

    return go(e)


def _static_match(e: N.Expr) -> N.Expr:
    """match NewLabel_t(vs) = NewLabel_t(xs) then body  ==>  body[xs := vs]
    (static beta-reduction when the label is a syntactic NewLabel)."""
    if isinstance(e, N.MatchLabel) and isinstance(e.label, N.NewLabel):
        if e.label.tag == e.tag:
            mapping = {p.name: v for p, (_, v) in zip(e.params, e.label.captures)}
            return N.subst(e.body, mapping)
        # statically mismatched tag: empty bag
        if isinstance(e.body.ty, N.BagT):
            return N.EmptyBag(e.body.ty)
    return e


# ---------------------------------------------------------------------------
# Pattern matching for domain elimination
# ---------------------------------------------------------------------------

def _attach_label(chain: N.Expr, label_expr: N.Expr) -> N.Expr:
    """Rewrite the innermost Singleton(tuple) of a generator chain to
    carry a label column (generalized rule 2 — the label references
    generator variables, so it must be attached in their scope)."""
    if isinstance(chain, N.ForUnion):
        return N.ForUnion(chain.var, chain.source,
                          _attach_label(chain.body, label_expr))
    if isinstance(chain, N.IfThen) and chain.els is None:
        return N.IfThen(chain.cond, _attach_label(chain.then, label_expr))
    if isinstance(chain, N.Singleton):
        elem = chain.elem
        assert isinstance(elem, N.TupleE)
        return N.Singleton(N.TupleE((("label", label_expr),) + elem.items))
    raise TypeError(f"_attach_label: {type(chain).__name__}")


def _flatten_with_label(inner: N.Expr, label_expr: N.Expr) -> N.Expr:
    """for w in inner union { <label := L, **w> }  — attach a label column
    to every row of a flat bag expression."""
    it = inner.ty
    assert isinstance(it, N.BagT) and isinstance(it.elem, N.TupleT), it
    w = N.Var(N.fresh("w"), it.elem)
    fields = (("label", label_expr),) + tuple(
        (n, N.Field(w, n)) for n, _ in it.elem.fields)
    return N.ForUnion(w, inner, N.Singleton(N.TupleE(fields)))


def _only_param_used(body: N.Expr, params: tuple, keep: N.Var) -> bool:
    fv = N.free_vars(body)
    for p in params:
        if p.name == keep.name:
            continue
        if p.name in fv:
            return False
    return True


@dataclass
class _Rule1Match:
    lookup_dict: N.Var      # materialized dict bag (with label column)
    loop_var: N.Var
    inner: N.Expr           # body of the for-loop
    sum_by: Optional[Tuple[tuple, tuple]]  # (keys, values) if sumBy wraps


def _match_rule1(body: N.Expr, params: tuple) -> Optional[_Rule1Match]:
    """lambda l. match l = NewLabel(x) then [sumBy](for y in
    MatLookup(MatD, x.a) union e)  — where x.a is the only used param."""
    sum_by = None
    if isinstance(body, N.SumBy):
        sum_by = (body.keys, body.values)
        body = body.bag_expr
    if not isinstance(body, N.ForUnion):
        return None
    src = body.source
    if not isinstance(src, N.MatLookup):
        return None
    if not isinstance(src.label, N.Var):
        return None
    p = src.label
    if p.name not in {q.name for q in params}:
        return None
    if not isinstance(src.matdict, N.Var):
        return None
    # p must not be used anywhere else (inner body), other params unused
    if not _only_param_used(body.body, params, keep=p):
        return None
    if p.name in N.free_vars(body.body):
        return None
    return _Rule1Match(lookup_dict=src.matdict, loop_var=body.var,
                       inner=body.body, sum_by=sum_by)


@dataclass
class _Rule2MultiMatch:
    """Generalized rule 2 (ours; paper §4.4 rule 2 is the 1-param case):
    every label parameter is *join-bound* — it appears exactly once, in
    an equality with an attribute of a generator inside the body. The
    label-value pairs can then be produced directly from the body's join
    with label := NewLabel(gen_1.a_1, ..., gen_k.a_k), no domain pass."""
    body: N.Expr            # chain with the binding predicates REMOVED
    captures: tuple         # ((param_name, column expr), ...) site order
    sum_by: Optional[Tuple[tuple, tuple]]


def _match_rule2_multi(body: N.Expr, params: tuple
                       ) -> Optional[_Rule2MultiMatch]:
    sum_by = None
    if isinstance(body, N.SumBy):
        sum_by = (body.keys, body.values)
        body = body.bag_expr
    pnames = {p.name for p in params}
    binds: Dict[str, N.Expr] = {}

    def strip(x: N.Expr) -> Optional[N.Expr]:
        """Remove param-binding equality predicates; None on violation.
        Also handles rule-1-style bindings: a generator over
        MatLookup(D, p) becomes a generator over D itself, binding p to
        the dictionary's label column (mixed rule-1/rule-2 case)."""
        if isinstance(x, N.ForUnion):
            src = x.source
            if (isinstance(src, N.MatLookup)
                    and isinstance(src.label, N.Var)
                    and src.label.name in pnames
                    and isinstance(src.matdict, N.Var)):
                p = src.label.name
                if p in binds:
                    return None
                md = src.matdict
                elem = md.ty.elem
                z = N.Var(N.fresh("z"), elem)
                binds[p] = N.Field(z, "label")
                body2 = N.subst(x.body, {x.var.name: z})
                b = strip(body2)
                return None if b is None else N.ForUnion(z, md, b)
            if pnames & set(N.free_vars(src)):
                return None         # params may not reach generator sources
            b = strip(x.body)
            return None if b is None else N.ForUnion(x.var, src, b)
        if isinstance(x, N.IfThen) and x.els is None:
            c = x.cond
            hit = None
            if isinstance(c, N.Cmp) and c.op == "==":
                for a, b in ((c.left, c.right), (c.right, c.left)):
                    if (isinstance(b, N.Var) and b.name in pnames
                            and isinstance(a, N.Field)
                            and not (pnames & set(N.free_vars(a)))):
                        hit = (b.name, a)
                        break
            if hit is not None:
                if hit[0] in binds:
                    return None     # param used twice
                binds[hit[0]] = hit[1]
                return strip(x.then)
            if pnames & set(N.free_vars(c)):
                # conjunction containing a binding? split && of Cmp's
                if isinstance(c, N.BoolOp) and c.op == "&&":
                    inner = N.IfThen(c.left, N.IfThen(c.right, x.then))
                    return strip(inner)
                return None
            t = strip(x.then)
            return None if t is None else N.IfThen(c, t)
        if isinstance(x, N.Singleton):
            return None if (pnames & set(N.free_vars(x))) else x
        return None

    stripped = strip(body)
    if stripped is None or set(binds) != pnames:
        return None
    captures = tuple((p.name, binds[p.name]) for p in params)
    return _Rule2MultiMatch(body=stripped, captures=captures,
                            sum_by=sum_by)


@dataclass
class _Rule2Match:
    source: N.Expr          # Y — a plain flat bag
    loop_var: N.Var
    key_attr: str           # y.a
    inner: N.Expr           # e
    sum_by: Optional[Tuple[tuple, tuple]]


def _match_rule2(body: N.Expr, params: tuple) -> Optional[_Rule2Match]:
    """lambda l. match l = NewLabel(x) then [sumBy](for y in Y union
    if y.a == x.b then e) — x.b the only used param, not free in e."""
    sum_by = None
    if isinstance(body, N.SumBy):
        sum_by = (body.keys, body.values)
        body = body.bag_expr
    if not isinstance(body, N.ForUnion):
        return None
    if isinstance(body.source, (N.MatLookup, N.LookupE)):
        return None
    if not isinstance(body.body, N.IfThen) or body.body.els is not None:
        return None
    cond = body.body.cond
    if not isinstance(cond, N.Cmp) or cond.op != "==":
        return None
    y = body.var
    sides = [(cond.left, cond.right), (cond.right, cond.left)]
    for y_side, p_side in sides:
        if (isinstance(y_side, N.Field) and isinstance(y_side.base, N.Var)
                and y_side.base.name == y.name and isinstance(p_side, N.Var)
                and p_side.name in {q.name for q in params}):
            p = p_side
            inner = body.body.then
            if p.name in N.free_vars(inner):
                continue
            if not _only_param_used(inner, params, keep=p):
                continue
            if p.name in N.free_vars(body.source):
                continue
            return _Rule2Match(source=body.source, loop_var=y,
                               key_attr=y_side.attr, inner=inner,
                               sum_by=sum_by)
    return None


# ---------------------------------------------------------------------------
# MATERIALIZE / MATERIALIZEDICT (Fig. 5)
# ---------------------------------------------------------------------------

class Materializer:
    def __init__(self, resolver: Resolver, domain_elimination: bool = True):
        self.resolver = resolver
        self.domain_elim = domain_elimination
        self.out: List[N.Assignment] = []

    # -- entry point ------------------------------------------------------
    def materialize(self, top_name: str, fexpr: N.Expr, dtree,
                    source_ty: N.BagT) -> Manifest:
        man = Manifest(source=top_name, ty=source_ty)
        f1 = replace_symbolic_dicts(fexpr, self.resolver)
        self.out.append(N.Assignment(top_name, f1, role="top"))
        man.top = top_name
        assert isinstance(f1.ty, N.BagT)
        self.resolver.mat_types[top_name] = f1.ty
        self._mat_dict(dtree, top_name, f1.ty, (), top_name, man)
        return man

    # -- dictionary tree traversal -----------------------------------------
    def _mat_dict(self, tree, parent_name: str, parent_ty: N.BagT,
                  path: tuple, base: str, man: Manifest):
        if isinstance(tree, DictTreeUnionT):
            # materialize both branches against the same parent; per-attr
            # results are unioned below via _union_trees flattening.
            for branch, suffix in ((tree.left, "L"), (tree.right, "R")):
                self._mat_dict(branch, parent_name, parent_ty, path,
                               f"{base}_{suffix}", man)
            return
        assert isinstance(tree, DictTree)
        for attr, entry in tree.attrs.items():
            self._mat_entry(attr, entry, parent_name, parent_ty, path,
                            base, man)

    def _mat_entry(self, attr: str, entry: DictEntry, parent_name: str,
                   parent_ty: N.BagT, path: tuple, base: str, man: Manifest):
        sub_path = path + (attr,)
        fun = entry.fun

        # pass-through: the output dictionary IS an input dictionary
        if isinstance(fun, N.InputDictRef):
            mat = self.resolver.resolve_input(fun)
            man.dicts[sub_path] = mat.name
            man.tags[sub_path] = fun.ty.label.tag
            assert isinstance(mat.ty, N.BagT)
            self._mat_dict(entry.child, mat.name, mat.ty, sub_path, base, man)
            return

        assert isinstance(fun, N.LambdaE), fun
        match_e = fun.body
        assert isinstance(match_e, N.MatchLabel), (
            "symbolic dictionaries are lambda-match recipes")
        tag = match_e.tag
        params = match_e.params
        body = replace_symbolic_dicts(match_e.body, self.resolver)
        matname = f"{base}__D_{'_'.join(sub_path)}"

        emitted = False
        if self.domain_elim:
            m1 = _match_rule1(body, params)
            if m1 is not None:
                self._emit_rule1(matname, tag, m1, sub_path, parent_name,
                                 attr, man)
                emitted = True
            else:
                m2 = _match_rule2(body, params)
                if m2 is not None:
                    self._emit_rule2(matname, tag, m2, sub_path, parent_name,
                                     attr, man)
                    emitted = True
                else:
                    m2m = _match_rule2_multi(body, params)
                    if m2m is not None:
                        self._emit_rule2_multi(matname, tag, m2m, sub_path,
                                               parent_name, attr, man)
                        emitted = True
        if not emitted:
            self._emit_baseline(matname, tag, params, body, sub_path,
                                parent_name, attr, man)

        mat_ty = self.resolver.mat_types[matname]
        self._mat_dict(entry.child, matname, mat_ty, sub_path, base, man)

    # -- baseline materialization (Fig. 5 lines 3-8) -------------------------
    def _emit_baseline(self, matname: str, tag: str, params: tuple,
                       body: N.Expr, sub_path: tuple, parent_name: str,
                       attr: str, man: Manifest):
        parent_ty = self.resolver.mat_types[parent_name]
        assert isinstance(parent_ty.elem, N.TupleT)
        label_ty = parent_ty.elem.field(attr)
        # LabDomain <= dedup(for x in PARENT union {<label := x.attr>})
        dom_name = f"LabDomain_{matname}"
        x = N.Var(N.fresh("x"), parent_ty.elem)
        dom_expr = N.DeDup(N.ForUnion(
            x, N.Var(parent_name, parent_ty),
            N.Singleton(N.TupleE((("label", N.Field(x, attr)),)))))
        self.out.append(N.Assignment(dom_name, dom_expr, role="plain"))
        self.resolver.mat_types[dom_name] = dom_expr.ty  # type: ignore

        # MatDict <= for l in LabDomain union
        #              for w in match l.label = NewLabel(params) then body
        #                union {<label := l.label, **w>}
        l = N.Var(N.fresh("l"), N.TupleT((("label", label_ty),)))
        matched = N.MatchLabel(N.Field(l, "label"), tag, params, body)
        flat = _flatten_with_label(matched, N.Field(l, "label"))
        expr = N.ForUnion(l, N.Var(dom_name, dom_expr.ty), flat)
        self._register_dict(matname, expr, tag, sub_path, parent_name,
                            attr, man)

    # -- domain elimination rule 1 (+ sumBy extension) -----------------------
    def _emit_rule1(self, matname: str, tag: str, m: _Rule1Match,
                    sub_path: tuple, parent_name: str, attr: str,
                    man: Manifest):
        md_ty = m.lookup_dict.ty
        assert isinstance(md_ty, N.BagT) and isinstance(md_ty.elem, N.TupleT)
        z = N.Var(N.fresh("z"), md_ty.elem)
        # the loop var y ranged over rows *without* the label column; z has
        # it — field access is name-based so substitution is safe.
        inner = N.subst(m.inner, {m.loop_var.name: z})
        new_label = N.NewLabel(tag, ((m.loop_var.name + "__lab",
                                      N.Field(z, "label")),))
        if m.sum_by is None:
            flat = _flatten_with_label(inner, new_label)
            expr = N.ForUnion(z, m.lookup_dict, flat)
        else:
            keys, values = m.sum_by
            flat = _flatten_with_label(inner, new_label)
            loop = N.ForUnion(z, m.lookup_dict, flat)
            expr = N.SumBy(loop, ("label",) + tuple(keys), tuple(values))
        self._register_dict(matname, expr, tag, sub_path, parent_name,
                            attr, man, rule="rule1" if m.sum_by is None
                            else "rule1+sumBy")

    # -- domain elimination rule 2 -------------------------------------------
    def _emit_rule2(self, matname: str, tag: str, m: _Rule2Match,
                    sub_path: tuple, parent_name: str, attr: str,
                    man: Manifest):
        y = m.loop_var
        new_label = N.NewLabel(tag, ((y.name + "__key",
                                      N.Field(y, m.key_attr)),))
        if m.sum_by is None:
            flat = _flatten_with_label(m.inner, new_label)
            expr = N.ForUnion(y, m.source, flat)
        else:
            keys, values = m.sum_by
            flat = _flatten_with_label(m.inner, new_label)
            loop = N.ForUnion(y, m.source, flat)
            expr = N.SumBy(loop, ("label",) + tuple(keys), tuple(values))
        self._register_dict(matname, expr, tag, sub_path, parent_name,
                            attr, man, rule="rule2" if m.sum_by is None
                            else "rule2+sumBy")

    def _emit_rule2_multi(self, matname: str, tag: str,
                          m: _Rule2MultiMatch, sub_path: tuple,
                          parent_name: str, attr: str, man: Manifest):
        label = N.NewLabel(tag, m.captures)
        flat = _attach_label(m.body, label)
        if m.sum_by is None:
            expr = flat
        else:
            keys, values = m.sum_by
            expr = N.SumBy(flat, ("label",) + tuple(keys), tuple(values))
        self._register_dict(matname, expr, tag, sub_path, parent_name,
                            attr, man, rule="rule2-multi")

    def _register_dict(self, matname: str, expr: N.Expr, tag: str,
                       sub_path: tuple, parent_name: str, attr: str,
                       man: Manifest, rule: str = "baseline"):
        a = N.Assignment(matname, expr, role="dict", path=sub_path,
                         parent=parent_name, label_attr=attr)
        self.out.append(a)
        ty = expr.ty
        assert isinstance(ty, N.BagT)
        self.resolver.mat_types[matname] = ty
        self.resolver.register((man.source, sub_path), matname, ty)
        man.dicts[sub_path] = matname
        man.tags[sub_path] = tag


# ---------------------------------------------------------------------------
# Whole-program shredding (pipelines: outputs feed later queries)
# ---------------------------------------------------------------------------

@dataclass
class ShreddedProgram:
    program: N.Program                    # flat assignments, in order
    manifests: Dict[str, Manifest]        # per source assignment
    resolver: Resolver


def binding_from_manifest(man: Manifest, resolver: Resolver) -> ShredBinding:
    """Make a shredding environment binding for a *materialized* upstream
    output, so downstream queries consume its shredded parts directly."""
    top_ty = resolver.mat_types[man.top]

    def tree_for(path: tuple, ty: N.BagT) -> DictTree:
        t = DictTree({})
        elem = ty.elem
        if not isinstance(elem, N.TupleT):
            return t
        for attr, fty in elem.fields:
            if isinstance(fty, N.BagT):
                p = path + (attr,)
                name = man.dicts[p]
                dty = resolver.mat_types[name]
                tag = man.tags[p]
                elem_wo_label = N.TupleT(tuple(
                    (n, ft) for n, ft in dty.elem.fields if n != "label"))
                ref = N.InputDictRef(man.source, p,
                                     N.DictT(N.LabelT(tag),
                                             N.BagT(elem_wo_label)))
                t.attrs[attr] = DictEntry(fun=ref,
                                          child=tree_for(p, fty))
        return t

    # reconstruct the *source* nested type's tree shape
    return ShredBinding(flat=N.Var(man.top, top_ty),
                        tree=tree_for((), man.ty))


def shred_program(program: N.Program, input_types: Dict[str, N.BagT],
                  domain_elimination: bool = True) -> ShreddedProgram:
    """Shred + materialize a whole NRC program (paper §4 end-to-end).

    Inputs are assumed value-shredded: for input R with nested type T the
    runtime environment must provide ``R__F`` and one ``R__D_<path>`` bag
    per nesting path (with a ``label`` column) — exactly the output of
    ``interpreter.shred_value`` / ``columnar value shredding``.
    """
    resolver = Resolver()
    env: ShredEnv = input_env(input_types)
    # register input dictionaries with the resolver
    for name, ty in input_types.items():
        def reg(t: N.BagT, path: tuple):
            elem = t.elem
            if not isinstance(elem, N.TupleT):
                return
            for attr, fty in elem.fields:
                if isinstance(fty, N.BagT):
                    p = path + (attr,)
                    tag = f"{name}.{'.'.join(p)}"
                    flat_val = N.flat_type(fty, path=tag)
                    assert isinstance(flat_val, N.BagT)
                    mat_ty = _with_label_type(flat_val, tag)
                    resolver.register((name, p), mat_input_name(name, p),
                                      mat_ty)
                    reg(fty, p)
        reg(ty, ())
        resolver.mat_types[f"{name}__F"] = input_flat_type(name, ty)

    mat = Materializer(resolver, domain_elimination)
    manifests: Dict[str, Manifest] = {}
    for a in program.assignments:
        shredder = Shredder(site_prefix=a.name)
        fexpr, dtree = shredder.shred(a.expr, env)
        assert isinstance(a.expr.ty, N.BagT), "assignments must be bag-typed"
        man = mat.materialize(a.name, fexpr, dtree, a.expr.ty)
        manifests[a.name] = man
        # later queries may reference this output
        env[a.name] = binding_from_manifest(man, resolver)
    return ShreddedProgram(N.Program(mat.out), manifests, resolver)


# ---------------------------------------------------------------------------
# Unshredding (interpreter-level; the columnar backend has its own)
# ---------------------------------------------------------------------------

def unshred_from_env(env: Dict[str, object], man: Manifest) -> list:
    """Reassemble the nested value of a shredded output from an evaluated
    environment (dicts keyed by manifest names)."""
    from . import interpreter as I
    shredded = {(): env[man.top]}
    for path, name in man.dicts.items():
        shredded[path] = env[name]
    return I.unshred_value(shredded, man.ty)


def shredded_input_env(inputs: Dict[str, list],
                       input_types: Dict[str, N.BagT]) -> Dict[str, object]:
    """Value-shred nested inputs into the runtime environment expected by
    a shredded program (R__F / R__D_<path> bags)."""
    from . import interpreter as I
    env: Dict[str, object] = {}
    for name, rows in inputs.items():
        parts = I.shred_value(rows, input_types[name], root=name)
        for path, bag_rows in parts.items():
            env[mat_input_name(name, path)] = bag_rows
    return env
