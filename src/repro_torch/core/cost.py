"""Cost-based whole-program planning (ROADMAP item 4 — "the global
cost model itself").

The pieces this module composes existed before it: Misra-Gries
heavy-key sketches and zone-map distinct counts persisted per stored
part (``skew.TableStats``), and measured row counts fed back by the
telemetry layer (``obs.StatsFeedback`` -> ``TableStats.effective_rows``
and, per operator, ``StatsFeedback.node_rows``). What was missing is
the estimate-then-cost discipline: a cardinality estimate for every
plan node, and a wire/replication/probe cost over those estimates that
the compiler can use to pick between physically different but
logically equal plans.

**Cardinality estimator** (:class:`CardinalityEstimator`). Bottom-up
over the plan tree; every node gets an :class:`Estimate` carrying

* ``rows`` — the expected valid output rows,
* ``distinct[col]`` — per-column distinct-count estimates (seeded from
  zone maps, capped by ``rows`` as they propagate),
* ``heavy[col]`` — surviving heavy-key frequencies (seeded from the
  sketch, scaled by survival ratios as they propagate).

Join selectivity is the classic ``|L| x |R| / max(d_L, d_R)``
containment bound computed over the LIGHT portions of both sides, plus
an exact heavy-key correction: keys the sketches know about contribute
``f_L(k) x f_R(k)`` (heavy-heavy) or ``f(k) x`` the opposite side's
mean light multiplicity — Zipf-skewed joins are exactly where the
uniform formula collapses, and exactly where we have per-key counts.
A ``unique_right`` (fk) build side with no distinct stats defaults to
``d_R = rows_R`` (keys are unique by catalog contract), so fk chains
are estimable from row counts alone. Selections use ``1/d`` for
equality on a known column, 1/3 for inequalities; aggregations
``min(rows, prod distinct(keys))``.

When an **observed** per-operator row count exists (recorded by a
previous ``EXPLAIN ANALYZE`` / execution through
``StatsFeedback.record_explain``, keyed by the operator's structural
signature digest — see :func:`sig_digest`), it overrides the formula:
one feedback round pins every surviving operator's estimate to ground
truth, which is what drives the max-Q-error gate in
``benchmarks/cost.py``.

**Cost model** (:func:`cost_plan`). Rows shipped per hash exchange +
replicated bytes (broadcast/heavy builds, priced per partition) + a
discounted local probe term. Deliberately coarse — it only has to
RANK plans whose wire volumes differ by integer factors.

**The three decisions** (compiled in by ``codegen.compile_program``
with ``cost_mode="auto"``):

(a) :func:`order_join_chains` — permutes inner unique-build equi-join
    chains so the most selective builds apply first, minimizing the
    summed intermediate cardinalities that each later exchange
    re-ships. Only fk (``unique_right``) inner stages reorder: their
    output stays probe-row-aligned, so any stage permutation is
    bit-for-bit identical (the differential lane asserts this).
(b) estimated-intermediate cascade costing for the HyperCube gate —
    ``plans._hypercube_rewrite_chain`` calls
    :meth:`CardinalityEstimator.chain_intermediates` and compares
    ``skew.hypercube_send_rows`` against
    ``skew.cascade_send_rows_est`` instead of the stats-free
    "intermediate ~ spine" assumption.
(c) :func:`choose_unfuse` — fuse-vs-unfuse for ``FusedJoinAggP``
    under skew as a costed choice: keep the fused join+aggregate (one
    pipeline, one sort) and eat the priced imbalance, or un-fuse into
    Gamma+ over a SkewJoinP (balanced light exchange + heavy build
    replication + an extra aggregation pass). PR 5's always-unfuse
    rule remains the ``cost_mode="off"`` behavior.

Everything here is compile-time host arithmetic: estimates never enter
a traced computation, so warm plan-cache rebinds stay zero-retrace.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from itertools import permutations
from typing import Dict, List, Optional, Sequence, Tuple

from . import nrc as N
from . import plans as P
from . import skew as SK

DEFAULT_SELECTIVITY = 1.0 / 3.0
"""Selectivity of a predicate the estimator cannot decompose."""

UNFUSE_PENALTY = 0.25
"""Extra local work of un-fusing a FusedJoinAggP, as a fraction of the
join output rows: the fused pipeline aggregates in the same pass (and
sort) as the probe; Gamma+ over a separate join pays one more pass."""

LOCAL_WEIGHT = 0.1
"""Weight of local probe rows vs. wire rows in ``PlanCost.total`` —
an exchange row costs hashing + packing + a collective, a local row a
gather."""

_REORDER_MAX_EXHAUSTIVE = 6
"""Chains up to this many stages enumerate all valid permutations;
longer chains fall back to a greedy cheapest-next-intermediate order."""


# ---------------------------------------------------------------------------
# estimates
# ---------------------------------------------------------------------------

@dataclass
class Estimate:
    """Cardinality estimate for one plan node's output."""
    rows: float
    distinct: Dict[str, float] = dc_field(default_factory=dict)
    heavy: Dict[str, Dict[int, float]] = dc_field(default_factory=dict)
    known: bool = True      # False once any input lacked statistics

    def scaled(self, ratio: float, rows: Optional[float] = None
               ) -> "Estimate":
        """Survival-scaled copy: ``ratio`` of the rows remain (distinct
        caps to the new row count, heavy frequencies scale, keys whose
        scaled frequency drops below one disappear)."""
        r = self.rows * ratio if rows is None else rows
        r = max(r, 0.0)
        return Estimate(
            rows=r,
            distinct={c: min(d, max(r, 1.0))
                      for c, d in self.distinct.items()},
            heavy={c: {k: f * ratio for k, f in ks.items()
                       if f * ratio >= 1.0}
                   for c, ks in self.heavy.items()},
            known=self.known)


def sig_digest(p: P.Plan) -> str:
    """Deterministic structural digest of a plan node — the key under
    which observed per-operator row counts persist across processes
    (``StatsFeedback.node_rows``). Derived from ``plan_signature``, so
    two structurally identical operators (up to canonical column
    renaming) share one observation."""
    sig, _ = P.plan_signature(p)
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:16]


def _pack_distinct(est: Estimate, cols: Sequence[str]
                   ) -> Optional[float]:
    """Distinct estimate of a (possibly multi-)column key: the product
    of per-column counts capped by the row count, None when any column
    is unknown."""
    prod = 1.0
    for c in cols:
        d = est.distinct.get(c)
        if d is None:
            return None
        prod *= max(d, 1.0)
    return min(prod, max(est.rows, 1.0))


class CardinalityEstimator:
    """Bottom-up cardinality estimation over plan trees (module
    docstring). One instance lives for one ``compile_program`` call;
    ``bind_graph`` points it at the program DAG so scans and refs of
    earlier assignments (and CSE-shared nodes) resolve to the
    estimates of their defining plans."""

    def __init__(self, stats: Optional[dict] = None,
                 n_partitions: int = 8,
                 observed: Optional[Dict[str, int]] = None):
        self.stats = stats or {}
        self.n_partitions = max(int(n_partitions), 1)
        self.observed = dict(observed or {})
        self.programs: Dict[str, P.Plan] = {}
        self._memo: Dict[int, Estimate] = {}
        self._node_memo: Dict[str, Estimate] = {}
        self._estimating: set = set()

    def bind_graph(self, graph) -> "CardinalityEstimator":
        """(Re)attach to a program graph; clears memos because passes
        mutate plans in place between calls."""
        self.programs = {nd.name: nd.plan for nd in graph.nodes}
        self._memo.clear()
        self._node_memo.clear()
        return self

    # -- public queries ---------------------------------------------------
    def estimate(self, p: P.Plan) -> Estimate:
        key = id(p)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        est = self._estimate(p)
        if self.observed:
            n = self.observed.get(sig_digest(p))
            if n is not None and est.rows > 0:
                est = est.scaled(float(n) / est.rows, rows=float(n))
                est.known = True
            elif n is not None:
                est = Estimate(rows=float(n), known=True)
        self._memo[key] = est
        return est

    def rows_of(self, p: P.Plan) -> Optional[int]:
        """Estimated rows, or None when the subtree lacks statistics."""
        est = self.estimate(p)
        return int(round(est.rows)) if est.known else None

    def chain_intermediates(self, base: P.Plan,
                            stage_joins: Sequence[P.JoinP]
                            ) -> Optional[List[float]]:
        """Estimated spine cardinality after each join of a left-deep
        chain (innermost first) — the quantities
        ``skew.cascade_send_rows_est`` prices. None when any relation
        lacks statistics (the caller falls back to the stats-free
        cascade formula)."""
        acc = self.estimate(base)
        if not acc.known:
            return None
        out: List[float] = []
        for j in stage_joins:
            re_ = self.estimate(j.right)
            if not re_.known:
                return None
            acc = self._join(acc, re_, tuple(j.left_on),
                             tuple(j.right_on), j.how, j.unique_right)
            out.append(acc.rows)
        return out

    def annotate_graph(self, graph) -> Dict[str, Optional[int]]:
        """Attach ``est_rows`` (and ``est_known``) to EVERY plan node
        of the program, post-passes — the EXPLAIN attributes. Returns
        {node name: root est_rows} for the serving plan-cache entry."""
        self.bind_graph(graph)
        roots: Dict[str, Optional[int]] = {}
        for nd in graph.nodes:
            for sub in P._walk_plan(nd.plan):
                e = self.estimate(sub)
                sub.est_rows = int(round(e.rows))
                sub.est_known = e.known
            root = self.estimate(nd.plan)
            roots[nd.name] = int(round(root.rows)) if root.known \
                else None
            self._node_memo[nd.name] = root
        return roots

    # -- node estimation --------------------------------------------------
    def _node_estimate(self, name: str) -> Estimate:
        """Estimate of a program node's output (by assignment / CSE
        node name), for scans and refs of computed bags."""
        hit = self._node_memo.get(name)
        if hit is not None:
            return hit
        plan = self.programs.get(name)
        if plan is None or name in self._estimating:
            return Estimate(rows=1.0, known=False)
        self._estimating.add(name)
        try:
            est = self.estimate(plan)
        finally:
            self._estimating.discard(name)
        self._node_memo[name] = est
        return est

    def _scan_estimate(self, bag: str, alias: str,
                       with_rowid: bool) -> Estimate:
        ts = self.stats.get(bag)
        if ts is not None and hasattr(ts, "rows"):
            rows = float(max(int(getattr(ts, "effective_rows", ts.rows)),
                             0))
            # observed rows rescale the sketched per-key counts too
            ratio = rows / max(float(ts.rows), 1.0)
            est = Estimate(
                rows=rows,
                distinct={f"{alias}.{c}": min(float(d), max(rows, 1.0))
                          for c, d in getattr(ts, "distinct",
                                              {}).items()},
                heavy={f"{alias}.{c}": {int(k): float(f) * ratio
                                        for k, f in ks
                                        if float(f) * ratio >= 1.0}
                       for c, ks in getattr(ts, "heavy", {}).items()})
        elif bag in self.programs:
            inner = self._node_estimate(bag)
            est = Estimate(
                rows=inner.rows,
                distinct={f"{alias}.{c}": d
                          for c, d in inner.distinct.items()},
                heavy={f"{alias}.{c}": dict(ks)
                       for c, ks in inner.heavy.items()},
                known=inner.known)
        else:
            est = Estimate(rows=1.0, known=False)
        if with_rowid:
            est.distinct[f"{alias}.__rowid"] = max(est.rows, 1.0)
        return est

    def _estimate(self, p: P.Plan) -> Estimate:
        if isinstance(p, P.ScanP):
            return self._scan_estimate(p.bag, p.alias, p.with_rowid)
        if isinstance(p, P._PrunedScan):
            return self._scan_estimate(p.inner.bag, p.inner.alias,
                                       p.inner.with_rowid)
        if isinstance(p, P.RefP):
            inner = self._node_estimate(p.name)
            ren = lambda c: P._fold_rename(c, p.rename, p.alias_map)
            return Estimate(
                rows=inner.rows,
                distinct={ren(c): d for c, d in inner.distinct.items()},
                heavy={ren(c): dict(ks)
                       for c, ks in inner.heavy.items()},
                known=inner.known)
        if isinstance(p, P.SelectP):
            child = self.estimate(p.child)
            sel = self._selectivity(p.pred, child)
            return child.scaled(min(max(sel, 0.0), 1.0))
        if isinstance(p, P.MapP):
            child = self.estimate(p.child)
            out = Estimate(rows=child.rows, known=child.known)
            if p.extend:
                out.distinct = dict(child.distinct)
                out.heavy = {c: dict(ks)
                             for c, ks in child.heavy.items()}
            for col, e in p.outputs:
                if isinstance(e, N.Var):     # passthrough keeps stats
                    d = child.distinct.get(e.name)
                    if d is not None:
                        out.distinct[col] = d
                    hk = child.heavy.get(e.name)
                    if hk:
                        out.heavy[col] = dict(hk)
                elif col != "__one":
                    out.distinct[col] = max(child.rows, 1.0)
            return out
        if isinstance(p, P.JoinP):
            return self._join(self.estimate(p.left),
                              self.estimate(p.right),
                              tuple(p.left_on), tuple(p.right_on),
                              p.how, p.unique_right)
        if isinstance(p, P.SkewJoinP):
            return self.estimate(p.join)
        if isinstance(p, (P.SumAggP, P.FusedJoinAggP)):
            child = self.estimate(
                p.child if isinstance(p, P.SumAggP) else p.join)
            groups = _pack_distinct(child, p.keys)
            rows = child.rows if groups is None else min(child.rows,
                                                         groups)
            out = Estimate(rows=max(rows, 0.0), known=child.known)
            for k in p.keys:
                d = child.distinct.get(k)
                out.distinct[k] = min(d, max(rows, 1.0)) \
                    if d is not None else max(rows, 1.0)
            for v in p.vals:
                out.distinct[v] = max(rows, 1.0)
            return out
        if isinstance(p, P.DeDupP):
            child = self.estimate(p.child)
            if p.cols:
                groups = _pack_distinct(child, p.cols)
                rows = child.rows if groups is None else min(child.rows,
                                                             groups)
            else:
                rows = child.rows
            return child.scaled(rows / max(child.rows, 1.0), rows=rows)
        if isinstance(p, P.UnionP):
            l, r = self.estimate(p.left), self.estimate(p.right)
            rows = l.rows + r.rows
            distinct = dict(l.distinct)
            for c, d in r.distinct.items():
                distinct[c] = min(distinct.get(c, 0.0) + d,
                                  max(rows, 1.0))
            heavy: Dict[str, Dict[int, float]] = {
                c: dict(ks) for c, ks in l.heavy.items()}
            for c, ks in r.heavy.items():
                tgt = heavy.setdefault(c, {})
                for k, f in ks.items():
                    tgt[k] = tgt.get(k, 0.0) + f
            return Estimate(rows=rows, distinct=distinct, heavy=heavy,
                            known=l.known and r.known)
        if isinstance(p, P.OuterUnnestP):
            parent = self.estimate(p.parent)
            child = self._scan_estimate(p.child_bag, p.alias, False)
            if not child.known:
                return Estimate(rows=parent.rows, known=False)
            # every child row pairs with exactly one parent row;
            # childless parents survive (outer) — the union dominates
            rows = max(parent.rows, child.rows)
            distinct = {c: min(d, max(rows, 1.0))
                        for c, d in {**parent.distinct,
                                     **child.distinct}.items()}
            return Estimate(rows=rows, distinct=distinct,
                            heavy={c: dict(ks)
                                   for c, ks in child.heavy.items()},
                            known=parent.known)
        if isinstance(p, P.MultiJoinP):
            acc = self.estimate(p.child)
            for st in p.stages:
                acc = self._join(acc, self.estimate(st.plan),
                                 tuple(st.left_on), tuple(st.right_on),
                                 "inner", st.unique_right)
            return acc
        return Estimate(rows=1.0, known=False)

    # -- the join formula -------------------------------------------------
    def _join(self, le: Estimate, re_: Estimate, left_on: tuple,
              right_on: tuple, how: str, unique_right: bool
              ) -> Estimate:
        rows_l, rows_r = max(le.rows, 0.0), max(re_.rows, 0.0)
        known = le.known and re_.known
        if len(left_on) == 1:
            lc, rc = left_on[0], right_on[0]
            d_l = le.distinct.get(lc)
            d_r = re_.distinct.get(rc)
            hl = dict(le.heavy.get(lc, {}))
            hr = dict(re_.heavy.get(rc, {}))
        else:
            d_l = _pack_distinct(le, left_on)
            d_r = _pack_distinct(re_, right_on)
            hl, hr = {}, {}
        if d_r is None and unique_right:
            d_r = max(rows_r, 1.0)   # fk contract: build keys unique
        if d_l is None or d_r is None:
            # stats-free fallback: a unique build passes the probe
            # side through; a general join guesses no expansion
            out_rows = rows_l
            known = False
        else:
            light_l = max(rows_l - sum(hl.values()), 0.0)
            light_r = max(rows_r - sum(hr.values()), 0.0)
            dl_light = max(d_l - len(hl), 1.0)
            dr_light = max(d_r - len(hr), 1.0)
            dmax = max(dl_light, dr_light)
            out_rows = light_l * light_r / dmax
            for k, f in hl.items():
                out_rows += f * hr[k] if k in hr else f * light_r / dmax
            for k, f in hr.items():
                if k not in hl:
                    out_rows += f * light_l / dmax
        if unique_right:
            out_rows = min(out_rows, rows_l)
        if how == "left_outer":
            out_rows = max(out_rows, rows_l)
        # column stats survive with each side's survival ratio
        out = Estimate(rows=out_rows, known=known)
        sl = le.scaled(min(out_rows / max(rows_l, 1.0), 1.0),
                       rows=out_rows)
        sr = re_.scaled(min(out_rows / max(rows_r, 1.0), 1.0),
                        rows=out_rows)
        out.distinct = {**sr.distinct, **sl.distinct}
        out.heavy = {**sr.heavy, **sl.heavy}
        if len(left_on) == 1 and out.distinct.get(left_on[0]) is not None:
            dj = out.distinct[left_on[0]]
            drj = out.distinct.get(right_on[0])
            if drj is not None:
                dj = min(dj, drj)
            out.distinct[left_on[0]] = dj
            out.distinct[right_on[0]] = dj
        return out

    # -- predicate selectivity --------------------------------------------
    def _selectivity(self, pred: N.Expr, child: Estimate) -> float:
        if isinstance(pred, N.Const):
            return 1.0 if pred.value else 0.0
        if isinstance(pred, N.BoolOp):
            sl = self._selectivity(pred.left, child)
            sr = self._selectivity(pred.right, child)
            return sl * sr if pred.op == "&&" else sl + sr - sl * sr
        if isinstance(pred, N.Not):
            return 1.0 - self._selectivity(pred.inner, child)
        if isinstance(pred, N.Cmp):
            col = None
            for side in (pred.left, pred.right):
                if isinstance(side, N.Var):
                    col = side.name
                    break
            if pred.op == "==":
                d = child.distinct.get(col) if col else None
                return 1.0 / max(d, 1.0) if d is not None else 0.1
            if pred.op == "!=":
                d = child.distinct.get(col) if col else None
                return 1.0 - 1.0 / max(d, 1.0) if d is not None else 0.9
            return DEFAULT_SELECTIVITY
        return DEFAULT_SELECTIVITY


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@dataclass
class PlanCost:
    """Wire/replication/probe cost of one plan, in row units (bytes
    scale all terms by the same ~8 x width factor, so ranking in rows
    ranks in bytes)."""
    shipped_rows: float = 0.0       # hash-exchange crossings
    replicated_rows: float = 0.0    # broadcast/heavy-build copies (xP)
    local_rows: float = 0.0         # probe/sort work proxy

    def total(self) -> float:
        return self.shipped_rows + self.replicated_rows \
            + LOCAL_WEIGHT * self.local_rows


def cost_plan(p: P.Plan, est: CardinalityEstimator,
              n_partitions: Optional[int] = None) -> PlanCost:
    """Estimated distributed cost of a plan subtree. Deliberately
    coarse (exchange elision via delivered partitioning is not
    modeled); its job is ranking physically different plans for one
    logical query, where wire volumes differ by integer factors."""
    pn = n_partitions if n_partitions is not None else est.n_partitions
    cost = PlanCost()

    def rows(sub: P.Plan) -> float:
        return max(est.estimate(sub).rows, 0.0)

    def heavy_mass(sub: P.Plan, col: str) -> Tuple[float, int]:
        ks = est.estimate(sub).heavy.get(col, {})
        return sum(ks.values()), len(ks)

    def walk(sub: P.Plan) -> None:
        if isinstance(sub, P.JoinP):
            if sub.broadcast:
                cost.replicated_rows += rows(sub.right) * pn
                cost.shipped_rows += 0.0
            else:
                cost.shipped_rows += rows(sub.left) + rows(sub.right)
            cost.local_rows += rows(sub.left) + rows(sub.right)
            walk(sub.left)
            walk(sub.right)
            return
        if isinstance(sub, P.SkewJoinP):
            j = sub.join
            mass, nh = heavy_mass(j.left, j.left_on[0]) \
                if len(j.left_on) == 1 else (0.0, 0)
            light = max(rows(j.left) - mass, 0.0)
            cost.shipped_rows += light + rows(j.right)
            # heavy build rows replicate along the heavy dimension
            build = float(nh) if j.unique_right else \
                max(rows(j.right) - light, float(nh))
            cost.replicated_rows += build * pn
            cost.local_rows += rows(j.left) + rows(j.right)
            walk(j.left)
            walk(j.right)
            return
        if isinstance(sub, P.MultiJoinP):
            rels = [sub.child] + [st.plan for st in sub.stages]
            rel_rows = [int(rows(r)) for r in rels]
            dims = [tuple(sorted({d for d, _, _ in route}))
                    for route in sub.rel_routes]
            cost.shipped_rows += SK.hypercube_send_rows(
                dims, rel_rows, sub.shares)
            cost.local_rows += sum(rel_rows)
            for r in rels:
                walk(r)
            return
        if isinstance(sub, (P.SumAggP, P.DeDupP)):
            child = sub.child
            r_in = rows(child)
            out_r = rows(sub)
            preagg = getattr(sub, "local_preagg", False)
            cost.shipped_rows += min(r_in, out_r * pn) if preagg \
                else r_in
            cost.local_rows += r_in
            walk(child)
            return
        if isinstance(sub, P.FusedJoinAggP):
            r_in = rows(sub.join)
            cost.shipped_rows += min(r_in, rows(sub) * pn) \
                if sub.local_preagg else r_in
            cost.local_rows += r_in
            walk(sub.join)
            return
        for c in P._plan_children(sub):
            walk(c)

    walk(p)
    return cost


# ---------------------------------------------------------------------------
# decision (a): costed join ordering over inner fk equi-join chains
# ---------------------------------------------------------------------------

def _chain_owners(base: P.Plan, stages: Sequence[P.JoinP]
                  ) -> Optional[List[int]]:
    """Relation index (0 = base, i+1 = stage i's build) owning each
    stage's probe-key columns, or None when any key is not traceable
    to exactly one relation (derived columns, alias reuse, CSE refs)."""
    amap: Dict[str, int] = {}
    for ri, rp in enumerate([base] + [j.right for j in stages]):
        al = P._scan_aliases(rp)
        if not al:
            return None
        for alias in al:
            if alias in amap:
                return None
            amap[alias] = ri
    owners = []
    for i, j in enumerate(stages):
        os_ = set()
        for c in j.left_on:
            head, sep, _ = c.partition(".")
            if not sep or head not in amap:
                return None
            os_.add(amap[head])
        if len(os_) != 1:
            return None
        o = os_.pop()
        if o > i:
            return None
        owners.append(o)
    return owners


def _perm_objective(est: CardinalityEstimator, base_est: Estimate,
                    stages: Sequence[P.JoinP], perm: Sequence[int]
                    ) -> Optional[float]:
    """Sum of re-shipped intermediate cardinalities under one stage
    permutation (the final intermediate is the output — identical for
    every order — and never re-crosses)."""
    acc = base_est
    inters: List[float] = []
    for idx in perm:
        j = stages[idx]
        re_ = est.estimate(j.right)
        if not re_.known:
            return None
        acc = est._join(acc, re_, tuple(j.left_on), tuple(j.right_on),
                        j.how, j.unique_right)
        inters.append(acc.rows)
    return sum(inters[:-1])


def _valid_perms(owners: Sequence[int], k: int):
    """Stage permutations respecting probe-key dependencies: a stage
    whose key lives on stage ``o-1``'s build side must follow it.
    Lexicographic order, so the identity comes first and wins ties."""
    for perm in permutations(range(k)):
        pos = {s: t for t, s in enumerate(perm)}
        if all(owners[s] == 0 or pos[owners[s] - 1] < pos[s]
               for s in perm):
            yield perm


def _greedy_perm(est: CardinalityEstimator, base_est: Estimate,
                 stages: Sequence[P.JoinP], owners: Sequence[int]
                 ) -> Tuple[int, ...]:
    """Cheapest-next-intermediate greedy order for long chains."""
    remaining = list(range(len(stages)))
    placed: List[int] = []
    acc = base_est
    while remaining:
        best = None
        for s in remaining:
            if owners[s] != 0 and (owners[s] - 1) not in placed:
                continue
            j = stages[s]
            cand = est._join(acc, est.estimate(j.right),
                             tuple(j.left_on), tuple(j.right_on),
                             j.how, j.unique_right)
            if best is None or cand.rows < best[1]:
                best = (s, cand.rows, cand)
        s, _, acc = best
        placed.append(s)
        remaining.remove(s)
    return tuple(placed)


def order_join_chains(graph, est: CardinalityEstimator,
                      min_joins: int = 2) -> int:
    """Decision (a): reorder inner unique-build equi-join chains by
    estimated intermediate cardinality, program-wide (in place, BEFORE
    the skew and hypercube passes so both see the costed order).
    Returns the number of chains whose order changed.

    Only chains of fk (``unique_right``) inner stages reorder — their
    output is probe-row-aligned, so every valid permutation yields the
    same bag bit-for-bit; non-unique builds expand rows and are left
    in program order."""
    est.bind_graph(graph)
    changed = 0

    def try_reorder(root: P.JoinP) -> P.Plan:
        nonlocal changed
        peeled = P._peel_join_chain(root, min_joins)
        if peeled is None:
            return descend_join(root)
        base, staged = peeled
        stages = [j for (j, hp, _) in staged]
        if any(hp is not None for (_, hp, _) in staged) \
                or any(not j.unique_right for j in stages):
            return descend_join(root)
        owners = _chain_owners(base, stages)
        base_est = est.estimate(base)
        if owners is None or not base_est.known:
            return descend_join(root)
        k = len(stages)
        if k <= _REORDER_MAX_EXHAUSTIVE:
            best = None
            for perm in _valid_perms(owners, k):
                obj = _perm_objective(est, base_est, stages, perm)
                if obj is None:
                    return descend_join(root)
                if best is None or obj < best[0]:
                    best = (obj, perm)
            perm = best[1]
        else:
            perm = _greedy_perm(est, base_est, stages, owners)
        if perm != tuple(range(k)):
            changed += 1
        acc: P.Plan = rewrite(base)
        for s in perm:
            j = stages[s]
            j.right = rewrite(j.right)
            j.left = acc
            acc = j
        return acc

    def descend_join(j: P.JoinP) -> P.Plan:
        j.left = rewrite(j.left)
        j.right = rewrite(j.right)
        return j

    def rewrite(p: P.Plan) -> P.Plan:
        if isinstance(p, P.JoinP):
            return try_reorder(p)
        if isinstance(p, P.FusedJoinAggP):
            new_join = try_reorder(p.join)
            assert isinstance(new_join, P.JoinP)
            p.join = new_join
            return p
        if isinstance(p, P.MultiJoinP):
            p.child = rewrite(p.child)
            for st in p.stages:
                st.plan = rewrite(st.plan)
            return p
        for attr in P._CHILD_ATTRS:
            if hasattr(p, attr):
                setattr(p, attr, rewrite(getattr(p, attr)))
        return p

    for nd in graph.nodes:
        nd.plan = rewrite(nd.plan)
    if changed:
        est.bind_graph(graph)      # invalidate memos over rewired plans
    return changed


# ---------------------------------------------------------------------------
# decision (c): fuse-vs-unfuse under skew as a costed choice
# ---------------------------------------------------------------------------

def choose_unfuse(probe_rows: float, heavy_freqs: Sequence[float],
                  n_partitions: int,
                  penalty: float = UNFUSE_PENALTY) -> bool:
    """Should a ``FusedJoinAggP`` whose probe key is skewed un-fuse
    into Gamma+ over a SkewJoinP?

    * **Fused** keeps the one-pipeline join+aggregate but hash-
      exchanges every probe row on the skewed key: the partition
      holding the heaviest key receives at least ``f_max`` rows, so
      the makespan-normalized cost is ``max(rows/P, f_max) x P``.
    * **Unfused** ships only the light rows (balanced), replicates the
      heavy build rows (one per heavy key for a unique build, priced
      x P), and pays ``penalty x rows`` extra local work for the lost
      fusion (a separate aggregation pass over the join output).

    With mild skew (``f_max`` barely above fair share) fusion wins —
    the nuance PR 5's always-unfuse rule couldn't express; at Zipf-2
    frequencies the imbalance term dominates and un-fusing wins, as
    before."""
    pn = max(int(n_partitions), 1)
    freqs = [float(f) for f in heavy_freqs]
    if not freqs or pn <= 1:
        return False
    f_max = max(freqs)
    fused = max(probe_rows / pn, f_max) * pn
    light = max(probe_rows - sum(freqs), 0.0)
    unfused = light + len(freqs) * pn + penalty * probe_rows
    return unfused < fused
