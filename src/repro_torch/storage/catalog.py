"""StorageCatalog — datasets as named input roots for the query engine
(PyTorch twin of ``repro.storage.catalog``).

Three layers glue storage to the compiler:

* ``storage_requirements(cp)`` — walks a compiled ``ProgramGraph`` and
  derives, per input part, (a) the union of columns any scan site keeps
  (the existing projection-pushdown pass already narrowed these) and
  (b) a *skip predicate*: rows provably failing it at EVERY use site
  can be dropped, so chunks whose zone maps refute it are never read.
  Predicates are collected top-down through Selects, inner-join sides,
  extend-projections and unions — never through aggregations (a sum is
  not row-local) or the build side of an outer join (unmatched probe
  rows carry unspecified build values). A part scanned anywhere without
  an applicable predicate keeps every chunk.
* ``StorageEnv`` — a lazy execution environment for the eager path:
  ``ScanP`` / pruned scans call ``ensure_loaded`` (core.plans) and the
  part materializes from disk with exactly the requested columns.
* ``StorageCatalog`` — the directory of named datasets (writer/open).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core import nrc as N
from repro_torch.core.plans import (FusedJoinAggP, JoinP, MapP,
                                    MultiJoinP, OuterUnnestP, Plan, ScanP,
                                    SelectP, SkewJoinP, UnionP, _PrunedScan,
                                    col_expr_deps, scan_keep_attrs)

from .reader import StoredDataset
from .writer import DatasetWriter


# ---------------------------------------------------------------------------
# requirements extraction
# ---------------------------------------------------------------------------

@dataclass
class PartRequirement:
    """What a compiled program needs from one stored part."""
    columns: Optional[set]      # attribute names; None = all columns
    pred: Optional[N.Expr]      # skip predicate (attr namespace); None =
    #                             no chunk may be skipped


@dataclass
class _ScanSite:
    bag: str
    alias: str
    keep: Optional[set]         # alias-prefixed columns; None = all
    preds: List[N.Expr]


def _rename_pred(pred: N.Expr, mapping: Dict[str, str]) -> N.Expr:
    def f(x: N.Expr) -> N.Expr:
        if isinstance(x, N.Var) and x.name in mapping:
            return N.Var(mapping[x.name], x.ty)
        return x
    return N.map_expr(pred, f)


def _collect_sites(p: Plan, preds: List[N.Expr], out: List[_ScanSite]
                   ) -> None:
    if isinstance(p, SelectP):
        _collect_sites(p.child, preds + [p.pred], out)
        return
    if isinstance(p, ScanP):
        out.append(_ScanSite(p.bag, p.alias, None, preds))
        return
    if isinstance(p, _PrunedScan):
        out.append(_ScanSite(p.inner.bag, p.inner.alias, set(p.keep),
                             preds))
        return
    if isinstance(p, SkewJoinP):
        # row-set-wise identical to its embedded join (skew only moves
        # rows between partitions), so predicates flow the same way
        _collect_sites(p.join, preds, out)
        return
    if isinstance(p, MultiJoinP):
        # every relation of a hypercube multiway join is inner-joined,
        # so predicates from above flow to all of them
        _collect_sites(p.child, preds, out)
        for st in p.stages:
            _collect_sites(st.plan, preds, out)
        return
    if isinstance(p, JoinP):
        _collect_sites(p.left, preds, out)
        # build-side rows of an OUTER join survive as unmatched-garbage
        # on the probe side, so predicates from above must not disqualify
        # its chunks
        _collect_sites(p.right, preds if p.how == "inner" else [], out)
        return
    if isinstance(p, FusedJoinAggP):
        # predicates above the fused aggregate reference aggregated
        # values — none are row-local below it
        _collect_sites(p.join, [], out)
        return
    if isinstance(p, MapP):
        if p.extend:
            over = {c for c, _ in p.outputs}
            down = [q for q in preds if not (col_expr_deps(q) & over)]
            _collect_sites(p.child, down, out)
            return
        # full projection: translate predicates through bare-Var
        # passthrough outputs; non-translatable predicates stop here
        passthru = {out_c: e.name for out_c, e in p.outputs
                    if isinstance(e, N.Var)}
        down = []
        for q in preds:
            deps = col_expr_deps(q)
            if deps <= set(passthru):
                down.append(_rename_pred(q, passthru))
        _collect_sites(p.child, down, out)
        return
    if isinstance(p, UnionP):
        _collect_sites(p.left, preds, out)
        _collect_sites(p.right, preds, out)
        return
    if isinstance(p, OuterUnnestP):
        _collect_sites(p.parent, preds, out)
        # the child dictionary is scanned wholesale by the evaluator
        out.append(_ScanSite(p.child_bag, p.alias, None, []))
        return
    # grouping ops (SumAggP / DeDupP) and RefP: predicates from above
    # are not row-local below (or belong to another node's namespace)
    for attr in ("child", "left", "right", "parent"):
        if hasattr(p, attr):
            _collect_sites(getattr(p, attr), [], out)


def _and_all(preds: List[N.Expr]) -> N.Expr:
    e = preds[0]
    for q in preds[1:]:
        e = N.BoolOp("&&", e, q)
    return e


def _or_all(preds: List[N.Expr]) -> N.Expr:
    e = preds[0]
    for q in preds[1:]:
        e = N.BoolOp("||", e, q)
    return e


def storage_requirements(cp, part_names: Optional[set] = None
                         ) -> Dict[str, PartRequirement]:
    """Per stored part: columns to load and the skip predicate, derived
    from a ``codegen.CompiledProgram`` (post plan passes, so the pruned
    scans already carry minimal keep sets). ``part_names`` restricts the
    result to storage-backed bags (default: every scanned bag that is
    not itself a program node)."""
    produced = {name for name, _ in cp.plans}
    sites: List[_ScanSite] = []
    for _, plan in cp.plans:
        _collect_sites(plan, [], sites)

    by_bag: Dict[str, List[_ScanSite]] = {}
    for s in sites:
        if s.bag in produced:
            continue            # intermediate program node, not storage
        if part_names is not None and s.bag not in part_names:
            continue
        by_bag.setdefault(s.bag, []).append(s)

    out: Dict[str, PartRequirement] = {}
    for bag, ss in by_bag.items():
        cols: Optional[set] = set()
        for s in ss:
            if s.keep is None:
                cols = None
                break
            cols |= scan_keep_attrs(s.keep, s.alias)
        site_preds: List[N.Expr] = []
        skippable = True
        for s in ss:
            pre = s.alias + "."
            usable = []
            for q in s.preds:
                deps = col_expr_deps(q)
                if deps and all(d.startswith(pre) for d in deps):
                    usable.append(_rename_pred(
                        q, {d: d[len(pre):] for d in deps}))
            if not usable:
                # this use site reads unfiltered rows: no chunk of the
                # part may be skipped
                skippable = False
                break
            site_preds.append(_and_all(usable))
        pred = _or_all(site_preds) if skippable and site_preds else None
        out[bag] = PartRequirement(columns=cols, pred=pred)
    return out


# ---------------------------------------------------------------------------
# lazy storage-backed environment (eager / run_flat_program path)
# ---------------------------------------------------------------------------

class StorageEnv(dict):
    """Execution environment whose missing input bags load from a
    ``StoredDataset`` on first scan (``core.plans`` calls
    ``ensure_loaded`` with the pruned column set). Derived program nodes
    are written into the dict as usual. The plan-cached serving path
    materializes a plain dict at bind time instead
    (``serve.query_service.execute_stored``)."""

    def __init__(self, dataset: StoredDataset,
                 requirements: Optional[Dict[str, PartRequirement]] = None,
                 params: Optional[dict] = None,
                 capacities: Optional[Dict[str, int]] = None):
        super().__init__()
        self.dataset = dataset
        self.requirements = requirements or {}
        self.params = params
        self.capacities = capacities or {}
        self._loaded_cols: Dict[str, Optional[set]] = {}
        self._loaded_sel: Dict[str, list] = {}

    def fork(self) -> "StorageEnv":
        """Shallow copy sharing the dataset (run_flat_program's local
        namespace; loads still land in the fork only)."""
        env = StorageEnv(self.dataset, self.requirements, self.params,
                         self.capacities)
        env.update(self)
        env._loaded_cols = dict(self._loaded_cols)
        env._loaded_sel = dict(self._loaded_sel)
        return env

    def ensure_loaded(self, name: str, attrs: Optional[set],
                      params: Optional[dict] = None) -> None:
        """Load (or widen) a part. ``params`` are the EVALUATOR's
        ``ExecSettings.params`` — when given they drive zone-map chunk
        selection, so skipping and predicate evaluation always agree on
        every ``N.Param`` binding."""
        if name not in self.dataset.parts:
            return              # derived node: resolved by evaluation
        if name in self and name not in self._loaded_cols:
            return              # externally provided bag: never reload
        have = self._loaded_cols.get(name, False)
        if have is None:
            return              # full part already in memory
        if have is not False and attrs is not None and attrs <= have:
            return
        want: Optional[set] = None
        if attrs is not None:
            want = set(attrs) | (have if have is not False else set())
        part = self.dataset.parts[name]
        if have is not False and want is not None:
            # widening an already-loaded bag: reuse the RECORDED chunk
            # selection (rows must align with the in-memory arrays even
            # if params changed since), reading only the missing columns
            from repro_torch.columnar.table import FlatBag
            ex = self[name]
            add = part.load(columns=sorted(want - have),
                            chunks=self._loaded_sel[name],
                            capacity=ex.capacity)
            data = dict(ex.data)
            data.update(add.data)
            self[name] = FlatBag(data, ex.valid, part._props(data))
        else:
            req = self.requirements.get(name)
            sel = part.select_chunks(
                req.pred if req else None,
                params if params is not None else self.params)
            self[name] = part.load(
                columns=sorted(want) if want is not None else None,
                chunks=sel, capacity=self.capacities.get(name))
            self._loaded_sel[name] = sel
        self._loaded_cols[name] = want


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

class StorageCatalog:
    """Directory of named persisted datasets (the engine's input
    roots). Opened datasets load onto ``device`` (None = the GPU)."""

    def __init__(self, root: str, device=None):
        self.root = root
        self.device = device
        os.makedirs(root, exist_ok=True)
        self._open: Dict[str, StoredDataset] = {}

    def writer(self, name: str, input_types: Dict[str, N.BagT],
               chunk_rows: int = 1024, encoders=None,
               resume: bool = False,
               encoding: str = "auto") -> DatasetWriter:
        self._open.pop(name, None)      # invalidate any cached handle
        return DatasetWriter(self.root, name, input_types,
                             chunk_rows=chunk_rows, encoders=encoders,
                             resume=resume, encoding=encoding)

    def write(self, name: str, inputs: Dict[str, list],
              input_types: Dict[str, N.BagT],
              chunk_rows: int = 1024, encoders=None,
              encoding: str = "auto") -> StoredDataset:
        self.writer(name, input_types, chunk_rows, encoders=encoders,
                    encoding=encoding).write(inputs)
        return self.open(name)

    def open(self, name: str, refresh: bool = False) -> StoredDataset:
        if refresh or name not in self._open:
            self._open[name] = StoredDataset(os.path.join(self.root, name),
                                            device=self.device)
        return self._open[name]

    def datasets(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, d, "footer.json")))

    def env(self, name: str, cp=None,
            params: Optional[dict] = None,
            capacities: Optional[Dict[str, int]] = None) -> StorageEnv:
        """Lazy environment over a dataset; with a compiled program,
        scans prune columns and zone maps skip chunks."""
        ds = self.open(name)
        req = storage_requirements(cp, set(ds.parts)) \
            if cp is not None else None
        return StorageEnv(ds, req, params, capacities)
