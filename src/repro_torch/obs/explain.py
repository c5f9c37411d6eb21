"""EXPLAIN ANALYZE for shredded plans (PyTorch twin of
``repro.obs.explain``).

``explain_analyze(program, env, input_types)`` runs the query through
the COMPILED path — ``shred_program`` -> ``compile_program`` (all plan
passes: pruning, CSE, skew, hypercube) -> plan evaluation — with an
:class:`ExplainRecorder` hooked into ``core.plans.eval_plan``, then
renders the plan tree annotated per operator with

* rows in / rows out (measured, not estimated),
* bytes read / decoded and chunk skip rate (storage-backed scans),
* collectives, rows shipped, receive imbalance and replication factor
  (distributed exchanges),
* wall time per subtree.

Two execution modes:

* **Local** (``mesh=None``): the plan evaluates eagerly, and every
  operator synchronizes its device before its clock stops, so wall
  times are real per-subtree latencies (explain is a diagnostic, not a
  serving path).
* **Distributed** (``mesh=`` an ``exec.dist.device_mesh_1d`` mesh): the
  same program runs once on every site of the virtual mesh, each site
  on a thread of its own. Every site numbers its operators in the same
  order (the recorder's state is per thread) and adds each node's valid
  rows to an ``xrows_<id>`` metric, which the mesh sums (inputs are
  row-sharded, so the sum is the global truth); exchange-site meters
  (``part_max_<site>`` / ``part_rows_<site>`` / ``size_used_<site>`` /
  ``replication_x100_<site>``) are attributed to the operator that
  claimed the site. Only the site that records host telemetry
  (``obs.metrics.host_recording``: site 0) builds the tree that the
  result returns. Wall times in this mode are that site's host times
  with no per-node synchronize, labelled ``trace_ms`` as the
  reference's trace times are; device time exists only per whole query
  (``total_ms``, after a synchronize).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .metrics import REGISTRY, host_recording

# registry domains whose per-node deltas are worth attributing
_DOMAINS = ("shuffle.collectives", "shuffle.exchanges",
            "shuffle.exchange_elided", "shuffle.hypercube_exchanges",
            "storage.bytes_read", "storage.bytes_decoded",
            "storage.chunks_read", "storage.chunks_skipped",
            "sort.sorts", "sort.key_reuse")


@dataclass
class ExplainNode:
    id: int
    op: str                      # plan class name (ScanP, SumAggP, ...)
    label: str                   # one-line operator description
    children: List["ExplainNode"] = field(default_factory=list)
    rows_out: Optional[int] = None
    rows_in: Optional[int] = None
    wall_ms: Optional[float] = None      # real (local) or trace (dist)
    meters: Dict[str, float] = field(default_factory=dict)
    sites: tuple = ()            # dist sizing sites claimed by this node
    # cost-based planning (cost_mode="auto"): the optimizer's row
    # estimate for this operator, rendered next to the measured rows
    est_rows: Optional[int] = None
    # structural signature digest (cost.sig_digest) — the key under
    # which StatsFeedback.record_explain persists the MEASURED rows, so
    # the next compile's estimator reads ground truth for this operator
    sig: Optional[str] = None

    def qerror(self) -> Optional[float]:
        """Q-error of the estimate: max(est/actual, actual/est), both
        floored at one row. None until both sides exist."""
        if self.est_rows is None or self.rows_out is None:
            return None
        e = max(float(self.est_rows), 1.0)
        a = max(float(self.rows_out), 1.0)
        return max(e / a, a / e)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def to_json(self) -> dict:
        return {"id": self.id, "op": self.op, "label": self.label,
                "rows_in": self.rows_in, "rows_out": self.rows_out,
                "est_rows": self.est_rows, "sig": self.sig,
                "wall_ms": self.wall_ms, "meters": dict(self.meters),
                "sites": list(self.sites),
                "children": [c.to_json() for c in self.children]}


class ExplainRecorder:
    """Per-operator observer threaded through ``eval_plan`` via
    ``ExecSettings.explain``. ``record`` wraps one operator evaluation;
    recursive child evaluations re-enter it, building the tree.

    The numbering state (stack, next id, current assignment) is per
    thread, so the sites of a virtual mesh, which evaluate the same
    plans concurrently, each number their operators from 0 in program
    order. ``roots`` and ``assignments`` hold the tree of the thread
    that records host telemetry; the other sites' trees are dropped."""

    def __init__(self, distributed: bool = False):
        self.distributed = distributed
        self.roots: List[ExplainNode] = []
        self.assignments: List[str] = []     # parallel to roots
        self._tls = threading.local()

    def _state(self):
        st = self._tls
        if not hasattr(st, "stack"):
            st.stack, st.n, st.assignment = [], 0, "?"
            st.roots, st.assignments = (
                (self.roots, self.assignments) if host_recording()
                else ([], []))
        return st

    def begin_assignment(self, name: str) -> None:
        self._state().assignment = name

    def record(self, p, env, s, inner):
        from repro_torch.core import plans as P
        from repro_torch.core.cost import sig_digest
        st = self._state()
        node = ExplainNode(st.n, type(p).__name__,
                           P.plan_pretty(p).split("\n")[0].strip())
        node.est_rows = getattr(p, "est_rows", None)
        node.sig = sig_digest(p)
        st.n += 1
        if st.stack:
            st.stack[-1].children.append(node)
        else:
            st.roots.append(node)
            st.assignments.append(st.assignment)
        st.stack.append(node)
        ctx = s.dist
        site_lo = ctx._n_sites if ctx is not None else 0
        base = {k: REGISTRY.get(k) for k in _DOMAINS}
        t0 = time.perf_counter()
        try:
            bag = inner(p, env, s)
        finally:
            st.stack.pop()
        if ctx is not None:
            node.sites = tuple(range(site_lo, ctx._n_sites))
            # global rows: summed over the mesh at finalize (inputs are
            # row-sharded, so per-site valid counts sum to the truth)
            ctx._add(f"xrows_{node.id}", bag.valid.sum())
        else:
            # eager path: synchronize so the subtree's wall time is
            # honest, then read the concrete row count
            if bag.valid.is_cuda:
                torch.cuda.synchronize(bag.valid.device)
            node.rows_out = int(bag.valid.sum())
        node.wall_ms = (time.perf_counter() - t0) * 1e3
        node.meters = {k: REGISTRY.get(k) - base[k]
                       for k in _DOMAINS if REGISTRY.get(k) != base[k]}
        return bag

    # -- post-run ---------------------------------------------------------
    def finalize(self, metrics: Optional[dict] = None,
                 host_stats: Optional[dict] = None,
                 n_partitions: int = 1) -> None:
        """Fill distributed row counts and per-site exchange meters from
        the run's metrics, then derive rows_in everywhere."""
        metrics = metrics or {}
        host_stats = host_stats or {}
        for root in self.roots:
            for node in root.walk():
                if self.distributed:
                    n = metrics.get(f"xrows_{node.id}")
                    if n is not None:
                        node.rows_out = int(n)
                    for site in node.sites:
                        pr = metrics.get(f"part_rows_{site}")
                        pm = metrics.get(f"part_max_{site}")
                        if pr:
                            node.meters["rows_shipped"] = \
                                node.meters.get("rows_shipped", 0) + int(pr)
                            if pm is not None:
                                imb = float(pm) * n_partitions / float(pr)
                                node.meters["imbalance"] = round(max(
                                    node.meters.get("imbalance", 1.0),
                                    imb), 2)
                        rep = host_stats.get(f"replication_x100_{site}")
                        if rep is not None:
                            node.meters["replication"] = max(
                                node.meters.get("replication", 0),
                                rep / 100.0)
        # second pass: rows_in from the now-complete child rows
        for root in self.roots:
            for node in root.walk():
                if node.children:
                    kid_rows = [c.rows_out for c in node.children]
                    if all(r is not None for r in kid_rows):
                        node.rows_in = sum(kid_rows)


@dataclass
class ExplainResult:
    roots: List[ExplainNode]
    assignments: List[str]
    total_ms: float
    compile_ms: float
    distributed: bool
    metrics: Dict[str, float] = field(default_factory=dict)
    outputs: Dict[str, object] = field(default_factory=dict)

    def nodes(self) -> List[ExplainNode]:
        out = []
        for r in self.roots:
            out.extend(r.walk())
        return out

    def find(self, op: str) -> List[ExplainNode]:
        return [n for n in self.nodes() if n.op == op]

    def qerrors(self) -> List[float]:
        """Per-operator Q-errors, every node with both an estimate and
        a measured row count (cost_mode="auto" runs only)."""
        return [q for q in (n.qerror() for n in self.nodes())
                if q is not None]

    def qerror_summary(self) -> Dict[str, Optional[float]]:
        """p50/max of the per-operator Q-error (max <= 4 after one
        feedback round is the cost planner's contract)."""
        qs = sorted(self.qerrors())
        if not qs:
            return {"qerr_p50": None, "qerr_max": None}
        return {"qerr_p50": round(qs[len(qs) // 2], 3),
                "qerr_max": round(qs[-1], 3)}

    def to_json(self) -> dict:
        return {"distributed": self.distributed,
                "total_ms": round(self.total_ms, 3),
                "compile_ms": round(self.compile_ms, 3),
                "assignments": [
                    {"name": a, "plan": r.to_json()}
                    for a, r in zip(self.assignments, self.roots)]}

    def pretty(self) -> str:
        unit = "trace_ms" if self.distributed else "ms"
        lines = [f"EXPLAIN ANALYZE "
                 f"({'distributed' if self.distributed else 'local'}; "
                 f"compile {self.compile_ms:.1f} ms, "
                 f"run {self.total_ms:.1f} ms)"]

        def fmt(node: ExplainNode, depth: int) -> None:
            ann = []
            if node.rows_out is not None:
                ann.append(f"rows={node.rows_out}")
            if node.est_rows is not None:
                ann.append(f"est={node.est_rows}")
                q = node.qerror()
                if q is not None:
                    ann.append(f"q={q:.2f}")
            if node.rows_in is not None:
                ann.append(f"in={node.rows_in}")
            m = node.meters
            if m.get("storage.bytes_read"):
                ann.append(f"read={int(m['storage.bytes_read'])}B")
            if m.get("storage.bytes_decoded"):
                ann.append(f"decoded={int(m['storage.bytes_decoded'])}B")
            cr, cs = m.get("storage.chunks_read", 0), \
                m.get("storage.chunks_skipped", 0)
            if cr or cs:
                ann.append(f"chunks={int(cr)}r/{int(cs)}s")
            if m.get("shuffle.collectives"):
                ann.append(f"collectives={int(m['shuffle.collectives'])}")
            if m.get("shuffle.exchange_elided"):
                ann.append(
                    f"elided={int(m['shuffle.exchange_elided'])}")
            if m.get("rows_shipped"):
                ann.append(f"shipped={int(m['rows_shipped'])}")
            if m.get("imbalance"):
                ann.append(f"imbalance={m['imbalance']:.2f}")
            if m.get("replication"):
                ann.append(f"replication={m['replication']:.2f}x")
            if node.wall_ms is not None:
                ann.append(f"{unit}={node.wall_ms:.2f}")
            lines.append("  " * depth + node.label
                         + ("   [" + " ".join(ann) + "]" if ann else ""))
            for c in node.children:
                fmt(c, depth + 1)

        for a, r in zip(self.assignments, self.roots):
            lines.append(f"{a} <=")
            fmt(r, 1)
        return "\n".join(lines)


def explain_analyze(program, env, input_types: Optional[dict] = None,
                    *, catalog=None, params: Optional[dict] = None,
                    skew_stats: Optional[dict] = None,
                    skew_mode: str = "auto",
                    skew_partitions: int = 8,
                    hypercube_mode: str = "auto",
                    cost_mode: str = "off",
                    observed_rows: Optional[dict] = None,
                    mesh=None, use_kernel: bool = False,
                    cap_factor: float = 2.0,
                    device=None) -> ExplainResult:
    """Compile ``program`` and evaluate it with per-operator recording.

    ``program`` is an ``N.Program`` (or a bare ``N.Expr``, wrapped as
    the single assignment ``Q``). ``env`` maps input names to FlatBags
    or row lists — or is a ``storage.StoredDataset``, in which case
    scans load lazily with column pruning and zone-map chunk skipping
    (their I/O metered on the scan operators). ``input_types`` is
    required unless every env value is a FlatBag and the program's Vars
    carry types (the usual case). ``mesh`` switches to the distributed
    path (see module docstring). ``device`` is where row lists are
    shredded (None = the GPU); FlatBags and datasets stay where they
    are.

    ``cost_mode="auto"`` compiles with the cost-based planner
    (``core.cost``): every operator renders its ``est_rows`` next to
    the measured rows with a per-operator Q-error, and
    ``result.qerror_summary()`` gives the p50/max. ``observed_rows``
    ({signature digest: measured rows}, typically
    ``StatsFeedback.node_rows`` harvested from a previous result via
    ``record_explain``) closes the loop: the re-compile estimates from
    ground truth."""
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings, as_scalar_tensor, \
        eval_plan

    if isinstance(program, N.Expr):
        program = N.Program([N.Assignment("Q", program)])
    if input_types is None:
        input_types = {}
        produced = set()
        for a in program.assignments:
            for name, ty in N.free_vars(a.expr).items():
                if name not in produced:
                    input_types.setdefault(name, ty)
            produced.add(a.name)

    t0 = time.perf_counter()
    sp = M.shred_program(program, input_types, domain_elimination=True)
    cp = CG.compile_program(sp, catalog, skew_stats=skew_stats,
                            skew_mode=skew_mode,
                            skew_partitions=skew_partitions,
                            hypercube_mode=hypercube_mode,
                            cost_mode=cost_mode,
                            observed_rows=observed_rows)
    compile_ms = (time.perf_counter() - t0) * 1e3

    # resolve the environment
    stored = hasattr(env, "load_env") or hasattr(env, "dataset")
    if hasattr(env, "load_env"):            # StoredDataset -> lazy env
        from repro_torch.storage import StorageEnv, storage_requirements
        env = StorageEnv(env, storage_requirements(cp), params=params)
    elif not stored and env and not all(
            hasattr(b, "valid") for b in env.values()):
        env = CG.columnar_shred_inputs(env, input_types, device=device)

    defaults = CG.collect_params(cp.graph) if cp.graph is not None else {}
    if params:
        defaults.update(params)
    defaults = {k: v for k, v in defaults.items() if v is not None}

    recorder = ExplainRecorder(distributed=mesh is not None)
    t1 = time.perf_counter()
    if mesh is None:
        # parameters as host tensors, as ProgramExecutable.bind gives them
        s = ExecSettings(use_kernel=use_kernel,
                         params={k: as_scalar_tensor(v, "cpu")
                                 for k, v in defaults.items()} or None,
                         explain=recorder)
        local = env if isinstance(env, dict) else dict(env)
        for name, plan in cp.plans:
            recorder.begin_assignment(name)
            local[name] = eval_plan(plan, local, s)
        total_ms = (time.perf_counter() - t1) * 1e3
        recorder.finalize()
        outs = {n: local[n] for n, _ in cp.plans}
        return ExplainResult(recorder.roots, recorder.assignments,
                             total_ms, compile_ms, False, {}, outs)

    # distributed: the same schedule once on every site, adaptive
    # capacity off so the recorder sees exactly one run
    from repro_torch.exec import dist as D
    if stored:
        raise ValueError("explain_analyze: storage-backed env is "
                         "local-only (load the bags first)")
    nparts = mesh.shape[next(iter(mesh.shape))]
    outs_names = tuple(n for n, _ in cp.plans)

    def fn(env_local, ctx, params_local):
        s = ExecSettings(use_kernel=use_kernel, dist=ctx,
                         params=params_local, explain=recorder)
        local = dict(env_local)
        for name, plan in cp.plans:
            recorder.begin_assignment(name)
            local[name] = eval_plan(plan, local, s)
        return {o: local[o] for o in outs_names}

    runner, out, metrics = D.compile_distributed(
        fn, env, mesh, use_kernel=use_kernel, cap_factor=cap_factor,
        adaptive=False, params=defaults or {})
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    total_ms = (time.perf_counter() - t1) * 1e3
    # one run of fn: the recording site began each assignment once
    assert recorder.assignments == list(outs_names), (
        "explain_analyze: the recorder holds more than one run "
        f"({recorder.assignments} for the plans {list(outs_names)})")
    recorder.finalize(metrics, runner.stats, nparts)
    return ExplainResult(recorder.roots, recorder.assignments, total_ms,
                         compile_ms, True,
                         {k: v for k, v in metrics.items()
                          if not k.startswith("xrows_")}, dict(out))
