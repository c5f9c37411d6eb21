"""Skew-resilient processing (paper §5): a port of ``repro.core.skew``.

Heavy-key detection by sampling, skew-triples, and membership tests.
The paper samples tuples per partition and calls a key *heavy* when it
covers >= ``threshold`` of the sample; with threshold t there can be at
most ceil(1/t) heavy keys per partition (the paper's 2.5% -> 40 keys),
which bounds the broadcast cost of the heavy set.

The tensor helpers run both locally and on each site of the virtual
mesh (``exec.dist``; the distributed variants all_gather the
per-partition candidates).

This module also owns the *plan-time* statistics side:

* ``HeavyKeySketch`` — a streaming Misra-Gries (space-saving) heavy-
  hitter sketch, updated host-side by ``storage.DatasetWriter`` on every
  appended chunk and persisted in the dataset footer. Any key whose
  true frequency exceeds ``total/k`` is guaranteed to be retained, and
  reported counts are lower bounds (undercount <= total/k).
* ``TableStats`` — the per-part statistics record the planner consumes
  (row count, zone-map distinct counts, heavy-key candidates).
* ``decide_heavy_keys`` — the plan-time decision: the heavy-key set a
  ``SkewJoinP`` should split on, or empty when the statistics predict
  no partition imbalance worth a broadcast;
* the HyperCube share planning and the wire-cost arithmetic that gates
  it (host arithmetic, copied from the reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.columnar.table import FlatBag
from repro_torch.exec import ops as X

I64_MAX = X.I64_MAX

MAX_HEAVY = 40
"""Static size of every runtime heavy-key set (the paper's 2.5% -> 40
keys bound). One shape for all bindings is what lets a warm plan rebind
a *different* heavy-key set with zero retraces."""



def heavy_keys_local(key: torch.Tensor, valid: torch.Tensor,
                     sample: int = 256, threshold: float = 0.025,
                     max_heavy: Optional[int] = None) -> torch.Tensor:
    """Per-partition heavy-key candidates from a strided sample.

    Returns a static-size array (max_heavy,) padded with I64_MAX.
    max_heavy defaults to ceil(1/threshold) — the paper's bound. Ties in
    the candidates' counts keep sample order (a stable sort, as
    ``jnp.argsort`` is)."""
    cap = key.shape[0]
    dev = key.device
    if max_heavy is None:
        max_heavy = max(int(1.0 / threshold), 1)
    sample = min(sample, cap)
    stride = max(cap // sample, 1)
    idx = torch.arange(sample, device=dev) * stride
    skey = torch.where(valid[idx], key[idx], I64_MAX)
    # count sampled frequency per key (sort + run lengths)
    sk = torch.sort(skey).values
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sk[1:] != sk[:-1]])
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    ones = (sk != I64_MAX).to(torch.int32)
    counts = torch.zeros(sample, dtype=torch.int32,
                         device=dev).index_add_(0, seg, ones)
    firsts = torch.full((sample,), I64_MAX, dtype=torch.int64,
                        device=dev).scatter_reduce_(
        0, seg, torch.arange(sample, device=dev), "amin")
    need = max(int(threshold * sample), 1)
    is_heavy_seg = counts >= need
    # rank heavy segments by -count and take top max_heavy
    rank = torch.where(is_heavy_seg, -counts, torch.ones_like(counts))
    order = torch.sort(rank, stable=True).indices
    top = order[:max_heavy]
    fidx = firsts[top].clamp(0, sample - 1)
    return torch.where(is_heavy_seg[top], sk[fidx], I64_MAX)


def merge_heavy(candidates: torch.Tensor) -> torch.Tensor:
    """Deduplicate an array of heavy-key candidates (padded I64_MAX),
    returning it sorted (still padded)."""
    sk = torch.sort(candidates.reshape(-1)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=sk.device),
                     sk[1:] == sk[:-1]])
    return torch.sort(torch.where(dup, I64_MAX, sk)).values


def is_member(key: torch.Tensor, heavy_sorted: torch.Tensor,
              use_kernel: bool = False) -> torch.Tensor:
    """Membership of each key in the (sorted, padded) heavy set. The
    kernel path is the CUDA ``member_mask`` on the card (its plain
    version on the CPU), which needs no sorted set; the plain path a
    searchsorted gather — bit-for-bit equal."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.member_mask(key, heavy_sorted)
    pos = torch.searchsorted(heavy_sorted, key)
    pos = pos.clamp(0, heavy_sorted.shape[0] - 1)
    return (heavy_sorted[pos] == key) & (key != I64_MAX)


def split_skew(bag: FlatBag, key_cols, heavy_sorted: torch.Tensor,
               key: Optional[torch.Tensor] = None
               ) -> Tuple[FlatBag, FlatBag]:
    """Split a bag into (light, heavy) components of a skew-triple.
    ``key`` optionally supplies the pre-packed key so the skew path
    (detect -> split -> exchange) packs each key set exactly once."""
    if key is None:
        key = X.pack_keys(bag, key_cols)
    hv = is_member(key, heavy_sorted)
    return bag.mask(~hv), bag.mask(hv)

def pad_heavy(keys: Sequence[int], max_heavy: int = MAX_HEAVY
              ) -> np.ndarray:
    """Sorted ``(max_heavy,)`` int64 heavy-key array padded with
    I64_MAX — the fixed runtime-parameter shape every ``SkewJoinP``
    binding uses (``is_member`` treats the padding as no key)."""
    ks = sorted(int(k) for k in set(keys))
    assert len(ks) <= max_heavy, (
        f"{len(ks)} heavy keys exceed the static bound {max_heavy}")
    out = np.full(max_heavy, np.iinfo(np.int64).max, dtype=np.int64)
    out[:len(ks)] = ks
    return out


class HeavyKeySketch:
    """Misra-Gries / space-saving heavy-hitter sketch over a stream of
    integer keys. ``k`` counters guarantee every key with true frequency
    > total/k survives; each reported count is a lower bound whose
    undercount is at most ``error_bound()``. Pure numpy, updated by the
    storage writer as chunks land; JSON round-trips through the dataset
    footer."""

    def __init__(self, k: int = 64,
                 counts: Optional[Dict[int, int]] = None,
                 total: int = 0):
        assert k > 0
        self.k = k
        self.counts: Dict[int, int] = dict(counts or {})
        self.total = int(total)
        self._decremented = 0

    def update(self, arr: np.ndarray) -> None:
        """Fold one batch of keys into the sketch. The same counters,
        in the same dict order, as the reference's per-key loop; the
        batch is merged and cut with array operations (a column of 15M
        distinct keys would otherwise take a Python loop and a sort of
        15M items)."""
        vals, cnts = np.unique(np.asarray(arr).astype(np.int64),
                               return_counts=True)
        self.total += int(cnts.sum())
        # Misra-Gries decrement, batched: subtract the (k+1)-th largest
        # count and keep the top k counters by (count, key). Keeping
        # survivors at a floor of 1 (rather than dropping ties at the
        # cut) preserves exactly k counters, so borderline-heavy keys
        # accumulated earlier keep their lead over a fresh near-uniform
        # batch. Lower bounds survive: every survivor's stored count
        # only ever decreases by <= cut per shed, and cut accumulates
        # into error_bound().
        keys, counts = vals, cnts.astype(np.int64)
        if self.counts:
            old_k = np.fromiter(self.counts.keys(), np.int64,
                                len(self.counts))
            old_c = np.fromiter(self.counts.values(), np.int64,
                                len(self.counts))
            pos = np.searchsorted(vals, old_k)
            hit = pos < vals.size
            hit[hit] = vals[pos[hit]] == old_k[hit]
            counts = counts.copy()
            counts[pos[hit]] += old_c[hit]
            keys = np.concatenate([keys, old_k[~hit]])
            counts = np.concatenate([counts, old_c[~hit]])
        if keys.size <= self.k:
            # no cut: the loop's order (old keys first, then new ones)
            merged = dict(self.counts)
            for v, c in zip(vals.tolist(), cnts.tolist()):
                merged[v] = merged.get(v, 0) + c
            self.counts = merged
            return
        # the k + 1 first items by (-count, key) all have a count of at
        # least the (k+1)-th largest count
        kth = keys.size - (self.k + 1)
        floor = np.partition(counts, kth)[kth]
        cand = np.flatnonzero(counts >= floor)
        order = cand[np.lexsort((keys[cand], -counts[cand]))]
        cut = int(counts[order[self.k]])
        self._decremented += cut
        top = order[:self.k]
        self.counts = {v: max(c - cut, 1) for v, c in
                       zip(keys[top].tolist(), counts[top].tolist())}

    def error_bound(self) -> int:
        """Max undercount of any reported counter."""
        return self._decremented

    def heavy(self, threshold: float, total: Optional[int] = None
              ) -> List[Tuple[int, int]]:
        """Keys whose estimated frequency is >= ``threshold`` of
        ``total`` (default: the stream length), most frequent first.
        Counts are lower bounds, so the test errs toward *missing* a
        borderline key, never toward fabricating one."""
        tot = self.total if total is None else int(total)
        need = max(int(threshold * tot), 1)
        out = [(v, c) for v, c in self.counts.items() if c >= need]
        out.sort(key=lambda vc: (-vc[1], vc[0]))
        return out

    def to_json(self) -> dict:
        return {"k": self.k, "total": self.total,
                "decremented": self._decremented,
                "counts": [[int(v), int(c)]
                           for v, c in sorted(self.counts.items())]}

    @staticmethod
    def from_json(d: dict) -> "HeavyKeySketch":
        s = HeavyKeySketch(k=int(d["k"]),
                           counts={int(v): int(c) for v, c in d["counts"]},
                           total=int(d["total"]))
        s._decremented = int(d.get("decremented", 0))
        return s


@dataclass
class TableStats:
    """Planner-facing statistics for one stored part / input bag:
    ``rows`` (total valid rows), ``distinct`` per column (zone-map
    derived upper bound), and per-column heavy-key candidates
    ``heavy[col] = [(key, count_lower_bound), ...]`` from the streaming
    sketch.

    ``meters`` holds *observed* runtime measurements fed back by the
    telemetry layer (``repro.obs.feedback``): ``rows`` (measured valid
    rows from an actual execution — capacities and sketches are
    estimates, this is ground truth) and ``imbalance_x100`` (worst
    measured receive-load imbalance of the family's exchanges). Plan
    decisions consume ``effective_rows`` so a re-compile after serving
    uses measured rather than sketched cardinalities (ROADMAP item 4)."""
    rows: int
    distinct: Dict[str, int] = dc_field(default_factory=dict)
    heavy: Dict[str, List[Tuple[int, int]]] = dc_field(
        default_factory=dict)
    meters: Dict[str, float] = dc_field(default_factory=dict)

    @property
    def effective_rows(self) -> int:
        """Measured rows when the feedback loop has recorded them,
        the estimate otherwise."""
        return int(self.meters.get("rows", self.rows))

    def to_json(self) -> dict:
        return {"rows": int(self.rows),
                "distinct": {k: int(v) for k, v in self.distinct.items()},
                "heavy": {c: [[int(k), int(n)] for k, n in ks]
                          for c, ks in self.heavy.items()},
                "meters": dict(self.meters)}

    @classmethod
    def from_json(cls, d: dict) -> "TableStats":
        return cls(rows=int(d.get("rows", 0)),
                   distinct={k: int(v)
                             for k, v in d.get("distinct", {}).items()},
                   heavy={c: [(int(k), int(n)) for k, n in ks]
                          for c, ks in d.get("heavy", {}).items()},
                   meters=dict(d.get("meters", {})))


# ---------------------------------------------------------------------------
# plan-time skew decision and HyperCube planning (host arithmetic, copied
# from the reference)
# ---------------------------------------------------------------------------

def decide_heavy_keys(stats: TableStats, col: str,
                      n_partitions: int,
                      threshold: float = 0.025,
                      max_heavy: int = MAX_HEAVY) -> List[int]:
    """The automatic skew decision for a join keyed on ``stats[col]``.

    A key takes the heavy path when its (lower-bound) frequency exceeds
    the FAIR PARTITION SHARE ``rows / n_partitions`` — Beame et al.'s
    heavy-hitter bound: only such a key can force one partition above
    the perfectly balanced load, so anything below it cannot pay for a
    broadcast. ``threshold`` (the paper's 2.5% sampling resolution)
    acts as a floor so micro-inputs don't flag noise. A uniform key
    column therefore yields ZERO heavy keys — the plan stays a plain
    hash join (the degenerate no-op contract) — and with
    n_partitions == 1 no exchange can be imbalanced at all."""
    if n_partitions <= 1:
        return []
    cand = stats.heavy.get(col)
    if not cand:
        return []
    rows = stats.effective_rows
    need = max(int(threshold * rows), -(-rows // n_partitions), 1)
    picked = [k for k, c in sorted(cand, key=lambda vc: (-vc[1], vc[0]))
              if c >= need]
    return picked[:max_heavy]


def stats_heavy_array(stats: Dict[str, TableStats], bag: str, col: str,
                      n_partitions: int, threshold: float = 0.025,
                      max_heavy: int = MAX_HEAVY) -> Optional[np.ndarray]:
    """Padded heavy-key parameter value for (bag, col), or None when the
    statistics predict no imbalance (the SkewJoinP no-op case)."""
    ts = stats.get(bag)
    if ts is None:
        return None
    ks = decide_heavy_keys(ts, col, n_partitions, threshold, max_heavy)
    if not ks:
        return None
    return pad_heavy(ks, max_heavy)


# ---------------------------------------------------------------------------
# HyperCube share planning (Beame/Koutris/Suciu one-round multiway joins)
# ---------------------------------------------------------------------------

def _share_assignments(n_dims: int, P: int):
    """All per-dimension share vectors (s_0..s_{n-1}) with every s_d >= 1
    and prod(s_d) <= P. Small for the meshes we target (P <= 64,
    n_dims <= 4): the enumeration is bounded by the divisor lattice."""
    out: List[Tuple[int, ...]] = []

    def rec(prefix: List[int], budget: int) -> None:
        if len(prefix) == n_dims:
            out.append(tuple(prefix))
            return
        s = 1
        while s <= budget:
            rec(prefix + [s], budget // s)
            s += 1
        # (loop covers every s with prod <= P; non-divisors allowed —
        # unused coordinates simply idle, which the load term prices in)

    rec([], max(P, 1))
    return out


def plan_hypercube_shares(rel_dims: Sequence[Sequence[int]],
                          rel_rows: Sequence[int], P: int,
                          n_dims: Optional[int] = None
                          ) -> Tuple[Tuple[int, ...], float]:
    """Pick the hypercube mesh factorization for a multiway equi-join.

    ``rel_dims[r]`` lists the hash dimensions relation ``r`` keys on;
    ``rel_rows[r]`` its (estimated) row count. The P servers are
    factored into per-dimension shares (p_0, p_1, ...) with
    prod <= P; relation r is hashed on its own dimensions and
    REPLICATED across the missing ones, so its per-server receive load
    is rows_r / prod_{d in dims_r} p_d. Returns the share vector
    minimizing the max per-server load (the fair-share bound), with
    total replicated rows as the tiebreak — degenerate meshes fall out
    naturally: P == 1 gives all-ones shares, a prime P puts the whole
    mesh on one dimension, and a tiny relation gets share 1 on its
    dimensions (it broadcasts, which is exactly the cheap plan)."""
    if n_dims is None:
        n_dims = max((max(ds) + 1 for ds in rel_dims if ds), default=0)
    if n_dims == 0:
        return (), 0.0
    best = None
    for shares in _share_assignments(n_dims, max(int(P), 1)):
        load = 0.0
        repl_rows = 0
        for dims, rows in zip(rel_dims, rel_rows):
            own = 1
            for d in dims:
                own *= shares[d]
            miss = 1
            for d in range(n_dims):
                if d not in dims:
                    miss *= shares[d]
            load += rows / own
            repl_rows += rows * (miss - 1)
        key = (load, repl_rows, [-s for s in shares])
        if best is None or key < best[0]:
            best = (key, shares, load)
    assert best is not None
    return best[1], best[2]


def hypercube_send_rows(rel_dims: Sequence[Sequence[int]],
                        rel_rows: Sequence[int],
                        shares: Sequence[int]) -> int:
    """Total rows crossing the wire under ``shares`` (each tuple is sent
    once per replica): sum_r rows_r * prod_{d not in dims_r} p_d."""
    total = 0
    for dims, rows in zip(rel_dims, rel_rows):
        miss = 1
        for d in range(len(shares)):
            if d not in dims:
                miss *= shares[d]
        total += rows * miss
    return total


def cascade_send_rows(rel_rows: Sequence[int]) -> int:
    """Wire cost of the binary left-deep cascade the optimizer would
    otherwise emit: every relation crosses once, and each intermediate
    (probe-cardinality ~ the spine, rel 0) is re-partitioned for the
    next join key — (k-1) extra crossings of the spine for k joins.

    The "intermediate ~ spine" assumption is the stats-free fallback;
    with a cardinality estimator the gate uses
    :func:`cascade_send_rows_est` instead (ROADMAP item 4)."""
    if len(rel_rows) < 2:
        return sum(rel_rows)
    spine = rel_rows[0]
    return sum(rel_rows) + (len(rel_rows) - 2) * spine


def cascade_send_rows_est(rel_rows: Sequence[int],
                          intermediates: Sequence[float]) -> int:
    """Cascade wire cost with ESTIMATED intermediate cardinalities
    (``repro.core.cost``): every relation crosses once, and each
    intermediate except the last is re-partitioned for its next join
    key. ``intermediates[i]`` estimates the spine after ``i + 1``
    joins; the final intermediate is the output and never re-crosses.
    With ``intermediates[i] == rel_rows[0]`` for all i this equals
    :func:`cascade_send_rows` exactly."""
    if len(rel_rows) < 2:
        return sum(rel_rows)
    return int(sum(rel_rows) + sum(intermediates[:-1]))
