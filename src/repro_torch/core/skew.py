"""Skew statistics, part 1 (a copy of the numpy-only half of
``repro.core.skew`` that the storage engine needs).

* ``HeavyKeySketch`` — a streaming Misra-Gries (space-saving) heavy-
  hitter sketch, updated host-side by ``storage.DatasetWriter`` on every
  appended chunk and persisted in the dataset footer. Any key whose
  true frequency exceeds ``total/k`` is guaranteed to be retained, and
  reported counts are lower bounds (undercount <= total/k).
* ``TableStats`` — the per-part statistics record the planner consumes
  (row count, zone-map distinct counts, heavy-key candidates).
* ``pad_heavy`` / ``MAX_HEAVY`` — the fixed runtime shape of a heavy-key
  set.

Heavy-key detection on the device, membership tests, the skew decision
(``decide_heavy_keys``) and the HyperCube planning are ROADMAP.md
queue 1 item 4.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_HEAVY = 40
"""Static size of every runtime heavy-key set (the paper's 2.5% -> 40
keys bound). One shape for all bindings is what lets a warm plan rebind
a *different* heavy-key set with zero retraces."""


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
