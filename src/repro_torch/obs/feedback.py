"""Observed-stats feedback (PyTorch twin of ``repro.obs.feedback``):
measured runtime meters flow back into the planner statistics, so
repeated serving self-tunes.

What gets measured, and where it goes:

* **Per-bag cardinalities.** Capacities and streaming sketches are
  estimates; after an execution the VALID row count of every input bag
  is ground truth. :meth:`StatsFeedback.record_env` snapshots them
  (one host sync per bag, only on the feedback path), and
  ``QueryService._hint_stats`` folds them into the ``TableStats`` it
  hands the skew/hypercube passes — so a re-compile (new capacity
  class, restarted server) costs ``plan_hypercube_shares`` and
  ``decide_heavy_keys`` with measured rather than sketched rows
  (``TableStats.effective_rows``).
* **Receive-load imbalance.** Every distributed exchange meters
  ``part_max_<site>`` / ``part_rows_<site>``;
  :meth:`StatsFeedback.record_metrics` reduces them to the worst
  fair-share ratio (Beame et al.'s bound — the quantity the skew
  machinery exists to control) and keeps a per-family history.
* **Persistence.** :func:`record_observed_stats` writes the meters into
  the dataset footer (``PartMeta.meters``, an optional field — old
  footers read fine), and ``StoredPart.stats()`` surfaces them through
  ``TableStats.meters`` on the next open.
"""

from __future__ import annotations

import json
from typing import Dict, Optional


class StatsFeedback:
    """Accumulator for observed runtime meters, shared by a
    ``QueryService`` (pass one to its constructor) or driven manually.

    ``rows[bag]`` — measured valid rows per input bag (latest wins);
    ``imbalance_x100[family]`` — worst observed receive-load imbalance
    per plan family (monotone max, x100 so it stores as an int);
    ``node_rows[sig]`` — measured PER-OPERATOR output rows keyed by
    structural plan-signature digest (``cost.sig_digest``, stable
    across processes), harvested from EXPLAIN ANALYZE results by
    :meth:`record_explain`. ``QueryService._observed_rows`` /
    ``compile_program(observed_rows=...)`` hand them to the cost
    estimator, which pins matching operators' estimates to ground
    truth on the next compile — the one-feedback-round Q-error
    contract (max Q-error <= 4 after one round)."""

    def __init__(self):
        self.rows: Dict[str, int] = {}
        self.imbalance_x100: Dict[str, int] = {}
        self.node_rows: Dict[str, int] = {}

    # -- recording --------------------------------------------------------
    def record_env(self, env) -> None:
        """Measure valid-row counts of every concrete input bag. Forces
        one device sync per bag — feedback-path only (the cold compile),
        never on the hot serving path for an already-measured bag set."""
        for name, bag in env.items():
            v = getattr(bag, "valid", None)
            if v is None:
                continue
            self.rows[name] = int(v.sum())

    def record_metrics(self, family: str, metrics: Optional[dict],
                       n_partitions: int) -> float:
        """Fold one execution's device metrics into the per-family
        imbalance history; returns the measured ratio."""
        worst = 1.0
        if metrics and n_partitions > 1:
            for k, v in metrics.items():
                if not k.startswith("part_max_"):
                    continue
                site = k[len("part_max_"):]
                total = metrics.get(f"part_rows_{site}", 0)
                if total:
                    worst = max(worst,
                                float(v) * n_partitions / float(total))
        cur = self.imbalance_x100.get(family, 100)
        self.imbalance_x100[family] = max(cur, int(worst * 100))
        return worst

    def record_explain(self, result) -> int:
        """Harvest per-operator measured row counts from an
        ``obs.ExplainResult`` into ``node_rows`` (latest wins).
        Returns the number of operators recorded."""
        n = 0
        for node in result.nodes():
            if node.sig is not None and node.rows_out is not None:
                self.node_rows[node.sig] = int(node.rows_out)
                n += 1
        return n

    # -- consumption ------------------------------------------------------
    def observed_rows(self, bag: str) -> Optional[int]:
        return self.rows.get(bag)

    def apply(self, stats: Optional[dict]) -> Optional[dict]:
        """Overlay measured rows onto a ``{bag: TableStats}`` dict (in
        place; returns it for chaining). Bags without a measurement are
        untouched."""
        if stats is None:
            return None
        for bag, ts in stats.items():
            n = self.rows.get(bag)
            if n is not None and hasattr(ts, "meters"):
                ts.meters["rows"] = int(n)
        return stats

    def part_meters(self, family: Optional[str] = None
                    ) -> Dict[str, Dict[str, float]]:
        """``{part: meters}`` ready for :func:`record_observed_stats`."""
        imb = self.imbalance_x100.get(family) if family is not None \
            else (max(self.imbalance_x100.values())
                  if self.imbalance_x100 else None)
        out = {}
        for part, n in self.rows.items():
            m: Dict[str, float] = {"rows": int(n)}
            if imb is not None:
                m["imbalance_x100"] = int(imb)
            out[part] = m
        return out

    # -- (de)serialization ------------------------------------------------
    def to_json(self) -> dict:
        return {"rows": dict(self.rows),
                "imbalance_x100": dict(self.imbalance_x100),
                "node_rows": dict(self.node_rows)}

    @classmethod
    def from_json(cls, d: dict) -> "StatsFeedback":
        fb = cls()
        fb.rows = {k: int(v) for k, v in d.get("rows", {}).items()}
        fb.imbalance_x100 = {k: int(v) for k, v in
                             d.get("imbalance_x100", {}).items()}
        fb.node_rows = {k: int(v) for k, v in
                        d.get("node_rows", {}).items()}
        return fb

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "StatsFeedback":
        with open(path) as f:
            return cls.from_json(json.load(f))


def record_observed_stats(dirpath: str,
                          meters: Dict[str, Dict[str, float]]) -> int:
    """Merge observed meters into a persisted dataset's footer
    (``PartMeta.meters``) and rewrite it atomically. ``meters`` maps
    part name -> meter dict (unknown parts are ignored — an in-memory
    bag name need not exist on disk). Returns the number of parts
    updated. The next ``open_dataset(...).stats()`` surfaces the values
    through ``TableStats.meters`` / ``effective_rows``."""
    from repro_torch.storage.format import read_footer, write_footer
    meta = read_footer(dirpath)
    n = 0
    for part, m in meters.items():
        pm = meta.parts.get(part)
        if pm is None:
            continue
        pm.meters.update({k: (int(v) if float(v).is_integer() else
                              float(v)) for k, v in m.items()})
        n += 1
    if n:
        write_footer(dirpath, meta)
    return n
