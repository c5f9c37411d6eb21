"""PhysicalProps — cached physical properties of a FlatBag.

The paper's shredded pipelines win by sharing work across the query
bundle; the TPU executor realizes that sharing through this record:
operators consult and propagate it instead of re-deriving packed keys,
sort permutations and build-side orderings per operator.

Contract (full table in DESIGN.md "Physical properties and fusion"):

* ``key_cache[cols]``  — packed int64 equality key for the column
  tuple, aligned row-for-row with the bag. Values at *invalid* rows are
  unspecified (every consumer masks by validity before use), which is
  what lets exchanges ship keys alongside data.
* ``sorted_by``        — column tuple C such that the bag's VALID rows
  appear in nondecreasing lexicographic order of the int64-cast columns
  of C. Invalid rows may be interleaved. Any *prefix* of C is also a
  delivered ordering (lexicographic, not hashed, precisely so prefixes
  compose: sum_by(G+A) feeds nest_level(G) without a second sort).
* ``invalid_last``     — strengthens ``sorted_by``: every invalid row
  sits after every valid row (fresh sorts and general_join outputs).
* ``seg_cache[cols]``  — dense group ids (row-aligned) for grouping by
  ``cols``; only populated when ``cols`` is a prefix of ``sorted_by``.
  Validity-dependent: any op that changes the valid mask must drop it.
* ``build_cache[cols]``— ``(order, sorted_key)`` argsort of this bag as
  a join *build* side on ``cols`` (invalid rows keyed I64_MAX, last).
  Validity-dependent.
* ``partitioning``     — column tuple C such that every VALID row of
  this bag lives on the partition ``mix64(pack_keys(C)) % P`` inside
  the enclosing shard_map region. Only ``dist.DistContext.exchange``
  establishes it; row-local operators preserve it (rows never move
  between partitions locally) as long as the columns of C survive with
  unchanged values. Any exchange whose key columns are a *superset* of
  C is a no-op and is elided (equal keys => equal C-values => same
  partition). Meaningless outside shard_map, where it is simply never
  set.
* ``route_cache[cols]``— ``(order, counts, offsets)`` destination-sort
  routing of this bag for a hash exchange on ``cols`` over the current
  partition count. Validity-dependent (dropped by ``after_mask``); lets
  a dictionary exchanged by several assignments of one query bundle
  argsort its destinations once.
* ``scan_memo``        — per-(alias, with_rowid) memo of ScanP outputs,
  letting repeated scans of one environment bag share a single FlatBag
  instance (and therefore its accumulated caches) across assignments.

Props are *caches*: they are never part of the pytree, so any jit /
shard_map boundary silently drops them (a traced cache must not outlive
its trace) and they are always recomputable from (data, valid).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


class PhysicalProps:
    __slots__ = ("key_cache", "sorted_by", "invalid_last", "seg_cache",
                 "build_cache", "partitioning", "route_cache", "scan_memo")

    def __init__(self,
                 key_cache: Optional[Dict[Tuple[str, ...], object]] = None,
                 sorted_by: Optional[Tuple[str, ...]] = None,
                 invalid_last: bool = False,
                 seg_cache: Optional[Dict[Tuple[str, ...], object]] = None,
                 build_cache: Optional[Dict[Tuple[str, ...], tuple]] = None,
                 partitioning: Optional[Tuple[str, ...]] = None,
                 route_cache: Optional[Dict[Tuple[str, ...], tuple]] = None):
        self.key_cache = key_cache if key_cache is not None else {}
        self.sorted_by = sorted_by
        self.invalid_last = invalid_last
        self.seg_cache = seg_cache if seg_cache is not None else {}
        self.build_cache = build_cache if build_cache is not None else {}
        self.partitioning = partitioning
        self.route_cache = route_cache if route_cache is not None else {}
        self.scan_memo: dict = {}

    # -- derived views -----------------------------------------------------

    def sorted_prefix(self, cols: Tuple[str, ...]) -> bool:
        """Is ``cols`` a delivered ordering (prefix of sorted_by)?"""
        sb = self.sorted_by
        return sb is not None and len(cols) <= len(sb) \
            and sb[:len(cols)] == tuple(cols)

    def partitioned_for(self, cols) -> bool:
        """Would a hash exchange on ``cols`` be a no-op? True when the
        bag is hash-partitioned on a subset of ``cols``: equal values of
        ``cols`` imply equal values of the partitioning columns, hence
        co-location."""
        return self.partitioning is not None \
            and set(self.partitioning) <= set(cols)

    # -- propagation helpers ----------------------------------------------

    def after_mask(self) -> "PhysicalProps":
        """Validity shrank, row order unchanged: keys, sort order and
        partitioning survive (rows do not move); segment/build/route
        caches and invalid-last do not (validity-dependent)."""
        return PhysicalProps(key_cache=dict(self.key_cache),
                             sorted_by=self.sorted_by,
                             invalid_last=False,
                             partitioning=self.partitioning)

    def after_new_columns(self, overwritten) -> "PhysicalProps":
        """Columns in ``overwritten`` were replaced (row alignment and
        validity unchanged): drop every cache entry that mentions them."""
        ov = set(overwritten)

        def keep(cols):
            return not (set(cols) & ov)

        sb = self.sorted_by if (self.sorted_by is not None
                                and keep(self.sorted_by)) else None
        part = self.partitioning if (self.partitioning is not None
                                     and keep(self.partitioning)) else None
        return PhysicalProps(
            key_cache={c: v for c, v in self.key_cache.items() if keep(c)},
            sorted_by=sb,
            invalid_last=self.invalid_last,
            seg_cache={c: v for c, v in self.seg_cache.items()
                       if keep(c)} if sb is not None else None,
            build_cache={c: v for c, v in self.build_cache.items()
                         if keep(c)},
            partitioning=part,
            route_cache={c: v for c, v in self.route_cache.items()
                         if keep(c)})

    def restrict_columns(self, names) -> "PhysicalProps":
        """Only ``names`` survive in the new bag (row alignment and
        validity unchanged)."""
        ns = set(names)

        def keep(cols):
            return set(cols) <= ns

        sb = self.sorted_by if (self.sorted_by is not None
                                and keep(self.sorted_by)) else None
        # a prefix of sorted_by may survive even when the full tuple
        # doesn't: trim to the longest fully-present prefix
        if sb is None and self.sorted_by is not None:
            pref = []
            for c in self.sorted_by:
                if c in ns:
                    pref.append(c)
                else:
                    break
            sb = tuple(pref) if pref else None
        # partitioning survives only when EVERY column survives (the
        # hash mixes all of them; there is no prefix weakening)
        part = self.partitioning if (self.partitioning is not None
                                     and keep(self.partitioning)) else None
        return PhysicalProps(
            key_cache={c: v for c, v in self.key_cache.items() if keep(c)},
            sorted_by=sb,
            invalid_last=self.invalid_last,
            seg_cache={c: v for c, v in self.seg_cache.items()
                       if sb is not None and c == sb[:len(c)]},
            build_cache={c: v for c, v in self.build_cache.items()
                         if keep(c)},
            partitioning=part,
            route_cache={c: v for c, v in self.route_cache.items()
                         if keep(c)})

    def renamed(self, rename) -> "PhysicalProps":
        """Props under a column rename map (ScanP aliasing). Cache
        arrays are shared — renaming never copies data."""

        def rn(cols):
            return tuple(rename.get(c, c) for c in cols)

        return PhysicalProps(
            key_cache={rn(c): v for c, v in self.key_cache.items()},
            sorted_by=rn(self.sorted_by) if self.sorted_by else None,
            invalid_last=self.invalid_last,
            seg_cache={rn(c): v for c, v in self.seg_cache.items()},
            build_cache={rn(c): v for c, v in self.build_cache.items()},
            partitioning=rn(self.partitioning) if self.partitioning
            else None,
            route_cache={rn(c): v for c, v in self.route_cache.items()})
