"""Local (single-partition) columnar operators over FlatBag.

PyTorch twin of ``repro.exec.ops``: the physical counterparts of the
paper's plan-language operators (Fig. 10) under the static-capacity
discipline:

  sigma      -> select            (mask, no compaction)
  pi         -> project / map     (column arithmetic)
  join       -> fk_join           (build side unique — every benchmark join)
                general_join      (M:N, static output capacity + overflow)
  outer-join -> fk_join(how="left_outer")
  Gamma+     -> sum_by            (sort + segment-sum; CUDA kernel inside)
  Gamma_u    -> nest_level        (CSR regroup; labels = dense group ids)
  dedup      -> dedup
  mu         -> flatten_child     (wide flattening, standard route)

Order-awareness: every operator consults and propagates
``FlatBag.props`` instead of re-deriving physical work. Grouping ops
sort *lexicographically by the raw key columns*, so a bag sorted by
(G, A) is also grouped by every prefix. ``SORT_STATS`` counts the sorts
actually performed; ``ORDER_AWARE`` is the global knob that turns the
sharing off (the unfused executor).

With ``use_kernel`` the Gamma tail and the join inner loop route
through ``repro_torch.kernels.ops``: the Hopper kernels for CUDA
tensors, their plain versions for CPU tensors. Operators take their
device from their input tensors.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.columnar.props import PhysicalProps
from repro_torch.columnar.table import FlatBag

from .hashing import combine64

I64_MAX = torch.iinfo(torch.int64).max

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8)


# ---------------------------------------------------------------------------
# physical-property plumbing: knob + sort accounting
# ---------------------------------------------------------------------------

ORDER_AWARE = True   # False => recompute everything per operator (seed mode)

from repro_torch.obs.metrics import REGISTRY as _METRICS  # noqa: E402

SORT_STATS = _METRICS.view("sort")
"""Sort/key-cache accounting — a live view onto the metrics registry
under the ``sort.`` domain (the same counter names as the reference)."""


def reset_sort_stats() -> None:
    SORT_STATS.clear()


def _count(name: str) -> None:
    _METRICS.inc("sort." + name)


@contextmanager
def order_awareness(enabled: bool):
    """Scoped ORDER_AWARE toggle (benchmarks compare fused vs unfused)."""
    global ORDER_AWARE
    prev = ORDER_AWARE
    ORDER_AWARE = enabled
    try:
        yield
    finally:
        ORDER_AWARE = prev


# The reference refuses to cache traced arrays on a concrete bag's props
# (``_cache_ok``); PyTorch runs eagerly, so every tensor is concrete and
# caching on props is always safe.


# ---------------------------------------------------------------------------
# key packing
# ---------------------------------------------------------------------------

def pack_keys(bag: FlatBag, cols: Sequence[str]) -> torch.Tensor:
    """Composite equality key as int64 (see hashing.combine64), cached
    per column tuple on the bag's physical props. Values at invalid
    rows are unspecified — consumers mask by validity."""
    cols = tuple(cols)
    assert cols, "empty key"
    if ORDER_AWARE:
        cached = bag.props.key_cache.get(cols)
        if cached is not None:
            _count("key_reuse")
            return cached
    key = combine64([bag.col(c) for c in cols])
    if ORDER_AWARE:
        bag.props.key_cache[cols] = key
    return key


def _part_if(bag: FlatBag, cols) -> Optional[Tuple[str, ...]]:
    """The bag's hash-partitioning, propagated to an output whose
    columns ``cols`` keep their values."""
    part = bag.props.partitioning if ORDER_AWARE else None
    if part is not None and set(part) <= set(cols):
        return part
    return None


def _key_arrays(bag: FlatBag, cols: Sequence[str]) -> List[torch.Tensor]:
    """Sortable int64 views of key columns. Floats sort by BIT pattern,
    not by truncated value."""
    return [_to_i64_bits(bag.col(c)) for c in cols]


def _is_int(dtype: torch.dtype) -> bool:
    return dtype in _INT_DTYPES


# ---------------------------------------------------------------------------
# sorting / grouping (the shared physical work)
# ---------------------------------------------------------------------------

def _lexsort_order(keys: List[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting by ``keys[0]`` (most significant) ... —
    stable sorts from the least significant key up, so ties keep their
    row order exactly like ``jnp.lexsort``."""
    order = None
    for k in reversed(keys):
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        kk = k if order is None else k[order]
        perm = torch.sort(kk, stable=True).indices
        order = perm if order is None else order[perm]
    return order


def _lexsort(bag: FlatBag, cols: Tuple[str, ...]) -> FlatBag:
    """Sort rows by (invalid-last, cols lexicographic). The result
    delivers ``sorted_by = cols`` with ``invalid_last``."""
    _count("lexsort")
    keys = _key_arrays(bag, cols)
    order = _lexsort_order([~bag.valid] + keys)
    data = {n: a[order] for n, a in bag.data.items()}
    props = PhysicalProps(sorted_by=cols, invalid_last=True,
                          partitioning=_part_if(bag, bag.data)) \
        if ORDER_AWARE else None
    return FlatBag(data, bag.valid[order], props)


def _presorted_seg_ids(bag: FlatBag, cols: Tuple[str, ...]) -> torch.Tensor:
    """Dense int32 group ids for a bag whose VALID rows are already
    clustered by ``cols``. Invalid rows may be interleaved: a valid row
    starts a new segment iff any key column differs from the previous
    *valid* row; invalid rows fold into the running segment."""
    cap = bag.capacity
    dev = bag.device
    idx = torch.arange(cap, device=dev)
    # the last valid row at or before each row (the reference's cummax
    # of where(valid, idx, -1)): the c-th valid row's index, scattered
    # to slot c and read back at each row's running count c. PyTorch's
    # cummax kernel costs more on the GPU than the rest of sum_by.
    count = torch.cumsum(bag.valid, 0)
    nth_valid = torch.full((cap + 1,), -1, dtype=torch.int64,
                           device=dev).scatter(
        0, torch.where(bag.valid, count, 0), torch.where(bag.valid, idx, -1))
    last_valid = nth_valid[count]
    prev_valid = torch.cat([torch.full((1,), -1, dtype=last_valid.dtype,
                                       device=dev), last_valid[:-1]])
    has_prev = prev_valid >= 0
    pv = prev_valid.clamp(0, cap - 1)
    differs = torch.zeros(cap, dtype=torch.bool, device=dev)
    for c in cols:
        # compare the SAME int64 bit-view _lexsort orders by
        a = _to_i64_bits(bag.col(c))
        differs = differs | (a != a[pv])
    seg_start = bag.valid & (~has_prev | differs)
    seg_start[0] = True
    return torch.cumsum(seg_start.to(torch.int32), 0,
                        dtype=torch.int32) - 1


def _segments(bag: FlatBag, key_cols: Sequence[str]
              ) -> Tuple[FlatBag, torch.Tensor]:
    """Cluster rows by ``key_cols``; returns (sorted bag, dense group
    ids). Reuses a delivered ordering when ``key_cols`` is a prefix of
    the bag's ``sorted_by``."""
    cols = tuple(key_cols)
    if ORDER_AWARE and bag.props.sorted_prefix(cols):
        sbag = bag
        cached = sbag.props.seg_cache.get(cols)
        if cached is not None:
            _count("seg_reuse")
            return sbag, cached
        _count("sort_skipped")
    else:
        sbag = _lexsort(bag, cols)
    seg_id = _presorted_seg_ids(sbag, cols)
    if ORDER_AWARE:
        sbag.props.seg_cache[cols] = seg_id
    return sbag, seg_id


def _segment_sum(vals: torch.Tensor, seg_id: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add(0, seg_id.to(torch.int64), vals)


def _masked(bag: FlatBag, v: str) -> torch.Tensor:
    """``where(valid, col, 0)``; a bool column becomes int64, as in
    the reference."""
    return torch.where(bag.valid, bag.col(v), 0)


def _segment_firsts(sbag: FlatBag, seg_id: torch.Tensor, gather_cols,
                    use_kernel: bool, val_cols: Sequence[str] = ()
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """Shared Gamma tail: per segment, (exists, first-row validity,
    first-row values of ``gather_cols``, summed ``val_cols``).

    With ``use_kernel`` this is ONE fused kernel (segment-sum +
    first-row gather). The kernel accumulates in f32, which would
    silently truncate integer sums past 2^24 — so integer value columns
    keep the exact segment-sum path."""
    cap = sbag.capacity
    dev = sbag.device
    if use_kernel:
        from repro_torch.kernels import ops as kops
        fval_cols = [v for v in val_cols if not _is_int(sbag.col(v).dtype)]
        vals = [_masked(sbag, v).to(torch.float32) for v in fval_cols]
        packed = [_to_i64_bits(sbag.col(c)) for c in gather_cols]
        packed.append(sbag.valid.to(torch.int64))
        sums, fidx, fvals = kops.segment_sum_first(
            torch.stack(vals, 1) if vals else
            torch.zeros((cap, 1), dtype=torch.float32, device=dev),
            torch.stack(packed, 1), seg_id, cap)
        exists = fidx < cap
        first_valid = exists & (fvals[:, -1] != 0)
        firsts = {c: _from_i64_bits(fvals[:, i], sbag.col(c).dtype)
                  for i, c in enumerate(gather_cols)}
        summed = {v: sums[:, i].to(sbag.col(v).dtype)
                  for i, v in enumerate(fval_cols)}
        for v in val_cols:
            if v not in summed:
                summed[v] = _segment_sum(_masked(sbag, v), seg_id, cap)
        return exists, first_valid, firsts, summed
    idx = torch.arange(cap, device=dev)
    first = torch.full((cap,), I64_MAX, dtype=torch.int64,
                       device=dev).scatter_reduce(
        0, seg_id.to(torch.int64), idx, "amin")
    first_c = first.clamp(0, cap - 1)
    exists = first < cap
    first_valid = exists & sbag.valid[first_c]
    firsts = {c: sbag.col(c)[first_c] for c in gather_cols}
    summed = {v: _segment_sum(_masked(sbag, v), seg_id, cap)
              for v in val_cols}
    return exists, first_valid, firsts, summed


# ---------------------------------------------------------------------------
# sigma / pi
# ---------------------------------------------------------------------------

def select(bag: FlatBag, mask: torch.Tensor) -> FlatBag:
    return bag.mask(mask)


def project(bag: FlatBag, cols: Dict[str, torch.Tensor]) -> FlatBag:
    """New bag with computed columns (same validity)."""
    return FlatBag(dict(cols), bag.valid)


# ---------------------------------------------------------------------------
# aggregation: Gamma+ (sum_by) and dedup
# ---------------------------------------------------------------------------

def sum_by(bag: FlatBag, key_cols: Sequence[str], val_cols: Sequence[str],
           use_kernel: bool = False) -> FlatBag:
    """Gamma+: group by key_cols, sum val_cols. NULL-semantics: invalid
    rows contribute nothing; groups of only-invalid rows are invalid.
    Output capacity == input capacity. Output delivers
    ``sorted_by = key_cols`` (lexicographic)."""
    key_cols, val_cols = tuple(key_cols), tuple(val_cols)
    sbag, seg_id = _segments(bag, key_cols)
    exists, out_valid, firsts, summed = _segment_firsts(
        sbag, seg_id, key_cols, use_kernel, val_cols)
    data = dict(firsts)
    data.update(summed)
    props = None
    if ORDER_AWARE:
        props = PhysicalProps(sorted_by=key_cols,
                              invalid_last=sbag.props.invalid_last,
                              partitioning=_part_if(sbag, key_cols))
    return FlatBag(data, out_valid, props)


def dedup(bag: FlatBag, cols: Optional[Sequence[str]] = None) -> FlatBag:
    """Keep one representative row per distinct value of ``cols``."""
    cols = tuple(cols or bag.columns)
    sbag, seg_id = _segments(bag, cols)
    prev = torch.cat([torch.full((1,), -1, dtype=seg_id.dtype,
                                 device=seg_id.device), seg_id[:-1]])
    keep = (seg_id != prev) & sbag.valid
    props = None
    if ORDER_AWARE:
        props = PhysicalProps(key_cache=dict(sbag.props.key_cache),
                              sorted_by=sbag.props.sorted_by,
                              invalid_last=False,
                              partitioning=_part_if(sbag, sbag.data))
    return FlatBag(sbag.data, keep, props)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def _build_side(right: FlatBag, right_on: Tuple[str, ...]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, sorted_key) for a join build side, cached on the build
    bag's props so repeated joins against one dictionary argsort once.
    A single-column build side already sorted on its key skips the
    argsort entirely."""
    if ORDER_AWARE:
        hit = right.props.build_cache.get(right_on)
        if hit is not None:
            _count("build_reuse")
            return hit
    rkey = pack_keys(right, right_on)
    rkey = torch.where(right.valid, rkey, I64_MAX)
    # sorted_by order == packed-key order only for a single *integer*
    # key column (floats sort by bit pattern, hashes not at all)
    key_is_int = len(right_on) == 1 and _is_int(
        right.col(right_on[0]).dtype)
    if ORDER_AWARE and key_is_int and right.props.invalid_last \
            and right.props.sorted_prefix(right_on):
        _count("build_sort_skipped")
        order_r = torch.arange(right.capacity, device=right.device)
        srk = rkey
    else:
        _count("build_argsort")
        order_r = torch.argsort(rkey, stable=True)
        srk = rkey[order_r]
    if ORDER_AWARE:
        right.props.build_cache[right_on] = (order_r, srk)
    return order_r, srk


def _to_i64_bits(a: torch.Tensor) -> torch.Tensor:
    """Lossless int64 view of a column (for kernel gathers)."""
    if a.dtype == torch.int64:
        return a
    if a.dtype == torch.float64:
        return a.view(torch.int64)
    if a.dtype == torch.float32:
        return a.view(torch.int32).to(torch.int64)
    return a.to(torch.int64)


def _from_i64_bits(a: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int64:
        return a
    if dtype == torch.float64:
        return a.contiguous().view(torch.float64)
    if dtype == torch.float32:
        return a.to(torch.int32).view(torch.float32)
    return a.to(dtype)


def _gather_columns(arrs: List[torch.Tensor], idx: torch.Tensor,
                    use_kernel: bool) -> List[torch.Tensor]:
    """Gather rows of several columns at ``idx`` (in range). Kernel
    path: one row gather over the columns' int64 bit-views."""
    if not arrs:
        return []
    if not use_kernel:
        return [a[idx] for a in arrs]
    from repro_torch.kernels import ops as kops
    packed = torch.stack([_to_i64_bits(a) for a in arrs], dim=1)
    out = kops.gather_rows(packed, idx)
    return [_from_i64_bits(out[:, i], a.dtype) for i, a in enumerate(arrs)]


def fk_join(left: FlatBag, right: FlatBag, left_on: Sequence[str],
            right_on: Sequence[str], how: str = "inner",
            right_prefix: str = "", use_kernel: bool = False) -> FlatBag:
    """Equi-join where the right (build) side is unique on its key.
    Output rows align with the left side (capacity preserved), so the
    probe side's delivered ordering and key caches carry through.

    how = "inner" | "left_outer". For left_outer, unmatched rows keep
    left validity and get zero-defaults + a ``__matched`` bool column.
    """
    left_on, right_on = tuple(left_on), tuple(right_on)
    cap_r = right.capacity
    order_r, srk = _build_side(right, right_on)
    lkey = pack_keys(left, left_on)

    if use_kernel:
        from repro_torch.kernels import ops as kops
        pos, _ = kops.merge_positions(srk, lkey)
    else:
        pos = torch.searchsorted(srk, lkey, out_int32=True)
    pos_c = pos.clamp(0, cap_r - 1).to(torch.int64)
    ordg, srkg = _gather_columns([order_r, srk], pos_c, use_kernel)
    ridx = ordg
    rnames = [n for n in right.data
              if not (right_prefix + n in left.data and n in right_on)]
    gathered = _gather_columns(
        [right.data[n] for n in rnames] + [right.valid], ridx, use_kernel)
    rvalid = gathered[-1]
    matched = (srkg == lkey) & rvalid & left.valid

    data = dict(left.data)
    for n, g in zip(rnames, gathered[:-1]):
        out_name = right_prefix + n
        if out_name in data:
            raise ValueError(f"join column collision: {out_name}")
        data[out_name] = torch.where(matched, g, torch.zeros_like(g))
    props = None
    if ORDER_AWARE:
        lp = left.props
        props = PhysicalProps(
            key_cache=dict(lp.key_cache), sorted_by=lp.sorted_by,
            invalid_last=lp.invalid_last if how == "left_outer" else False,
            partitioning=_part_if(left, left.data))
    if how == "inner":
        return FlatBag(data, matched, props)
    assert how == "left_outer", how
    data["__matched"] = matched
    return FlatBag(data, left.valid, props)


def general_join(left: FlatBag, right: FlatBag, left_on: Sequence[str],
                 right_on: Sequence[str], out_capacity: int,
                 how: str = "inner", right_prefix: str = "",
                 matched_col: str = "__matched",
                 rowid_col: Optional[str] = None,
                 use_kernel: bool = False
                 ) -> Tuple[FlatBag, torch.Tensor]:
    """M:N equi-join with a static output capacity. Returns (bag,
    overflow): overflow (int32) counts result rows that did not fit.

    how = "left_outer" keeps unmatched left rows (one output row with
    ``__matched`` False). Output rows are left-major, so the probe
    side's delivered ordering carries through (values repeat in place).
    """
    left_on, right_on = tuple(left_on), tuple(right_on)
    cap_r = right.capacity
    dev = left.device
    order_r, srk = _build_side(right, right_on)
    lkey = pack_keys(left, left_on)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        lo, hi = kops.merge_positions(srk, lkey)
    else:
        lo = torch.searchsorted(srk, lkey, side="left", out_int32=True)
        hi = torch.searchsorted(srk, lkey, side="right", out_int32=True)
    # int32 counts and offsets, as the reference computes them
    cnt = torch.where(left.valid, hi - lo, 0)
    if how == "left_outer":
        cnt = torch.where(left.valid & (cnt == 0), 1, cnt)
    offs = torch.cumsum(cnt, 0, dtype=torch.int32)        # inclusive
    start = offs - cnt
    total = offs[-1]

    j = torch.arange(out_capacity, device=dev)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        _, li = kops.merge_positions(offs, j)
    else:
        li = torch.searchsorted(offs.to(torch.int64), j, side="right",
                                out_int32=True)
    li_c = li.clamp(0, left.capacity - 1).to(torch.int64)
    lgather = _gather_columns(
        [left.data[n] for n in left.data] + [start, lo, hi], li_c,
        use_kernel)
    startg, log, hig = lgather[-3:]
    within = j - startg
    has_match = (hig - log) > 0
    ridx_pos = (log + within).clamp(0, cap_r - 1)
    (ridx,) = _gather_columns([order_r], ridx_pos, use_kernel)
    out_valid = j < total

    data = {n: g for n, g in zip(left.data, lgather)}
    rnames = [n for n in right.data
              if not (right_prefix + n in data and n in right_on)]
    rgather = _gather_columns([right.data[n] for n in rnames], ridx,
                              use_kernel)
    for n, g in zip(rnames, rgather):
        out_name = right_prefix + n
        if out_name in data:
            raise ValueError(f"join column collision: {out_name}")
        data[out_name] = torch.where(out_valid & has_match, g,
                                     torch.zeros_like(g))
    if how == "left_outer":
        data[matched_col] = has_match & out_valid
    if rowid_col is not None:
        # the paper's outer-unnest unique ID: one per output tuple
        data[rowid_col] = j.to(torch.int64)
    overflow = torch.clamp(total - out_capacity, min=0)
    props = None
    if ORDER_AWARE:
        props = PhysicalProps(sorted_by=left.props.sorted_by,
                              invalid_last=True,
                              partitioning=_part_if(left, left.data))
    return FlatBag(data, out_valid, props), overflow


# ---------------------------------------------------------------------------
# standard-route flattening (mu / outer-unnest) and nesting (Gamma_u)
# ---------------------------------------------------------------------------

def flatten_child(parent: FlatBag, child: FlatBag, parent_label: str,
                  child_label: str, out_capacity: int,
                  outer: bool = True, matched_col: str = "__matched",
                  rowid_col: Optional[str] = None,
                  use_kernel: bool = False
                  ) -> Tuple[FlatBag, torch.Tensor]:
    """mu / outer-unnest: pair each parent row with its child rows (child
    rows carry ``child_label`` pointing at ``parent_label``), gathering
    ALL parent columns wide onto the result."""
    how = "left_outer" if outer else "inner"
    return general_join(parent, child, [parent_label], [child_label],
                        out_capacity, how=how, matched_col=matched_col,
                        rowid_col=rowid_col, use_kernel=use_kernel)


def nest_level(bag: FlatBag, group_cols: Sequence[str],
               child_cols: Sequence[str], label_col: str,
               child_valid_col: Optional[str] = None,
               use_kernel: bool = False) -> Tuple[FlatBag, FlatBag]:
    """Gamma_u: regroup a wide bag into (parents, children):

      parents  — one row per distinct group_cols, plus ``label_col`` with
                 a fresh dense label (the group id);
      children — child_cols of every input row, plus ``label_col``.

    ``child_valid_col`` (from outer joins) marks rows that represent an
    empty bag: the parent row is kept, the child row is dropped."""
    cap = bag.capacity
    group_cols = tuple(group_cols)
    sbag, seg_id = _segments(bag, group_cols)
    exists, parent_valid, firsts, _ = _segment_firsts(
        sbag, seg_id, group_cols, use_kernel)

    pdata = dict(firsts)
    pdata[label_col] = torch.arange(cap, dtype=torch.int64,
                                    device=bag.device)
    pprops = None
    if ORDER_AWARE:
        pprops = PhysicalProps(sorted_by=group_cols,
                               invalid_last=sbag.props.invalid_last,
                               partitioning=_part_if(sbag, group_cols))
    parents = FlatBag(pdata, parent_valid, pprops)

    label = seg_id.to(torch.int64)
    cdata = {c: sbag.col(c) for c in child_cols}
    cdata[label_col] = label
    child_valid = sbag.valid
    if child_valid_col is not None:
        child_valid = child_valid & sbag.col(child_valid_col)
    cprops = None
    if ORDER_AWARE:
        cprops = PhysicalProps(key_cache={(label_col,): label},
                               sorted_by=(label_col,),
                               invalid_last=False,
                               partitioning=_part_if(sbag, child_cols))
    children = FlatBag(cdata, child_valid, cprops)
    return parents, children


# ---------------------------------------------------------------------------
# set ops
# ---------------------------------------------------------------------------

def union_all(a: FlatBag, b: FlatBag) -> FlatBag:
    from repro_torch.columnar.table import concat_bags
    return concat_bags(a, b)
