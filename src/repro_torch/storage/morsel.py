"""Morsel planning for out-of-core streamed execution (PyTorch twin of
``repro.storage.morsel``; DESIGN.md "Compressed chunks and morsel
streaming").

A *morsel* is a chunk-aligned window over one streamed input root: a
contiguous row interval of the root's TOP part plus, for every
descendant dictionary part, exactly the rows whose label chain leads
into that interval. Because the streaming append path assigns label
rids sequentially (one per parent row, in parent order — writer.py),
each dictionary part's ``label`` column is a globally non-decreasing
parent-rid sequence; a parent row interval ``[pa, pb)`` therefore maps
to the child row interval ``[first label >= pa, first label >= pb)``,
found from zone maps plus one boundary-chunk read. The windows of all
parts tile the dataset exactly, and every parent row is co-resident
with ALL its children, so label-equality joins inside a morsel see
exactly the one-shot pairs (``plans.morsel_fold`` handles the
re-fold of each program output).

Datasets whose label columns are NOT monotone parent rids (e.g.
``write_parts`` bundles persisting combine64 label values) fail the
zone-map monotonicity / coverage checks with a typed
``StreamingUnsupportedError`` — the caller falls back to one-shot.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.columnar.table import FlatBag
from repro_torch.core import nrc as N
from repro_torch.core.materialization import mat_input_name
from repro_torch.errors import StreamingUnsupportedError

from .reader import StoredDataset, StoredPart
from .writer import _all_paths


def _pow2(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


@dataclass
class MorselWindow:
    chunks: List[int]        # chunk indices overlapping the interval
    lo: int                  # global row interval [lo, hi) owned by
    hi: int                  # this morsel (boundary chunks are masked)


@dataclass
class MorselPlan:
    root: str                            # streamed NRC input name
    parts: List[str]                     # streamed part names (by depth)
    caps: Dict[str, int]                 # per part: capacity class that
    #                                      holds every morsel's loaded rows
    morsels: List[Dict[str, MorselWindow]]

    @property
    def n_morsels(self) -> int:
        return len(self.morsels)


def _label_cuts(sp: StoredPart, parent_cuts: List[int]) -> List[int]:
    """Row positions of ``first row with label >= v`` for every parent
    cut ``v`` — the child-part images of the parent row boundaries.
    Requires the label column globally non-decreasing (zone maps across
    chunks, exact order inside the boundary chunks read here)."""
    chunks = sp.meta.chunks
    zones = [c.zones.get("label") for c in chunks]
    if any(z is None for z in zones):
        raise StreamingUnsupportedError(
            f"{sp.name}: no label zone maps (pre-zone-map footer?)")
    los = [z["lo"] for z in zones]
    his = [z["hi"] for z in zones]
    for i in range(len(chunks) - 1):
        if his[i] > los[i + 1]:
            raise StreamingUnsupportedError(
                f"{sp.name}: label chunks {i}/{i + 1} overlap "
                f"({his[i]} > {los[i + 1]}) — labels are not a "
                f"monotone parent-rid sequence")
    offs = np.concatenate([[0], np.cumsum([c.rows for c in chunks])])
    total = int(offs[-1])
    cache: Dict[int, np.ndarray] = {}

    def labels(i: int) -> np.ndarray:
        if i not in cache:
            a = sp._load_chunk("label", i, verify=False, count=False)
            if torch.is_tensor(a):      # decoded on the card
                a = a.cpu().numpy()
            if a.size > 1 and np.any(np.diff(a) < 0):
                raise StreamingUnsupportedError(
                    f"{sp.name}: labels unsorted inside chunk {i}")
            cache[i] = a
        return cache[i]

    cuts = []
    for v in parent_cuts:
        i = bisect_left(his, v)          # first chunk with hi >= v
        if i == len(chunks):
            cuts.append(total)
        else:
            cuts.append(int(offs[i])
                        + int(np.searchsorted(labels(i), v, side="left")))
    if cuts and (cuts[0] != 0 or cuts[-1] != total):
        raise StreamingUnsupportedError(
            f"{sp.name}: label values do not cover the parent rid "
            f"range (cuts {cuts[0]}..{cuts[-1]} vs rows 0..{total}) — "
            f"write_parts bundles persist label values verbatim and "
            f"cannot stream")
    return cuts


def _windows(sp: StoredPart, cuts: List[int]) -> List[MorselWindow]:
    offs = np.concatenate(
        [[0], np.cumsum([c.rows for c in sp.meta.chunks])])
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        sel = [i for i in range(len(sp.meta.chunks))
               if offs[i] < hi and offs[i + 1] > lo]
        out.append(MorselWindow(chunks=sel, lo=int(lo), hi=int(hi)))
    return out


def plan_morsels(dataset: StoredDataset, root: str,
                 morsel_rows: int) -> MorselPlan:
    """Chunk-aligned morsel windows over input root ``root``: the top
    part is split at chunk boundaries into runs of ~``morsel_rows``
    rows (every run at least one chunk), then each dictionary part's
    windows follow by mapping its parent's row boundaries through the
    label column."""
    assert morsel_rows > 0
    ty = dataset.input_types.get(root)
    assert ty is not None, (
        f"plan_morsels: {root!r} is not an input root of "
        f"{sorted(dataset.input_types)}")
    paths = sorted(_all_paths(ty), key=len)
    names = {p: mat_input_name(root, p) for p in paths}
    top = dataset.parts[names[()]]

    # top-part cuts: greedy chunk runs of ~morsel_rows
    cuts_top = [0]
    acc = 0
    for c in top.meta.chunks:
        acc += c.rows
        if acc >= morsel_rows:
            cuts_top.append(cuts_top[-1] + acc)
            acc = 0
    if acc or len(cuts_top) == 1:
        cuts_top.append(cuts_top[-1] + acc)

    cuts: Dict[tuple, List[int]] = {(): cuts_top}
    for p in paths:
        if p:
            cuts[p] = _label_cuts(dataset.parts[names[p]], cuts[p[:-1]])

    morsel_count = len(cuts_top) - 1
    windows = {p: _windows(dataset.parts[names[p]], cuts[p])
               for p in paths}
    caps = {}
    for p in paths:
        sp = dataset.parts[names[p]]
        rows = [c.rows for c in sp.meta.chunks]
        worst = max((sum(rows[i] for i in w.chunks)
                     for w in windows[p]), default=0)
        caps[names[p]] = _pow2(max(worst, 1))
    morsels = [{names[p]: windows[p][k] for p in paths}
               for k in range(morsel_count)]
    return MorselPlan(root=root, parts=[names[p] for p in paths],
                      caps=caps, morsels=morsels)


def load_morsel_window(part: StoredPart, win: MorselWindow,
                       columns: Optional[set], capacity: int,
                       pred: Optional[N.Expr] = None,
                       params: Optional[dict] = None,
                       verify: bool = False) -> FlatBag:
    """Materialize one part's morsel window: the window's chunks
    (intersected with zone-map predicate survivors — chunk skipping
    composes with streaming), rows outside the owned global-rid
    interval masked invalid. Always loaded at the plan's pinned
    ``capacity`` so ONE compiled executable serves every morsel."""
    sel = win.chunks
    if pred is not None:
        keep = set(part.select_chunks(pred, params))
        sel = [i for i in sel if i in keep]
    bag = part.load(columns=sorted(columns) if columns is not None
                    else None,
                    chunks=sel, capacity=capacity, verify=verify)
    offs = np.concatenate(
        [[0], np.cumsum([c.rows for c in part.meta.chunks])])
    # the global row ids of the loaded rows, built on the bag's device
    dev = bag.device
    rid_parts = [torch.arange(int(offs[i]), int(offs[i + 1]),
                              dtype=torch.int64, device=dev) for i in sel]
    rid = torch.cat(rid_parts) if rid_parts \
        else torch.zeros(0, dtype=torch.int64, device=dev)
    keep_rows = torch.zeros(capacity, dtype=torch.bool, device=dev)
    keep_rows[:rid.shape[0]] = (rid >= win.lo) & (rid < win.hi)
    return bag.mask(keep_rows)
