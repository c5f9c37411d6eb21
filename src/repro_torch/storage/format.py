"""On-disk format for shredded nested collections (DESIGN.md "Shredded
columnar storage").

A *dataset* directory persists one value-shredded environment — every
part (``R__F`` top bag + ``R__D_<path>`` dictionaries) as fixed-size
column chunks:

    <root>/<dataset>/
        footer.json                  # schema, types, encoders, zone maps
        <part>/<column>/c<i>.npy     # one array per (column, chunk)

Rows on disk are always valid (writers compact before chunking), so no
validity files exist; the reader reconstructs ``valid`` from per-chunk
row counts. The footer carries, per chunk and column, **zone-map
statistics** (min/max over the chunk, distinct count) that the reader
evaluates against pushed-down predicates to skip whole chunks, plus the
``PhysicalProps`` metadata (sort order / partitioning) delivered by the
writer so reopened bags keep their exchange elisions.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import nrc as N
from repro_torch.errors import FooterError
from repro_torch.faults import FAULTS

FORMAT_VERSION = 1
FOOTER = "footer.json"

# column kinds whose zone maps support interval reasoning. Strings and
# labels are dictionary codes — their order is ingest order, not value
# order, so range predicates over them are never used for skipping.
_INTERVAL_KINDS = {"int", "real", "bool", "date"}


# ---------------------------------------------------------------------------
# type (de)serialization
# ---------------------------------------------------------------------------

def type_to_json(t: N.Type) -> dict:
    if isinstance(t, N.ScalarT):
        return {"k": "scalar", "kind": t.kind}
    if isinstance(t, N.LabelT):
        return {"k": "label", "tag": t.tag}
    if isinstance(t, N.TupleT):
        return {"k": "tuple",
                "fields": [[n, type_to_json(ft)] for n, ft in t.fields]}
    if isinstance(t, N.BagT):
        return {"k": "bag", "elem": type_to_json(t.elem)}
    raise TypeError(f"type_to_json: {type(t).__name__}")


def type_from_json(d: dict) -> N.Type:
    k = d["k"]
    if k == "scalar":
        return N.SCALARS[d["kind"]]
    if k == "label":
        return N.LabelT(d["tag"])
    if k == "tuple":
        return N.TupleT(tuple((n, type_from_json(ft))
                              for n, ft in d["fields"]))
    if k == "bag":
        return N.BagT(type_from_json(d["elem"]))
    raise FooterError(f"type_from_json: unknown type tag {k!r}")


def flat_part_schema(ty: N.BagT, path: tuple) -> Dict[str, str]:
    """Columnar schema of the part at ``path`` inside nested type ``ty``
    (the twin of ``codegen.schema_of`` over ``flat_type``); dictionary
    parts additionally carry their ``label`` column."""
    cur: N.Type = ty
    for a in path:
        assert isinstance(cur, N.BagT)
        elem = cur.elem
        assert isinstance(elem, N.TupleT)
        cur = elem.field(a)
    assert isinstance(cur, N.BagT)
    elem = cur.elem
    assert isinstance(elem, N.TupleT)
    out: Dict[str, str] = {}
    if path:
        out["label"] = "label"
    for n, t in elem.fields:
        if isinstance(t, N.BagT):
            out[n] = "label"
        elif isinstance(t, N.ScalarT):
            out[n] = t.kind
        else:
            raise TypeError(f"flat_part_schema: {n!r} has type {t!r}")
    return out


def label_domains(ty: N.BagT, path: tuple) -> Dict[str, tuple]:
    """For the part at ``path``: label-kind column -> the nesting path
    of its label *domain*. The rids of domain ``q`` are assigned one per
    row of the part at ``q[:-1]``, which is what streaming appends use
    to offset label columns (writer.py)."""
    cur: N.Type = ty
    for a in path:
        elem = cur.elem  # type: ignore[union-attr]
        cur = elem.field(a)
    elem = cur.elem  # type: ignore[union-attr]
    out: Dict[str, tuple] = {}
    if path:
        out["label"] = tuple(path)
    for n, t in elem.fields:
        if isinstance(t, N.BagT):
            out[n] = tuple(path) + (n,)
    return out


# ---------------------------------------------------------------------------
# zone maps
# ---------------------------------------------------------------------------

def zone_stats(col: np.ndarray) -> dict:
    """Per-chunk column statistics. ``lo``/``hi`` are inclusive bounds
    over the chunk's rows — kept as exact Python ints for integer
    dtypes (a float bound above 2**53 would round and make skipping
    unsound); ``distinct`` is the exact distinct count (the chunks are
    small enough that a sketch buys nothing); ``runs`` is the
    equal-value run count (bit-pattern equality) the append-time codec
    heuristic reads (``encodings.choose_encoding``)."""
    from .encodings import run_count
    if col.size == 0:
        return {"lo": None, "hi": None, "distinct": 0, "runs": 0}
    runs = run_count(col)
    if col.dtype == np.bool_:
        col = col.astype(np.int8)
    return {"lo": np.min(col).item(), "hi": np.max(col).item(),
            "distinct": int(np.unique(col).size), "runs": runs}


def chunk_crc(col: np.ndarray) -> int:
    """CRC32 over a chunk column's raw bytes — what ``StoredPart.load``
    re-computes under ``verify=True`` to catch torn writes and bit rot
    the row-count check cannot see."""
    return zlib.crc32(np.ascontiguousarray(col).tobytes()) & 0xFFFFFFFF


@dataclass
class ChunkMeta:
    rows: int
    zones: Dict[str, dict]           # column -> zone_stats
    # column -> CRC32 of the chunk's DECODED array bytes. Optional for
    # backward compatibility: footers written before the field verify
    # nothing (empty dict), they do not fail to load.
    crcs: Dict[str, int] = dc_field(default_factory=dict)
    # column -> encoding descriptor (encodings.encode_chunk): codec
    # name, member layout of the uint8 blob, decoded dtype, codec
    # parameters. Columns absent from the dict are raw ``.npy`` chunks
    # — footers written before this field (and all-raw footers) carry
    # no key at all, so old datasets load unchanged. Zone maps stay
    # decoded-domain statistics regardless of codec, so predicate
    # skipping never pays a decode.
    encodings: Dict[str, dict] = dc_field(default_factory=dict)


@dataclass
class PartMeta:
    name: str
    schema: Dict[str, str]           # column -> kind (table.DTYPES keys)
    dtypes: Dict[str, str]           # column -> numpy dtype string
    chunks: List[ChunkMeta] = dc_field(default_factory=list)
    # persisted PhysicalProps contract: delivered orderings survive a
    # round trip because chunks are read back in written row order
    sorted_by: Optional[tuple] = None
    partitioning: Optional[tuple] = None
    # streaming heavy-key sketches (core.skew.HeavyKeySketch JSON), one
    # per integer-kind column — the statistics the automatic skew pass
    # reads (optional: absent on datasets written before the field)
    sketches: Dict[str, dict] = dc_field(default_factory=dict)
    # observed runtime meters fed back by the telemetry layer
    # (obs.feedback, ROADMAP.md queue 1 item 7): measured rows /
    # receive imbalance from actual executions, surfaced to planners
    # through TableStats.meters (optional: absent until serving has
    # recorded an execution)
    meters: Dict[str, float] = dc_field(default_factory=dict)

    @property
    def rows(self) -> int:
        return sum(c.rows for c in self.chunks)

    def to_json(self) -> dict:
        return {"name": self.name, "schema": self.schema,
                "dtypes": self.dtypes,
                "chunks": [dict({"rows": c.rows, "zones": c.zones,
                                 "crcs": c.crcs},
                                **({"encodings": c.encodings}
                                   if c.encodings else {}))
                           for c in self.chunks],
                "sorted_by": list(self.sorted_by) if self.sorted_by
                else None,
                "partitioning": list(self.partitioning)
                if self.partitioning else None,
                "sketches": self.sketches,
                **({"meters": self.meters} if self.meters else {})}

    @staticmethod
    def from_json(d: dict) -> "PartMeta":
        return PartMeta(
            name=d["name"], schema=dict(d["schema"]),
            dtypes=dict(d["dtypes"]),
            chunks=[ChunkMeta(c["rows"], c["zones"],
                              {n: int(v) for n, v in
                               c.get("crcs", {}).items()},
                              dict(c.get("encodings", {})))
                    for c in d["chunks"]],
            sorted_by=tuple(d["sorted_by"]) if d.get("sorted_by") else None,
            partitioning=tuple(d["partitioning"])
            if d.get("partitioning") else None,
            sketches=dict(d.get("sketches", {})),
            meters=dict(d.get("meters", {})))


@dataclass
class DatasetMeta:
    name: str
    chunk_rows: int
    input_types: Dict[str, N.BagT]
    parts: Dict[str, PartMeta] = dc_field(default_factory=dict)
    encoders: Dict[str, List[str]] = dc_field(default_factory=dict)

    def to_json(self) -> dict:
        return {"version": FORMAT_VERSION, "name": self.name,
                "chunk_rows": self.chunk_rows,
                "input_types": {n: type_to_json(t)
                                for n, t in self.input_types.items()},
                "parts": {n: p.to_json() for n, p in self.parts.items()},
                "encoders": self.encoders}

    @staticmethod
    def from_json(d: dict) -> "DatasetMeta":
        if d.get("version") != FORMAT_VERSION:
            raise FooterError(
                f"storage format version {d.get('version')} != "
                f"{FORMAT_VERSION}")
        types = {n: type_from_json(t) for n, t in d["input_types"].items()}
        return DatasetMeta(
            name=d["name"], chunk_rows=int(d["chunk_rows"]),
            input_types=types,
            parts={n: PartMeta.from_json(p) for n, p in d["parts"].items()},
            encoders={c: list(v) for c, v in d.get("encoders", {}).items()})


def write_footer(dirpath: str, meta: DatasetMeta) -> None:
    tmp = os.path.join(dirpath, FOOTER + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta.to_json(), f, indent=1)
    os.replace(tmp, os.path.join(dirpath, FOOTER))


def read_footer(dirpath: str) -> DatasetMeta:
    """Parse the dataset footer. Any failure on this edge — file
    missing, invalid JSON, structural surprises — surfaces as a typed
    ``FooterError`` so a serving layer can fail the one query (or
    dataset) instead of the process. ``storage.footer`` is a fault
    site (kind ``corrupt``)."""
    if FAULTS.enabled and FAULTS.hit("storage.footer", dir=dirpath):
        raise FooterError(f"injected footer corruption: {dirpath}")
    path = os.path.join(dirpath, FOOTER)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FooterError:
        raise
    except (OSError, ValueError) as e:
        raise FooterError(f"unreadable footer {path}: {e}") from e
    try:
        return DatasetMeta.from_json(doc)
    except FooterError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise FooterError(f"malformed footer {path}: {e!r}") from e


def chunk_path(dirpath: str, part: str, col: str, idx: int) -> str:
    return os.path.join(dirpath, part, col, f"c{idx:05d}.npy")


def dir_bytes(path: str) -> int:
    """Total on-disk bytes under ``path`` (footprint reporting)."""
    total = 0
    for dp, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(dp, f))
    return total


# ---------------------------------------------------------------------------
# zone-map predicate evaluation (interval arithmetic, three-valued)
# ---------------------------------------------------------------------------

def _interval(e: N.Expr, zones: Dict[str, dict], schema: Dict[str, str],
              params: Optional[dict]) -> Optional[Tuple[float, float]]:
    """Inclusive [lo, hi] bound of a scalar expression over the chunk's
    rows, or None when unknown."""
    if isinstance(e, N.Var):
        if schema.get(e.name) not in _INTERVAL_KINDS:
            return None
        z = zones.get(e.name)
        if z is None or z["lo"] is None:
            return None
        return (z["lo"], z["hi"])
    if isinstance(e, N.Const):
        if isinstance(e.value, (int, float)):    # bool is an int
            return (e.value, e.value)
        return None
    if isinstance(e, N.Param):
        v = (params or {}).get(e.name, e.default)
        if isinstance(v, (int, float)):
            # exact Python arithmetic: int bounds above 2**53 must not
            # round through float
            return (v, v)
        return None
    if isinstance(e, N.Arith):
        l = _interval(e.left, zones, schema, params)
        r = _interval(e.right, zones, schema, params)
        if l is None or r is None:
            return None
        if e.op == "+":
            return (l[0] + r[0], l[1] + r[1])
        if e.op == "-":
            return (l[0] - r[1], l[1] - r[0])
        if e.op == "*":
            prods = [l[0] * r[0], l[0] * r[1], l[1] * r[0], l[1] * r[1]]
            return (min(prods), max(prods))
        return None     # division: the evaluator guards zero — no bound
    return None


def _tristate(e: N.Expr, zones: Dict[str, dict], schema: Dict[str, str],
              params: Optional[dict]) -> Optional[bool]:
    """True = every row of the chunk satisfies ``e``; False = no row
    can; None = undecided (the chunk must be read)."""
    if isinstance(e, N.Cmp):
        l = _interval(e.left, zones, schema, params)
        r = _interval(e.right, zones, schema, params)
        if l is None or r is None:
            return None
        if e.op in ("<", "<="):
            strict = e.op == "<"
            if (l[1] < r[0]) or (not strict and l[1] <= r[0]):
                return True
            if (l[0] > r[1]) or (strict and l[0] >= r[1]):
                return False
            return None
        if e.op in (">", ">="):
            return _tristate(N.Cmp("<" if e.op == ">" else "<=",
                                   e.right, e.left), zones, schema, params)
        if e.op == "==":
            if l[0] == l[1] == r[0] == r[1]:
                return True
            if l[1] < r[0] or r[1] < l[0]:
                return False
            return None
        if e.op == "!=":
            t = _tristate(N.Cmp("==", e.left, e.right), zones, schema,
                          params)
            return None if t is None else not t
        return None
    if isinstance(e, N.BoolOp):
        l = _tristate(e.left, zones, schema, params)
        r = _tristate(e.right, zones, schema, params)
        if e.op == "&&":
            if l is False or r is False:
                return False
            if l is True and r is True:
                return True
            return None
        if l is True or r is True:
            return True
        if l is False and r is False:
            return False
        return None
    if isinstance(e, N.Not):
        t = _tristate(e.inner, zones, schema, params)
        return None if t is None else not t
    if isinstance(e, N.Const) and isinstance(e.value, bool):
        return e.value
    return None


def chunk_may_match(pred: N.Expr, zones: Dict[str, dict],
                    schema: Dict[str, str],
                    params: Optional[dict] = None) -> bool:
    """Conservative zone-map test: False ONLY when no row of the chunk
    can satisfy ``pred`` — the one case where skipping is sound."""
    return _tristate(pred, zones, schema, params) is not False
