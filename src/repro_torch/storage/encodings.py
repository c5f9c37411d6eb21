"""Lightweight per-chunk column encodings (DESIGN.md "Compressed
chunks and morsel streaming").

Four codecs in the classic columnar family (the Dremel/BigQuery
lineage), each with an exact, bit-for-bit round trip:

* ``rle``     — run-length: (values, run lengths). Runs are detected on
  the *bit pattern* (floats compare via their int64 view), so ``-0.0``
  and ``NaN`` payloads survive unchanged.
* ``delta``   — delta + zigzag: consecutive differences in modular
  int64 arithmetic, zigzag-folded to small unsigned ints and stored at
  the narrowest width that holds the largest delta. Wraparound makes
  the round trip exact even across int64 extremes.
* ``bitpack`` — frame-of-reference bit-packing: ``value - lo`` packed
  ``k`` bits each into uint32 words, ``vpw = 32 // k`` values per word
  (values never straddle a word, so decode is one shift+mask).
* ``dict``    — dictionary: sorted distinct values + per-row codes at
  the narrowest code width.

A chunk's encoded form is ONE flat ``uint8`` blob saved through the
ordinary ``.npy`` chunk file (same path, same single-file atomicity,
no zip container overhead); member arrays are packed at 8-byte-aligned
offsets recorded in the footer's per-chunk encoding descriptor, so the
reader reconstructs them as zero-copy views of the mmap.

``choose_encoding`` is the DatasetWriter's append-time heuristic. It
reads the run/distinct counts the zone-map machinery already computed
and picks the first codec whose estimated payload wins by >= 2x over
raw — the shredded label columns (sorted, repetitive by construction —
Cheney et al.'s query shredding) land on ``rle``/``delta``, random fk
columns on ``bitpack``, low-cardinality measures on ``dict``, and
everything else stays ``raw`` (no descriptor: footers are byte-wise
unchanged for incompressible data, and old footers keep loading).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["choose_encoding", "encode_chunk", "decode_chunk",
           "payload_rows", "unpack_members", "run_count"]

# estimated payload must beat raw by this factor before a codec is
# chosen — decode work is only worth paying when the byte win is real
MIN_WIN = 2.0


# ---------------------------------------------------------------------------
# zigzag / bit-view helpers (all exact, modular int64)
# ---------------------------------------------------------------------------

def _bitview_i64(a: np.ndarray) -> np.ndarray:
    """Bit-pattern view for run detection: floats compare as raw bits
    (distinguishing -0.0/0.0 and NaN payloads), everything else
    compares as itself."""
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)
    return a


def run_count(a: np.ndarray) -> int:
    """Number of equal-value runs (bit-pattern equality)."""
    if a.size == 0:
        return 0
    v = _bitview_i64(a)
    return 1 + int(np.count_nonzero(v[1:] != v[:-1]))


def _zigzag(d: np.ndarray) -> np.ndarray:
    """int64 deltas -> uint64 zigzag (small magnitudes -> small codes);
    the shifts wrap modularly, matching ``_unzigzag`` exactly."""
    d = d.astype(np.int64, copy=False)
    with np.errstate(over="ignore"):
        return ((d << np.int64(1)) ^ (d >> np.int64(63))).view(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    u = z.astype(np.uint64, copy=False)
    return ((u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1)))
            ).view(np.int64)


def _narrow_uint(maxval: int) -> np.dtype:
    for dt in (np.uint8, np.uint16, np.uint32):
        if maxval <= np.iinfo(dt).max:
            return np.dtype(dt)
    return np.dtype(np.uint64)


# ---------------------------------------------------------------------------
# blob packing: named members at 8-byte-aligned offsets in one uint8 npy
# ---------------------------------------------------------------------------

def _pack_members(members: Dict[str, np.ndarray]
                  ) -> Tuple[list, np.ndarray]:
    """(member table, blob). Table rows: [name, dtype str, count,
    byte offset] — JSON-serializable, persisted in the chunk's
    encoding descriptor."""
    table = []
    off = 0
    pieces = []
    for name in sorted(members):
        a = np.ascontiguousarray(members[name])
        pad = (-off) % 8
        if pad:
            pieces.append(np.zeros(pad, np.uint8))
            off += pad
        table.append([name, str(a.dtype), int(a.size), off])
        pieces.append(a.view(np.uint8).reshape(-1))
        off += a.nbytes
    blob = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    return table, blob


def unpack_members(enc: dict, blob: np.ndarray) -> Dict[str, np.ndarray]:
    """Zero-copy member views of an encoded chunk blob."""
    blob = np.ascontiguousarray(blob).view(np.uint8).reshape(-1)
    out = {}
    for name, dts, count, off in enc["members"]:
        dt = np.dtype(dts)
        nb = int(count) * dt.itemsize
        out[name] = blob[int(off):int(off) + nb].view(dt)
    return out


# ---------------------------------------------------------------------------
# per-codec encode
# ---------------------------------------------------------------------------

def _enc_rle(a: np.ndarray) -> Tuple[dict, Dict[str, np.ndarray]]:
    v = _bitview_i64(a)
    if a.size == 0:
        starts = np.zeros(0, np.int64)
    else:
        starts = np.concatenate(
            [[0], np.flatnonzero(v[1:] != v[:-1]) + 1]).astype(np.int64)
    lengths = np.diff(np.concatenate([starts, [a.size]])).astype(np.int32)
    return {"codec": "rle"}, {"values": a[starts.astype(np.intp)],
                              "lengths": lengths}


def _enc_delta(a: np.ndarray) -> Tuple[dict, Dict[str, np.ndarray]]:
    assert a.dtype.kind in "iub", a.dtype
    w = a.astype(np.int64, copy=False)
    # deltas in modular int64 (wraparound keeps int64 extremes exact);
    # delta[0] == 0 so decode is first + inclusive-cumsum over n deltas
    d = np.zeros(a.size, np.int64)
    if a.size > 1:
        with np.errstate(over="ignore"):
            d[1:] = (w.view(np.uint64)[1:]
                     - w.view(np.uint64)[:-1]).view(np.int64)
    z = _zigzag(d)
    width = _narrow_uint(int(z.max())) if z.size else np.dtype(np.uint8)
    first = int(w.view(np.uint64)[0]) if a.size else 0
    return ({"codec": "delta", "first": first, "w": str(width)},
            {"deltas": z.astype(width)})


def _enc_bitpack(a: np.ndarray) -> Tuple[dict, Dict[str, np.ndarray]]:
    assert a.dtype.kind in "iub", a.dtype
    w = a.astype(np.int64, copy=False)
    lo = int(w.min()) if a.size else 0
    span = (int(w.max()) - lo) if a.size else 0
    k = max(1, int(span).bit_length())
    assert k <= 16, f"bitpack span needs {k} bits (> 16)"
    vpw = 32 // k
    rel = (w - lo).astype(np.uint32)
    nw = -(-a.size // vpw) if a.size else 0
    rel = np.pad(rel, (0, nw * vpw - a.size))
    shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(k))
    words = np.bitwise_or.reduce(
        rel.reshape(nw, vpw) << shifts[None, :], axis=1).astype(np.uint32)
    return ({"codec": "bitpack", "lo": lo, "k": k, "vpw": vpw,
             "n": int(a.size)}, {"words": words})


def _enc_dict(a: np.ndarray) -> Tuple[dict, Dict[str, np.ndarray]]:
    v = _bitview_i64(a)
    vals, codes = np.unique(v, return_inverse=True)
    width = _narrow_uint(max(int(vals.size) - 1, 0))
    return ({"codec": "dict"},
            {"values": vals.view(a.dtype), "codes": codes.astype(width)})


_ENCODERS = {"rle": _enc_rle, "delta": _enc_delta,
             "bitpack": _enc_bitpack, "dict": _enc_dict}


def encode_chunk(a: np.ndarray, codec: str) -> Tuple[dict, np.ndarray]:
    """Encode one chunk column. Returns (descriptor, uint8 blob); the
    descriptor (JSON-serializable) goes into ``ChunkMeta.encodings``
    and carries everything decode needs beyond the blob."""
    enc, members = _ENCODERS[codec](np.ascontiguousarray(a))
    table, blob = _pack_members(members)
    enc["members"] = table
    enc["dtype"] = str(a.dtype)
    return enc, blob


# ---------------------------------------------------------------------------
# decode (host / NumPy — the exact reference the CUDA kernels match)
# ---------------------------------------------------------------------------

def payload_rows(enc: dict, members: Dict[str, np.ndarray]) -> int:
    """Decoded row count, derived from the payload itself (not the
    footer) so the reader's row-count integrity check still catches
    torn encoded chunks."""
    c = enc["codec"]
    if c == "rle":
        return int(members["lengths"].sum())
    if c == "delta":
        return int(members["deltas"].size)
    if c == "bitpack":
        return int(enc["n"])
    if c == "dict":
        return int(members["codes"].size)
    raise ValueError(f"unknown codec {c!r}")


def decode_chunk(enc: dict, blob: np.ndarray) -> np.ndarray:
    """Exact decode of one encoded chunk blob to its original array."""
    dtype = np.dtype(enc["dtype"])
    m = unpack_members(enc, blob)
    c = enc["codec"]
    if c == "rle":
        return np.repeat(m["values"], m["lengths"]).astype(dtype,
                                                           copy=False)
    if c == "delta":
        z = m["deltas"]
        d = _unzigzag(z)
        with np.errstate(over="ignore"):
            out = (np.uint64(enc["first"])
                   + np.cumsum(d.view(np.uint64), dtype=np.uint64))
        out = out.view(np.int64)
        if dtype == np.bool_:
            return out != 0
        return out.astype(dtype, copy=False)
    if c == "bitpack":
        k, vpw, n = enc["k"], enc["vpw"], enc["n"]
        words = m["words"].astype(np.uint32, copy=False)
        rep = np.repeat(words, vpw)[:n]
        pos = (np.arange(n, dtype=np.uint32) % np.uint32(vpw))
        vals = (rep >> (pos * np.uint32(k))) \
            & np.uint32((1 << k) - 1)
        out = vals.astype(np.int64) + np.int64(enc["lo"])
        if dtype == np.bool_:
            return out != 0
        return out.astype(dtype, copy=False)
    if c == "dict":
        return m["values"][m["codes"].astype(np.intp)]
    raise ValueError(f"unknown codec {c!r}")


# ---------------------------------------------------------------------------
# append-time codec selection
# ---------------------------------------------------------------------------

def choose_encoding(a: np.ndarray, zstats: dict) -> Optional[str]:
    """Pick a codec for one chunk column from the zone-map statistics
    (``runs``/``distinct`` — already computed by ``zone_stats``), or
    None for raw. First codec whose estimated payload beats raw by
    ``MIN_WIN`` wins; estimation is bytes-only, so the decision costs
    no extra pass over the data."""
    n = int(a.size)
    if n < 8:
        return None
    raw_b = a.nbytes
    item = a.dtype.itemsize
    runs = int(zstats.get("runs") or run_count(a))
    distinct = int(zstats.get("distinct", n))
    if runs * (item + 4) * MIN_WIN <= raw_b:
        return "rle"
    intlike = a.dtype.kind in "iub"
    if intlike and n > 1:
        w = a.astype(np.int64, copy=False)
        with np.errstate(over="ignore"):
            d = (w.view(np.uint64)[1:] - w.view(np.uint64)[:-1]
                 ).view(np.int64)
        zmax = int(_zigzag(d).max()) if d.size else 0
        width = _narrow_uint(zmax).itemsize
        if n * width * MIN_WIN <= raw_b:
            return "delta"
        lo, hi = zstats.get("lo"), zstats.get("hi")
        if lo is not None:
            span = int(hi) - int(lo)
            if 0 <= span and span.bit_length() <= 16:
                k = max(1, span.bit_length())
                if (-(-n // (32 // k))) * 4 * MIN_WIN <= raw_b:
                    return "bitpack"
    code_w = _narrow_uint(max(distinct - 1, 0)).itemsize
    if (distinct * item + n * code_w) * MIN_WIN <= raw_b:
        return "dict"
    return None
