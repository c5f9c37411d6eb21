"""Reader for the shredded columnar storage format (PyTorch twin of
``repro.storage.reader``).

``StoredPart.load`` reads ONLY the requested columns and ONLY the
requested chunks, reassembling a ``FlatBag`` at a chosen capacity with
the persisted ``PhysicalProps`` (sort order / partitioning) re-attached
— chunks come back in written row order, so a persisted ``sorted_by``
still holds after skipping arbitrary chunks.

Every column is a ``(capacity,)`` tensor on the dataset's device
(``StoredDataset(dirpath, device=None)``; None means the GPU, as for
the other entry points). On the CPU a chunk is read and decoded with
NumPy (``encodings.decode_chunk``). On the card the encoded chunk's
bytes are staged through pinned host memory and copied as stored — the
members cross the wire at their stored widths — and the decode kernels
(``kernels.ops.rle_expand`` / ``delta_unpack`` / ``bitunpack`` /
``dict_gather``) expand them straight into the chunk's slice of the
device column. A raw chunk is copied into its slice the same way.

All load activity is metered in ``STORAGE_STATS`` (chunks read/skipped,
columns read/pruned, bytes read), with the reference's names and values.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.columnar.props import PhysicalProps
from repro_torch.columnar.table import FlatBag, StringEncoder, resolve_device
from repro_torch.core import nrc as N
from repro_torch.errors import ChunkCorruptionError, MissingChunkError
from repro_torch.faults import FAULTS

from . import encodings as E
from .format import (DatasetMeta, PartMeta, chunk_crc, chunk_may_match,
                     chunk_path, dir_bytes, read_footer)

from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.trace import span as _span

STORAGE_STATS = _METRICS.view("storage")
"""Host-side scan counters — live view onto the metrics registry under
the ``storage.`` domain: ``chunks_read`` / ``chunks_skipped`` (zone
maps), ``columns_read`` / ``columns_pruned`` (projection pushdown),
``parts_loaded``, and the byte ledger — ``bytes_read`` is bytes that
actually came off disk (encoded chunks count their compressed blob, NOT
the decoded rows), ``bytes_decoded`` / ``chunks_decoded`` / ``decode_us``
meter the decode stage of encoded chunks.

On the CPU ``decode_us`` is the NumPy decode time, as in the reference.
On the card it is the host time of the decode stage: staging the blob
in pinned memory and enqueueing its copy and its kernel. The copy and
the kernel run asynchronously on the current stream and are not in it
(the profile in ``chip_smoke.py`` phase D gives the device time)."""


def reset_storage_stats() -> None:
    STORAGE_STATS.clear()


def _count(name: str, n: int = 1) -> None:
    _METRICS.inc("storage." + name, n)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


# ---------------------------------------------------------------------------
# the device decode path
# ---------------------------------------------------------------------------

def _check_members(enc: dict, blob: np.ndarray) -> int:
    """Check an encoded chunk's members on the host so that a kernel
    can trust them; return the decoded row count (from the payload,
    never the footer). Raises ``ChunkCorruptionError`` on a member that
    runs past the blob, on runs shorter than one row, on a dictionary
    code outside the dictionary or on too few bit-packed words — the
    cases where ``encodings.decode_chunk`` raises."""
    blob = np.ascontiguousarray(blob).view(np.uint8).reshape(-1)
    for name, dts, count, off in enc["members"]:
        end = int(off) + int(count) * np.dtype(dts).itemsize
        if end > blob.shape[0]:
            raise ChunkCorruptionError(
                f"member {name!r} ends at byte {end} of a "
                f"{blob.shape[0]}-byte blob")
    m = E.unpack_members(enc, blob)
    c = enc["codec"]
    if c == "rle":
        if m["lengths"].size and int(m["lengths"].min()) < 1:
            raise ChunkCorruptionError("a run shorter than one row")
        if m["lengths"].size != m["values"].size:
            raise ChunkCorruptionError(
                f"{m['values'].size} run values, "
                f"{m['lengths'].size} run lengths")
    elif c == "dict":
        if m["codes"].size and int(m["codes"].max()) >= m["values"].size:
            raise ChunkCorruptionError("a code outside the dictionary")
    elif c == "bitpack":
        if m["words"].size * int(enc["vpw"]) < int(enc["n"]):
            raise ChunkCorruptionError(
                f"{m['words'].size} words cannot hold {enc['n']} values")
    elif c != "delta":
        raise ChunkCorruptionError(f"unknown codec {c!r}")
    return E.payload_rows(enc, m)


def _stage(blob: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy an encoded chunk's bytes to ``device`` in one transfer. On
    the card the blob goes through a pinned buffer and the copy is
    asynchronous (PyTorch's pinned allocator keeps the buffer until the
    copy has run)."""
    blob = np.ascontiguousarray(blob).view(np.uint8).reshape(-1)
    pin = device.type == "cuda"
    host = torch.empty((max(blob.nbytes, 1),), dtype=torch.uint8,
                       pin_memory=pin)
    host.numpy()[:blob.nbytes] = blob
    dev = host.to(device, non_blocking=True) if pin else host
    return dev[:blob.nbytes]


def _as_i64(t: torch.Tensor) -> torch.Tensor:
    """int64 bit-view of a member (8-byte dtypes) or its widening."""
    return t.view(torch.int64) if t.element_size() == 8 \
        else t.to(torch.int64)


def _launch_decode(enc: dict, blob: np.ndarray, rows: int,
                   device: torch.device,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy a checked encoded chunk to ``device`` as stored and decode
    it with the kernels into ``out`` (allocated when None): a
    ``(rows,)`` tensor of the chunk's dtype."""
    from repro_torch.kernels import ops as K
    dtype = np.dtype(enc["dtype"])
    if dtype.kind == "f" and dtype.itemsize != 8:
        raise TypeError(f"device decode: {dtype} columns are not supported")
    if out is None:
        out = torch.empty((rows,), dtype=_torch_dtype(dtype), device=device)
    wide = out.element_size() == 8
    out64 = out.view(torch.int64) if wide \
        else torch.empty((rows,), dtype=torch.int64, device=device)
    blob_dev = _stage(blob, device)
    m = {}
    for name, dts, count, off in enc["members"]:
        nb = int(count) * np.dtype(dts).itemsize
        m[name] = blob_dev[int(off):int(off) + nb].view(
            _torch_dtype(np.dtype(dts)))
    c = enc["codec"]
    if c == "rle":
        K.rle_expand(_as_i64(m["values"]), m["lengths"], rows, out=out64)
    elif c == "delta":
        K.delta_unpack(m["deltas"], int(enc["first"]), out=out64)
    elif c == "bitpack":
        K.bitunpack(m["words"], int(enc["k"]), int(enc["vpw"]), rows,
                    int(enc["lo"]), out=out64)
    else:
        K.dict_gather(_as_i64(m["values"]), m["codes"], out=out64)
    if not wide:
        out.copy_(out64 != 0 if dtype == np.bool_ else out64)
    return out


def _decode_device(enc: dict, blob: np.ndarray, device=None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode one encoded chunk blob on ``device`` (None = the GPU)
    through the kernels; bit for bit ``encodings.decode_chunk``. A CPU
    device runs the kernels' plain versions."""
    rows = _check_members(enc, blob)
    return _launch_decode(enc, blob, rows, resolve_device(device), out)


def restore_encoders(meta: DatasetMeta, strict: bool = True
                     ) -> Dict[str, StringEncoder]:
    """Rebuild the per-column string encoders exactly as persisted. The
    storage reader hands out STRICT encoders: decoding a code outside
    the persisted vocabulary raises instead of fabricating ``"<code>"``
    (a wrong code coming off disk is corruption, not a display issue)."""
    return {col: StringEncoder.from_vocab(rev, strict=strict)
            for col, rev in meta.encoders.items()}


@dataclass
class StoredPart:
    dirpath: str                # dataset directory
    meta: PartMeta
    device: Optional[torch.device] = None   # None = the GPU

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def rows(self) -> int:
        return self.meta.rows

    @property
    def n_chunks(self) -> int:
        return len(self.meta.chunks)

    @property
    def columns(self) -> List[str]:
        return sorted(self.meta.schema)

    def bytes_on_disk(self) -> int:
        return dir_bytes(os.path.join(self.dirpath, self.meta.name))

    # -- planner statistics -------------------------------------------------
    def stats(self):
        """``skew.TableStats`` for this part: total rows, per-column
        distinct-count upper bounds from chunk zone maps, and the
        persisted streaming heavy-key sketch candidates.

        Summing per-chunk distinct counts is sound but overcounts keys
        repeated across chunks. For integer columns the zone maps carry
        exact ``lo``/``hi`` bounds, so the value-range width is a second
        sound upper bound; the minimum of the two (and the row count) is
        reported."""
        from repro_torch.core.skew import HeavyKeySketch, TableStats
        distinct = {}
        lo: Dict[str, int] = {}
        hi: Dict[str, int] = {}
        ranged: Dict[str, bool] = {}
        for c in self.meta.chunks:
            for col, z in c.zones.items():
                distinct[col] = distinct.get(col, 0) + int(z["distinct"])
                zl, zh = z.get("lo"), z.get("hi")
                if (ranged.get(col, True) and isinstance(zl, int)
                        and isinstance(zh, int)):
                    ranged[col] = True
                    lo[col] = zl if col not in lo else min(lo[col], zl)
                    hi[col] = zh if col not in hi else max(hi[col], zh)
                elif zl is not None:
                    ranged[col] = False       # float column: no range bound
        for col, d in distinct.items():
            d = min(d, self.rows)
            if ranged.get(col) and col in lo:
                d = min(d, hi[col] - lo[col] + 1)
            distinct[col] = d
        heavy = {}
        for col, sj in self.meta.sketches.items():
            sk = HeavyKeySketch.from_json(sj)
            heavy[col] = [(v, cnt) for v, cnt in sk.counts.items()]
        return TableStats(rows=self.rows, distinct=distinct, heavy=heavy,
                          meters=dict(self.meta.meters))

    # -- zone-map chunk selection -----------------------------------------
    def select_chunks(self, pred: Optional[N.Expr],
                      params: Optional[dict] = None) -> List[int]:
        """Chunk indices that may contain rows satisfying ``pred``
        (all chunks when ``pred`` is None). Sound, not exact: a chunk is
        dropped only when its zone maps prove no row can match."""
        if pred is None:
            return list(range(self.n_chunks))
        return [i for i, c in enumerate(self.meta.chunks)
                if chunk_may_match(pred, c.zones, self.meta.schema, params)]

    # -- loading -----------------------------------------------------------
    def _load_chunk(self, col: str, i: int, verify: bool,
                    count: bool = True,
                    out: Optional[torch.Tensor] = None):
        """One chunk's rows: a NumPy array on a CPU dataset; on the
        card a device tensor (``out``, the chunk's slice of a column,
        when given)."""
        with _span("storage.chunk", part=self.meta.name, col=col,
                   chunk=i):
            return self._load_chunk_impl(col, i, verify, count, out)

    def _load_chunk_impl(self, col: str, i: int, verify: bool,
                         count: bool = True,
                         out: Optional[torch.Tensor] = None):
        """Read one chunk with the ``storage.chunk`` fault site, the
        codec decode stage, and integrity checks. A *torn* chunk (fewer
        rows — or a truncated encoded blob — on disk than the footer
        promises) is caught unconditionally by the row-count check
        (decoded rows derive from the payload, never the footer); silent
        *bit corruption* keeps the row count and is only caught by the
        CRC under ``verify=True`` — the CRC covers DECODED rows, so one
        checksum guards raw and encoded chunks alike. ``count=False``
        keeps planner-internal peeks (morsel boundary reads) out of
        ``STORAGE_STATS``."""
        meta = self.meta
        path = chunk_path(self.dirpath, meta.name, col, i)
        enc = meta.chunks[i].encodings.get(col)
        rule = FAULTS.hit("storage.chunk", part=meta.name, col=col, chunk=i)
        if rule is not None and rule.kind == "missing":
            raise MissingChunkError(
                f"injected missing chunk: {meta.name}.{col} chunk {i}")
        try:
            a = np.load(path, mmap_mode="r")
            if count:
                _count("bytes_read", os.path.getsize(path))
        except FileNotFoundError as e:
            raise MissingChunkError(
                f"{meta.name}.{col} chunk {i}: {path} does not exist"
            ) from e
        except (OSError, ValueError) as e:
            raise ChunkCorruptionError(
                f"{meta.name}.{col} chunk {i}: unreadable npy "
                f"({e})") from e
        if rule is not None and rule.kind == "torn":
            # a torn WRITE: the on-disk payload (raw rows or encoded
            # blob) is shorter than the footer promises
            frac = float(rule.arg) if rule.arg is not None else 0.5
            a = np.asarray(a)[:int(a.shape[0] * frac)]
        corrupt = rule is not None and rule.kind == "corrupt"
        if self.device.type == "cpu":
            return self._finish_host(col, i, enc, a, corrupt, verify, count)
        return self._finish_device(col, i, enc, a, corrupt, verify, count,
                                   out)

    def _torn(self, col: str, i: int, rows: int) -> ChunkCorruptionError:
        return ChunkCorruptionError(
            f"{self.meta.name}.{col} chunk {i}: {rows} rows on "
            f"disk != {self.meta.chunks[i].rows} in footer (torn write?)")

    def _decode_failed(self, col, i, enc, e) -> ChunkCorruptionError:
        return ChunkCorruptionError(
            f"{self.meta.name}.{col} chunk {i}: {enc.get('codec')} decode "
            f"failed ({e!r})")

    def _finish_host(self, col, i, enc, a, corrupt, verify, count
                     ) -> np.ndarray:
        meta = self.meta
        if enc is not None:
            with _span("decode", part=meta.name, col=col, chunk=i,
                       codec=enc.get("codec")):
                t0 = time.perf_counter()
                try:
                    a = E.decode_chunk(enc, np.asarray(a))
                except ChunkCorruptionError:
                    raise
                except Exception as e:
                    raise self._decode_failed(col, i, enc, e) from e
                if count:
                    _count("decode_us",
                           int((time.perf_counter() - t0) * 1e6))
                    _count("bytes_decoded", int(a.nbytes))
                    _count("chunks_decoded")
        if corrupt and a.size:
            # silent bit rot observed by the consumer: flips a byte of
            # the DECODED rows, so the row count survives and only the
            # CRC (verify=True) can catch it — for raw and encoded
            # chunks alike
            a = np.array(a)         # writable copy of the mmap
            a.view(np.uint8).flat[0] ^= 0xFF
        if a.shape[0] != meta.chunks[i].rows:
            raise self._torn(col, i, a.shape[0])
        if verify:
            want = meta.chunks[i].crcs.get(col)
            if want is not None and chunk_crc(np.asarray(a)) != want:
                raise ChunkCorruptionError(
                    f"{meta.name}.{col} chunk {i}: checksum mismatch")
        return a

    def _finish_device(self, col, i, enc, a, corrupt, verify, count,
                       out) -> torch.Tensor:
        """The card's half of ``_load_chunk_impl``. Everything that can
        show the chunk to be corrupt is checked on the host BEFORE the
        copy and the launch, which stay outside every ``except``: a
        failed build or launch raises as itself, never as corruption."""
        meta = self.meta
        want = meta.chunks[i].rows
        dtype = np.dtype(meta.dtypes[col])
        if out is None:
            out = torch.empty((want,), dtype=_torch_dtype(dtype),
                              device=self.device)
        if enc is not None:
            with _span("decode", part=meta.name, col=col, chunk=i,
                       codec=enc.get("codec")):
                t0 = time.perf_counter()
                try:
                    rows = _check_members(enc, a)
                except ChunkCorruptionError as e:
                    raise self._decode_failed(col, i, enc, e) from e
                if rows != want:
                    raise self._torn(col, i, rows)
                _launch_decode(enc, a, rows, self.device, out)
                if count:
                    _count("decode_us",
                           int((time.perf_counter() - t0) * 1e6))
                    _count("bytes_decoded", rows * dtype.itemsize)
                    _count("chunks_decoded")
        else:
            if a.shape[0] != want:
                raise self._torn(col, i, a.shape[0])
            host = torch.empty((want,), dtype=out.dtype, pin_memory=True)
            host.numpy()[...] = a
            out.copy_(host, non_blocking=True)
        if corrupt and want:
            flip = out.view(torch.uint8)
            flip[0] ^= 0xFF
        if verify:
            crc = meta.chunks[i].crcs.get(col)
            if crc is not None and chunk_crc(out.cpu().numpy()) != crc:
                raise ChunkCorruptionError(
                    f"{meta.name}.{col} chunk {i}: checksum mismatch")
        return out

    def load(self, columns: Optional[Sequence[str]] = None,
             chunks: Optional[Sequence[int]] = None,
             capacity: Optional[int] = None,
             verify: bool = False) -> FlatBag:
        """Read ``columns`` (default all) of ``chunks`` (default all)
        into a FlatBag of ``capacity`` (default: exactly the loaded
        rows; larger capacities pad with invalid rows so one compiled
        plan serves every chunk selection of the part). ``verify=True``
        checks each chunk against its footer CRC32 (chunks persisted
        before checksums existed are skipped)."""
        meta = self.meta
        if columns is None:
            cols = sorted(meta.schema)
        else:
            unknown = set(columns) - set(meta.schema)
            assert not unknown, (
                f"{meta.name}: unknown columns {sorted(unknown)}")
            cols = sorted(columns)
        sel = list(range(self.n_chunks)) if chunks is None \
            else sorted(chunks)
        with _span("storage.load_part", part=meta.name,
                   columns=tuple(cols), chunks=len(sel),
                   skipped=self.n_chunks - len(sel)):
            return self._load_selected(cols, sel, capacity, verify)

    def _load_selected(self, cols, sel, capacity, verify) -> FlatBag:
        meta = self.meta
        nrows = sum(meta.chunks[i].rows for i in sel)
        cap = capacity if capacity is not None else max(nrows, 1)
        assert cap >= nrows, (
            f"{meta.name}: capacity {cap} < selected rows {nrows}")
        _count("parts_loaded")
        _count("chunks_read", len(sel) * len(cols))
        _count("chunks_skipped", (self.n_chunks - len(sel)) * len(cols))
        _count("columns_read", len(cols))
        _count("columns_pruned", len(meta.schema) - len(cols))
        dev = self.device
        data = {}
        for col in cols:
            dtype = np.dtype(meta.dtypes[col])
            if dev.type == "cpu":
                # empty + explicit tail-zero: loaded rows are overwritten
                # anyway, so a full-capacity memset would only add a
                # memory-bandwidth pass to every cold scan
                buf = np.empty(cap, dtype=dtype)
                off = 0
                for i in sel:
                    a = self._load_chunk(col, i, verify)
                    buf[off:off + a.shape[0]] = a
                    off += a.shape[0]
                buf[off:] = dtype.type(0) if dtype.kind != "b" else False
                data[col] = torch.from_numpy(buf)
                continue
            col_t = torch.empty((cap,), dtype=_torch_dtype(dtype),
                                device=dev)
            off = 0
            for i in sel:
                rows = meta.chunks[i].rows
                self._load_chunk(col, i, verify, out=col_t[off:off + rows])
                off += rows
            col_t[off:].zero_()
            data[col] = col_t
        valid = torch.arange(cap, device=dev) < nrows
        props = self._props(cols)
        return FlatBag(data, valid, props)

    def _props(self, cols: Sequence[str]) -> Optional[PhysicalProps]:
        """Persisted physical properties, restricted to loaded columns.
        ``sorted_by`` survives as its longest loaded prefix (chunk
        skipping preserves written row order); ``partitioning`` only
        when every column survives. Rows load valid-first, so
        ``invalid_last`` always holds."""
        meta = self.meta
        cs = set(cols)
        sb: Optional[tuple] = None
        if meta.sorted_by:
            pref = []
            for c in meta.sorted_by:
                if c not in cs:
                    break
                pref.append(c)
            sb = tuple(pref) or None
        part = meta.partitioning if (meta.partitioning
                                     and set(meta.partitioning) <= cs) \
            else None
        return PhysicalProps(sorted_by=sb, invalid_last=True,
                             partitioning=part)


def table_stats(dataset: "StoredDataset") -> Dict[str, object]:
    """{part name: skew.TableStats} over a whole dataset — the
    statistics bundle the skew pass and the query service read."""
    return {name: part.stats() for name, part in dataset.parts.items()}


class StoredDataset:
    """One opened dataset: parts, types, strict encoders, and the device
    its columns load onto (None = the GPU; ``device="cpu"`` on the
    CPU)."""

    def __init__(self, dirpath: str, device=None):
        self.dir = dirpath
        self.device = resolve_device(device)
        self.meta = read_footer(dirpath)
        self.parts: Dict[str, StoredPart] = {
            n: StoredPart(dirpath, pm, self.device)
            for n, pm in self.meta.parts.items()}
        self.input_types: Dict[str, N.BagT] = dict(self.meta.input_types)
        self.encoders: Dict[str, StringEncoder] = \
            restore_encoders(self.meta, strict=True)

    @property
    def name(self) -> str:
        return self.meta.name

    def part(self, name: str) -> StoredPart:
        return self.parts[name]

    def bytes_on_disk(self) -> int:
        return dir_bytes(self.dir)

    def fingerprint(self) -> tuple:
        """Cache-key component for the query service: identifies the
        dataset contents a compiled plan was bound against (schemas and
        row totals; chunk *selection* deliberately excluded — it varies
        per parameter binding under one warm plan)."""
        return (self.name, tuple(
            (n, p.rows, tuple(sorted(p.meta.schema.items())))
            for n, p in sorted(self.parts.items())))

    def load_env(self,
                 columns: Optional[Dict[str, Optional[set]]] = None,
                 preds: Optional[Dict[str, Optional[N.Expr]]] = None,
                 params: Optional[dict] = None,
                 capacities: Optional[Dict[str, int]] = None,
                 verify: bool = False
                 ) -> Dict[str, FlatBag]:
        """Materialize parts as an execution environment. ``columns``
        restricts parts AND their loaded columns (None value = all
        columns of that part); ``preds`` drives zone-map chunk skipping;
        ``capacities`` pins per-part capacities (the query service pins
        them to the full-part capacity class so chunk selection never
        changes the executable's input signature)."""
        names = sorted(columns) if columns is not None \
            else sorted(self.parts)
        env: Dict[str, FlatBag] = {}
        for name in names:
            part = self.parts[name]
            cols = None if columns is None else columns[name]
            pred = (preds or {}).get(name)
            sel = part.select_chunks(pred, params)
            cap = (capacities or {}).get(name)
            env[name] = part.load(
                columns=sorted(cols) if cols is not None else None,
                chunks=sel, capacity=cap, verify=verify)
        return env
