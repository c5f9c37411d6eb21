"""Chunked writer for the shredded columnar storage format (PyTorch
twin of ``repro.storage.writer``: the same chunk files, footers and
sketches, byte for byte, for the same input).

Two entry points, one invariant:

* ``DatasetWriter.append(inputs)`` — **streaming ingest**: value-shreds
  one batch of nested rows and appends its parts as new column chunks.
  Label columns are offset by the rows already persisted in the label
  domain's parent part, so N appended batches produce bit-for-bit the
  same environment as shredding the concatenated rows in one shot (the
  pipeline parity test asserts this).
* ``DatasetWriter.write_parts(env)`` — persist already-shredded
  ``FlatBag`` parts directly (compacted to valid rows), capturing their
  ``PhysicalProps`` sort/partitioning metadata into the footer.

Every append rewrites the JSON footer atomically (write + rename), so a
reader never observes a half-written dataset.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.columnar.table import DTYPES, FlatBag, StringEncoder
from repro_torch.core import codegen as CG
from repro_torch.core import nrc as N
from repro_torch.core.materialization import mat_input_name
from repro_torch.core.skew import HeavyKeySketch

from .encodings import choose_encoding, encode_chunk
from .format import (ChunkMeta, DatasetMeta, PartMeta, chunk_crc,
                     chunk_path, dir_bytes, flat_part_schema,
                     label_domains, read_footer, write_footer,
                     zone_stats)


def _np_dtype(kind: str) -> np.dtype:
    """The numpy dtype of a column kind (``DTYPES`` maps it to torch)."""
    return torch.empty(0, dtype=DTYPES[kind]).numpy().dtype


def _all_paths(ty: N.BagT, path: tuple = ()) -> List[tuple]:
    out = [path]
    elem = ty.elem
    if isinstance(elem, N.TupleT):
        for n, ft in elem.fields:
            if isinstance(ft, N.BagT):
                out.extend(_all_paths(ft, path + (n,)))
    return out


class DatasetWriter:
    """``resume=False`` (default) starts a FRESH dataset: any existing
    directory content is removed first, so stale chunks from a prior
    incarnation can never shadow the new footer. ``resume=True``
    reopens an existing dataset for continued streaming — the footer's
    row totals and encoder vocabularies are restored, so label offsets
    continue exactly where the previous process stopped."""

    def __init__(self, root: str, name: str,
                 input_types: Dict[str, N.BagT], chunk_rows: int = 1024,
                 encoders: Optional[Dict[str, StringEncoder]] = None,
                 resume: bool = False, encoding: str = "auto"):
        assert chunk_rows > 0
        assert encoding in ("auto", "raw"), encoding
        # "auto": per-(part, column, chunk) codec chosen from the zone
        # stats at append time (encodings.choose_encoding); "raw":
        # every chunk stays a plain .npy (the pre-encoding format —
        # footers carry no encoding descriptors at all)
        self.encoding = encoding
        self.dir = os.path.join(root, name)
        self.encoders: Dict[str, StringEncoder] = \
            encoders if encoders is not None else {}
        if resume:
            self.meta = read_footer(self.dir)
            assert self.meta.chunk_rows == chunk_rows, (
                f"resume: dataset has chunk_rows="
                f"{self.meta.chunk_rows}, writer asked {chunk_rows}")
            assert {n: repr(t) for n, t in self.meta.input_types.items()} \
                == {n: repr(t) for n, t in input_types.items()}, (
                "resume: input types differ from the persisted footer")
            # the persisted vocabulary is authoritative for codes
            # already on disk: a caller-provided encoder must agree on
            # the common prefix, and is extended (never reordered) to
            # cover it
            for col, rev in self.meta.encoders.items():
                enc = self.encoders.setdefault(col, StringEncoder())
                common = min(len(enc.rev), len(rev))
                assert enc.rev[:common] == list(rev[:common]), (
                    f"resume: encoder for {col!r} disagrees with the "
                    f"persisted vocabulary ({enc.rev[:common]} != "
                    f"{list(rev[:common])}); codes on disk would be "
                    f"silently remapped")
                for s in rev[len(enc.rev):]:
                    enc.encode(s)
        else:
            if os.path.isdir(self.dir):
                shutil.rmtree(self.dir)
            self.meta = DatasetMeta(name=name, chunk_rows=chunk_rows,
                                    input_types=dict(input_types))
            # pre-register every part of every input type so empty
            # inputs still round-trip with their full schema
            for iname, ty in input_types.items():
                for path in _all_paths(ty):
                    key = mat_input_name(iname, path)
                    schema = flat_part_schema(ty, path)
                    self.meta.parts[key] = PartMeta(
                        name=key, schema=schema,
                        dtypes={c: str(_np_dtype(k))
                                for c, k in schema.items()})
        # streaming heavy-key sketches, one per (part, integer-kind
        # column) — restored from the footer on resume so a restarted
        # process keeps counting where the previous one stopped. A
        # sketch whose stream total exceeds the part's footer rows is
        # TORN state: a prior incarnation counted a batch whose chunks
        # never made the footer (crash mid-append), and the overcount
        # cannot be subtracted back out. Quarantine it — skew decisions
        # must not read statistics the data does not back.
        self.quarantined_sketches: Dict[str, Dict[str, dict]] = {}
        if resume:
            for part, pm in self.meta.parts.items():
                stale = {col for col, sj in pm.sketches.items()
                         if int(sj.get("total", 0)) > pm.rows}
                if stale:
                    self.quarantined_sketches[part] = {
                        col: pm.sketches.pop(col) for col in sorted(stale)}
        self._sketches: Dict[str, Dict[str, HeavyKeySketch]] = {
            part: {col: HeavyKeySketch.from_json(sj)
                   for col, sj in pm.sketches.items()}
            for part, pm in self.meta.parts.items()}
        # label-kind column -> part name holding that domain's rids
        self._domain_parent: Dict[str, Dict[str, str]] = {}
        for iname, ty in self.meta.input_types.items():
            for path in _all_paths(ty):
                key = mat_input_name(iname, path)
                self._domain_parent[key] = {
                    col: mat_input_name(iname, dom[:-1])
                    for col, dom in label_domains(ty, path).items()}
        os.makedirs(self.dir, exist_ok=True)

    # -- streaming ingest --------------------------------------------------
    def append(self, inputs: Dict[str, list]) -> "DatasetWriter":
        """Shred and append one batch of nested rows per input root.

        In-memory state is transactional per batch: if any part's
        append raises (disk full, injected fault...), the writer's
        sketches and chunk metadata roll back to the pre-batch
        snapshot before re-raising — a caught failure followed by a
        later successful flush must not persist sketch counters ahead
        of the footer's rows (the torn state ``resume`` quarantines)."""
        env = CG.columnar_shred_inputs(
            inputs, {n: self.meta.input_types[n] for n in inputs},
            encoders=self.encoders, device="cpu")
        # label bases are the PRE-batch row totals: compute them all
        # before any part of the batch lands
        bases = {part: pm.rows for part, pm in self.meta.parts.items()}
        snap_sketches = {part: {col: HeavyKeySketch.from_json(s.to_json())
                                for col, s in sk.items()}
                         for part, sk in self._sketches.items()}
        snap_chunks = {part: list(pm.chunks)
                       for part, pm in self.meta.parts.items()}
        snap_props = {part: (pm.sorted_by, pm.partitioning)
                      for part, pm in self.meta.parts.items()}
        try:
            for part, bag in env.items():
                offsets = {col: bases[parent] for col, parent
                           in self._domain_parent[part].items()}
                self._append_part(part, bag, label_offsets=offsets)
        except BaseException:
            self._sketches = snap_sketches
            for part, pm in self.meta.parts.items():
                pm.chunks = snap_chunks[part]
                pm.sorted_by, pm.partitioning = snap_props[part]
            raise
        self._flush()
        return self

    def write(self, inputs: Dict[str, list]) -> "DatasetWriter":
        """One-shot write == a single streamed batch."""
        return self.append(inputs)

    # -- direct FlatBag persistence ---------------------------------------
    def write_parts(self, env: Dict[str, FlatBag]) -> "DatasetWriter":
        """Persist already-shredded parts (e.g. a query output bundle)
        ONCE: each part may be written by at most one call — label
        columns are persisted verbatim (they may be combine64 values,
        not sequential rids), so the append-path offset continuation
        does not apply and a second bundle would silently cross-wire
        parent/child references. Use ``append`` for streaming rows.
        Physical props are captured from each bag."""
        for part, bag in env.items():
            pm = self.meta.parts.get(part)
            assert pm is not None, (
                f"write_parts: {part!r} is not a part of this dataset's "
                f"input types {sorted(self.meta.parts)}")
            assert not pm.chunks, (
                f"write_parts: {part!r} already holds data; label "
                f"columns cannot be offset for a second bundle — "
                f"stream rows with append() instead")
            self._append_part(part, bag, capture_props=True)
        self._flush()
        return self

    # -- internals ---------------------------------------------------------
    def _append_part(self, part: str, bag: FlatBag,
                     label_offsets: Optional[Dict[str, int]] = None,
                     capture_props: bool = False) -> None:
        pm = self.meta.parts[part]
        assert set(bag.data) == set(pm.schema), (
            f"{part}: columns {sorted(bag.data)} != schema "
            f"{sorted(pm.schema)}")
        valid = bag.valid.cpu().numpy()
        n = int(valid.sum())
        if n == 0:
            return      # nothing appended: footer (and props) unchanged
        host = {}
        sketches = self._sketches.setdefault(part, {})
        for col in bag.data:
            a = bag.data[col].cpu().numpy()[valid]
            if label_offsets and label_offsets.get(col):
                a = a + np.asarray(label_offsets[col], dtype=a.dtype)
            host[col] = a
            # streaming heavy-key statistics: integer-kind columns
            # (ints, dates, label rids, string codes) are join-key
            # candidates; reals/bools are not equi-join keys
            if np.issubdtype(a.dtype, np.integer):
                sketches.setdefault(col, HeavyKeySketch()).update(a)
        if pm.chunks:
            # appending to a non-empty part: the concatenation is no
            # longer globally sorted/placed, so persisted props from an
            # earlier batch must not survive
            pm.sorted_by = None
            pm.partitioning = None
        elif capture_props and bag._props is not None:
            p = bag.props
            if p.sorted_by:
                pm.sorted_by = tuple(p.sorted_by)
            if p.partitioning:
                pm.partitioning = tuple(p.partitioning)
        step = self.meta.chunk_rows
        for start in range(0, n, step):
            stop = min(start + step, n)
            idx = len(pm.chunks)
            zones = {}
            crcs = {}
            encs = {}
            for col, a in host.items():
                piece = a[start:stop]
                path = chunk_path(self.dir, part, col, idx)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                # zone maps + CRC always describe the DECODED rows: the
                # reader skips chunks and verifies integrity without
                # ever touching a codec
                zones[col] = zone_stats(piece)
                crcs[col] = chunk_crc(piece)
                codec = choose_encoding(piece, zones[col]) \
                    if self.encoding == "auto" else None
                if codec is not None:
                    enc, blob = encode_chunk(piece, codec)
                    np.save(path, blob)
                    encs[col] = enc
                else:
                    np.save(path, piece)
            pm.chunks.append(
                ChunkMeta(rows=stop - start, zones=zones, crcs=crcs,
                          encodings=encs))

    def _flush(self) -> None:
        self.meta.encoders = {c: list(e.rev)
                              for c, e in self.encoders.items()}
        for part, sk in self._sketches.items():
            self.meta.parts[part].sketches = {c: s.to_json()
                                              for c, s in sk.items()}
        write_footer(self.dir, self.meta)

    def bytes_on_disk(self) -> int:
        return dir_bytes(self.dir)
