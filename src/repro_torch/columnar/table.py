"""FlatBag — the columnar, fixed-capacity bag representation.

PyTorch twin of ``repro.columnar.table``: a bag is a struct-of-tensors
with a static *capacity* and a validity mask. Filters mask; nothing
ever reallocates. Strings and dates are dictionary-encoded to int32 at
ingest. Labels are ordinary int64 columns (a label's identity is its
captured key tuple; tags are static metadata).

Every tensor of a bag lives on one device. Entry points that create
tensors take ``device=None``, which means the GPU (``"cuda"``); the
CPU is used only when the caller asks for it (``device="cpu"``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


DTYPES = {
    "int": torch.int64,
    "real": torch.float64,
    "string": torch.int32,   # dictionary code
    "bool": torch.bool,
    "date": torch.int32,     # days
    "label": torch.int64,
}

_NP_DTYPES = {torch.int64: np.int64, torch.float64: np.float64,
              torch.int32: np.int32, torch.bool: np.bool_}


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one, refuse rather than carry on
    quietly on the CPU: the caller has to ask for ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class StringEncoder:
    """Per-domain string dictionary (shared across tables joining on the
    same string domain).

    ``strict=True`` freezes the vocabulary as an integrity boundary:
    encoding an unknown string or decoding an out-of-range code raises
    instead of growing the dictionary / fabricating ``"<code>"``."""

    def __init__(self, strict: bool = False):
        self.vocab: Dict[str, int] = {}
        self.rev: List[str] = []
        self.strict = strict

    @classmethod
    def from_vocab(cls, rev: Sequence[str],
                   strict: bool = False) -> "StringEncoder":
        enc = cls()
        for s in rev:
            enc.encode(s)
        enc.strict = strict
        return enc

    def encode(self, s: str) -> int:
        if s not in self.vocab:
            if self.strict:
                raise KeyError(
                    f"StringEncoder(strict): unknown string {s!r} "
                    f"(vocabulary has {len(self.rev)} entries)")
            self.vocab[s] = len(self.rev)
            self.rev.append(s)
        return self.vocab[s]

    def decode(self, code: int) -> str:
        if 0 <= int(code) < len(self.rev):
            return self.rev[int(code)]
        if self.strict:
            raise KeyError(
                f"StringEncoder(strict): code {int(code)} outside "
                f"vocabulary [0, {len(self.rev)})")
        return f"<{code}>"


class FlatBag:
    """Struct-of-tensors bag: ``data[col] : (capacity,)`` + ``valid``.

    ``props`` (columnar.props.PhysicalProps) caches physical properties
    — packed keys, delivered sort orders, build-side argsorts. The cache
    is always recomputable from (data, valid)."""

    def __init__(self, data: Dict[str, torch.Tensor], valid: torch.Tensor,
                 props=None):
        self.data = dict(data)
        self.valid = valid
        self._props = props

    @property
    def props(self):
        if self._props is None:
            from .props import PhysicalProps
            self._props = PhysicalProps()
        return self._props

    def with_props(self, props) -> "FlatBag":
        """Same bag, explicit physical properties (shares tensors)."""
        return FlatBag(self.data, self.valid, props)

    # -- basic properties --------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def columns(self) -> List[str]:
        return sorted(self.data)

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1, dtype=torch.int32)

    def col(self, name: str) -> torch.Tensor:
        return self.data[name]

    def with_columns(self, **cols) -> "FlatBag":
        data = dict(self.data)
        data.update(cols)
        props = None
        if self._props is not None:
            props = self._props.after_new_columns(
                [c for c in cols if c in self.data])
        return FlatBag(data, self.valid, props)

    def select_columns(self, names: Sequence[str]) -> "FlatBag":
        props = None
        if self._props is not None:
            props = self._props.restrict_columns(names)
        return FlatBag({n: self.data[n] for n in names}, self.valid, props)

    def drop_columns(self, names: Sequence[str]) -> "FlatBag":
        drop = set(names)
        keep = [n for n in self.data if n not in drop]
        props = None
        if self._props is not None:
            props = self._props.restrict_columns(keep)
        return FlatBag({n: self.data[n] for n in keep}, self.valid, props)

    def mask(self, keep: torch.Tensor) -> "FlatBag":
        props = self._props.after_mask() if self._props is not None else None
        return FlatBag(self.data, self.valid & keep, props)

    def row_bytes(self) -> int:
        """Bytes per valid row (the shuffle-accounting unit)."""
        total = 0
        for a in self.data.values():
            total += a.element_size()
        total += 1  # validity bit, charged as a byte
        return total

    def resize(self, capacity: int) -> "FlatBag":
        """Grow (pad) or shrink (compact-first not required for grow)."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity > cap:
            pad = capacity - cap
            data = {n: _pad(a, pad) for n, a in self.data.items()}
            return FlatBag(data, _pad(self.valid, pad))
        # shrink: keep valid rows first
        order = torch.argsort(~self.valid, stable=True)
        data = {n: a[order][:capacity] for n, a in self.data.items()}
        return FlatBag(data, self.valid[order][:capacity])

    def compact(self) -> "FlatBag":
        """Stable-sort valid rows to the front (same capacity)."""
        order = torch.argsort(~self.valid, stable=True)
        return FlatBag({n: a[order] for n, a in self.data.items()},
                       self.valid[order])

    # -- host conversion -------------------------------------------------
    @staticmethod
    def from_rows(rows: List[dict], schema: Dict[str, str],
                  capacity: Optional[int] = None,
                  encoders: Optional[Dict[str, StringEncoder]] = None,
                  device=None) -> "FlatBag":
        """Build from Python rows. ``schema``: col -> kind (see DTYPES).
        String columns use ``encoders[col]`` (created if missing)."""
        dev = resolve_device(device)
        n = len(rows)
        cap = capacity or max(n, 1)
        assert cap >= n, f"capacity {cap} < rows {n}"
        encoders = encoders if encoders is not None else {}
        data = {}
        for colname, kind in schema.items():
            vals = np.zeros(cap, dtype=_NP_DTYPES[DTYPES[kind]])
            for i, r in enumerate(rows):
                v = r[colname]
                if kind == "string" and isinstance(v, str):
                    enc = encoders.setdefault(colname, StringEncoder())
                    v = enc.encode(v)
                if kind == "label" and not isinstance(v, (int, np.integer)):
                    # interpreter Labels: identity is the captured value(s)
                    v = _label_to_int(v)
                vals[i] = v
            data[colname] = torch.from_numpy(vals).to(dev)
        valid = torch.arange(cap, device=dev) < n
        return FlatBag(data, valid)

    def to_rows(self, decoders: Optional[Dict[str, StringEncoder]] = None
                ) -> List[dict]:
        valid = self.valid.cpu().numpy()
        host = {n: a.cpu().numpy() for n, a in self.data.items()}
        out = []
        for i in range(self.capacity):
            if not valid[i]:
                continue
            row = {}
            for n, a in host.items():
                v = a[i].item()
                if decoders and n in decoders:
                    v = decoders[n].decode(v)
                row[n] = v
            out.append(row)
        return out

    def __repr__(self) -> str:
        return (f"FlatBag(cap={self.capacity}, cols={self.columns}, "
                f"count={int(self.count())})")


def _pad(a: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=a.device)])


def _label_to_int(v) -> int:
    """Interpreter Label -> int identity (single int capture), used only
    when round-tripping oracle values into columnar tests."""
    from repro_torch.core.interpreter import Label
    if isinstance(v, Label):
        assert len(v.values) == 1, "columnar labels are single-key"
        return _label_to_int(v.values[0])
    assert isinstance(v, (int, np.integer)), v
    return int(v)


def concat_bags(a: FlatBag, b: FlatBag) -> FlatBag:
    cols = set(a.data) & set(b.data)
    assert cols == set(a.data) == set(b.data), (a.columns, b.columns)
    data = {n: torch.cat([a.data[n], b.data[n]]) for n in cols}
    return FlatBag(data, torch.cat([a.valid, b.valid]))


def concat_compact(a: FlatBag, b: FlatBag, capacity: int):
    """Union of two bags compacted to a static ``capacity``: valid rows
    stable-sort to the front, the tail is truncated. Returns
    ``(bag, dropped)`` where ``dropped`` counts VALID rows that did not
    fit (0 whenever the valid counts allow the compaction)."""
    cols = set(a.data) & set(b.data)
    assert cols == set(a.data) == set(b.data), (a.columns, b.columns)
    if capacity >= a.capacity + b.capacity:
        return concat_bags(a, b).resize(capacity), \
            torch.zeros((), dtype=torch.int64, device=a.device)
    valid = torch.cat([a.valid, b.valid])
    order = torch.argsort(~valid, stable=True)[:capacity]
    data = {n: torch.cat([a.data[n], b.data[n]])[order] for n in cols}
    total = valid.to(torch.int64).sum()
    dropped = torch.clamp(total - capacity, min=0)
    return FlatBag(data, valid[order]), dropped


# ---------------------------------------------------------------------------
# carrying an environment across packages / devices
# ---------------------------------------------------------------------------

def env_from_numpy(env_np: Dict[str, Tuple[Dict[str, np.ndarray],
                                           np.ndarray]],
                   device=None) -> Dict[str, FlatBag]:
    """``{name: ({col: array}, valid)}`` -> ``{name: FlatBag}`` on
    ``device``. The arrays keep their dtypes (the reference's DTYPES)."""
    dev = resolve_device(device)

    def tensor(a):
        a = np.ascontiguousarray(a)
        # read-only buffers (e.g. views of another framework's arrays)
        # are copied: the port must be free to own its tensors
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)

    return {name: FlatBag({c: tensor(a) for c, a in cols.items()},
                          tensor(np.asarray(valid, dtype=np.bool_)))
            for name, (cols, valid) in env_np.items()}


def env_to_numpy(env: Dict[str, FlatBag]
                 ) -> Dict[str, Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """Inverse of ``env_from_numpy``: host copies of every column."""
    return {name: ({c: a.cpu().numpy() for c, a in bag.data.items()},
                   bag.valid.cpu().numpy())
            for name, bag in env.items()}
