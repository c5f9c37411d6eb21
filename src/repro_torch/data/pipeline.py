"""LM data pipeline built on the paper's query engine.

PyTorch twin of ``repro.data.pipeline``: nested corpora are
value-shredded once; an NRC query (filter by language weight, join the
language scores, flatten sections) is shredded and compiled to columnar
plans and run on the pipeline's device (on the card through the join
kernels, ``ExecSettings(use_kernel=True)``); its flat output (doc_id,
sec_id, pos, tok, weight) is filtered to positive weights, ordered by
(doc_id, sec_id, pos) on the device and packed into fixed-length int32
token batches on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch

from repro_torch.columnar.table import resolve_device
from repro_torch.core import codegen as CG
from repro_torch.core import materialization as M
from repro_torch.core import nrc as N
from repro_torch.core.plans import ExecSettings
from repro_torch.core.unnesting import Catalog
from .generators import CORPUS_TYPES


def token_query() -> N.Program:
    """for d in Corpus, for l in LangScore if d.lang == l.lang and
    weighted, for s in d.sections, for t in s.tokens -> flat rows."""
    Corpus = N.Var("Corpus", CORPUS_TYPES["Corpus"])
    Lang = N.Var("LangScore", CORPUS_TYPES["LangScore"])
    q = N.for_in("d", Corpus, lambda d:
        N.for_in("l", Lang, lambda l:
            N.IfThen(d.lang.eq(l.lang),
                N.for_in("s", d.sections, lambda s:
                    N.for_in("t", s.tokens, lambda t:
                        N.Singleton(N.record(
                            doc_id=d.doc_id, sec_id=s.sec_id,
                            pos=t.pos, tok=t.tok,
                            weight=l.weight * d.quality)))))))
    return N.Program([N.Assignment("TOKENS", q)])


@dataclass
class TokenPipeline:
    """Compiles and runs the ingest query; yields (B, S) token batches.
    ``device``: where the query runs and the batches live (None: the
    GPU)."""
    batch: int
    seq_len: int
    seed: int = 0
    device: Optional[object] = None

    def build(self, inputs: Dict[str, list]):
        env = CG.columnar_shred_inputs(inputs, CORPUS_TYPES,
                                       device=resolve_device(self.device))
        return self._build_from_env(env)

    def build_from_storage(self, dataset):
        """Disk-backed ingest: the value-shredded corpus parts read from a
        persisted dataset (``storage.StoredDataset`` on the pipeline's
        device) instead of regenerated and shredded again. Streaming
        appends offset labels by the parent part's prior rows, so the
        stream is bit for bit the in-memory path's."""
        return self._build_from_env(dataset.load_env())

    def _build_from_env(self, env):
        dev = resolve_device(self.device)
        prog = token_query()
        self.shredded = M.shred_program(prog, CORPUS_TYPES,
                                        domain_elimination=True)
        catalog = Catalog(unique_keys={"LangScore__F": ("lang",)})
        self.compiled = CG.compile_program(self.shredded, catalog)
        env = CG.run_flat_program(
            self.compiled, env, ExecSettings(use_kernel=dev.type == "cuda"))
        out = env["TOKENS"]
        keep = out.valid & (out.data["weight"] > 0)
        cols = {n: out.data[n][keep] for n in ("doc_id", "sec_id", "pos",
                                                "tok")}
        order = torch.arange(int(keep.sum()), device=keep.device)
        for key in ("pos", "sec_id", "doc_id"):     # lexicographic, stable
            order = order[torch.sort(cols[key][order], stable=True)[1]]
        self.stream = cols["tok"][order].to(torch.int32).to(dev)
        return self

    def _stream(self) -> torch.Tensor:
        """The stream, tiled when it is shorter than a batch and one."""
        need = self.batch * self.seq_len
        stream = self.stream
        if len(stream) < need + 1:
            stream = stream.repeat(need // max(len(stream), 1) + 2)
        return stream

    def _pack(self, chunk: torch.Tensor) -> dict:
        need = self.batch * self.seq_len
        return {"tokens": chunk[:need].reshape(self.batch, self.seq_len),
                "labels": chunk[1:need + 1].reshape(self.batch,
                                                    self.seq_len)}

    def __iter__(self) -> Iterator[dict]:
        need = self.batch * self.seq_len
        stream = self._stream()
        cursor = 0
        while True:
            chunk = stream[cursor:cursor + need + 1]
            if len(chunk) < need + 1:
                cursor = 0
                continue
            cursor += need
            yield self._pack(chunk)

    def batch_at(self, cursor: int) -> dict:
        """Deterministic batch addressing (checkpoint/resume exactness)."""
        need = self.batch * self.seq_len
        stream = self._stream()
        start = (cursor * need) % (len(stream) - need - 1)
        return self._pack(stream[start:start + need + 1])
