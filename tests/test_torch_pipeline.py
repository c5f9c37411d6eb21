"""The port's LM token pipeline against the reference on the CPU: the
shredded token query's stream, bit for bit the reference's, and the
reference's own tests (``tests/test_pipeline.py``: the streaming ingest
from disk gives the in-memory path's batches bit for bit) run against
the port. Batches are int32 tensors on the pipeline's device."""

import itertools

import numpy as np
import pytest
import torch

from repro.data.generators import gen_corpus as r_gen_corpus
from repro.data.pipeline import TokenPipeline as RTokenPipeline
from repro_torch.data.generators import CORPUS_TYPES, gen_corpus
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.storage import StorageCatalog


@pytest.fixture(scope="module")
def corpus():
    return gen_corpus(n_docs=24, seed=3)


@pytest.fixture(scope="module")
def stored_corpus(corpus, tmp_path_factory):
    """Stream the corpus to disk in four incremental batches."""
    cat = StorageCatalog(str(tmp_path_factory.mktemp("corpus_store")),
                         device="cpu")
    w = cat.writer("corpus", CORPUS_TYPES, chunk_rows=64)
    docs = corpus["Corpus"]
    w.append({"Corpus": docs[:6], "LangScore": corpus["LangScore"]})
    for i in range(6, len(docs), 6):
        w.append({"Corpus": docs[i:i + 6]})
    return cat.open("corpus")


def _np(t) -> np.ndarray:
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.mark.parametrize("n_docs,vocab,seed", [(24, 1000, 3), (60, 97, 0),
                                               (200, 256000, 1)])
def test_stream_and_batches_equal_the_reference(n_docs, vocab, seed):
    """The same corpus through both packages: the stream bit for bit
    (int32), and the batches of ``__iter__`` and ``batch_at`` too."""
    assert r_gen_corpus(n_docs=n_docs, vocab=vocab, seed=seed) == \
        gen_corpus(n_docs=n_docs, vocab=vocab, seed=seed)
    corpus = gen_corpus(n_docs=n_docs, vocab=vocab, seed=seed)
    ref = RTokenPipeline(batch=2, seq_len=16).build(corpus)
    got = TokenPipeline(batch=2, seq_len=16, device="cpu").build(corpus)
    assert got.stream.dtype == torch.int32
    assert np.array_equal(_np(got.stream), ref.stream)
    for a, b in itertools.islice(zip(iter(got), iter(ref)), 6):
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32 and a[k].shape == (2, 16)
            assert np.array_equal(_np(a[k]), _np(b[k]))
    for cursor in (0, 3, 11, 1000):
        a, b = got.batch_at(cursor), ref.batch_at(cursor)
        for k in ("tokens", "labels"):
            assert np.array_equal(_np(a[k]), _np(b[k]))


def test_stream_identical(corpus, stored_corpus):
    mem = TokenPipeline(batch=4, seq_len=32, device="cpu").build(corpus)
    disk = TokenPipeline(batch=4, seq_len=32,
                         device="cpu").build_from_storage(stored_corpus)
    assert mem.stream.dtype == disk.stream.dtype
    assert np.array_equal(_np(mem.stream), _np(disk.stream))


def test_batches_bit_for_bit(corpus, stored_corpus):
    mem = TokenPipeline(batch=2, seq_len=16, device="cpu").build(corpus)
    disk = TokenPipeline(batch=2, seq_len=16,
                         device="cpu").build_from_storage(stored_corpus)
    it_mem, it_disk = iter(mem), iter(disk)
    for _ in range(5):
        a, b = next(it_mem), next(it_disk)
        assert np.array_equal(_np(a["tokens"]), _np(b["tokens"]))
        assert np.array_equal(_np(a["labels"]), _np(b["labels"]))
    # deterministic addressing agrees too (checkpoint/resume contract)
    for cursor in (0, 3, 11):
        a, b = mem.batch_at(cursor), disk.batch_at(cursor)
        assert np.array_equal(_np(a["tokens"]), _np(b["tokens"]))
        assert np.array_equal(_np(a["labels"]), _np(b["labels"]))


def test_iter_wraps_consistently(corpus, stored_corpus):
    """Short stream + large batch forces the tiling path on both, and it
    is the reference's tiling."""
    mem = TokenPipeline(batch=8, seq_len=64, device="cpu").build(corpus)
    disk = TokenPipeline(batch=8, seq_len=64,
                         device="cpu").build_from_storage(stored_corpus)
    a, b = next(iter(mem)), next(iter(disk))
    assert np.array_equal(_np(a["tokens"]), _np(b["tokens"]))
    ref = RTokenPipeline(batch=8, seq_len=64).build(corpus)
    assert len(mem.stream) < 8 * 64 + 1
    assert np.array_equal(_np(a["tokens"]), _np(next(iter(ref))["tokens"]))
    assert np.array_equal(_np(mem.batch_at(5)["labels"]),
                          _np(ref.batch_at(5)["labels"]))
