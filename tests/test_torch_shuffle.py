"""The plain versions of the packed-shuffle kernels (``pack_rows``,
``replicate_scatter``, ``unpack_cols``, ``member_mask``) against the
reference's plain versions (``repro.kernels.ref``) and its Pallas
kernels in interpret mode (``repro.kernels.shuffle_pack``), bit for bit,
over the sweeps and edges of ``tests/test_kernels.py``: ``ok`` all
false, indices out of range and negative virtual ids, ``repl = 1``
equal to ``pack_rows``, every replica landing, sizes that are no
multiple of any block, -0.0 and NaN payloads in float lanes, INT64_MAX
on either side of ``member_mask`` and an unsorted heavy set. The CPU
dispatch in ``kernels/ops.py`` runs the plain versions; the CUDA kernels
are held against them in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as RR
from repro.kernels.shuffle_pack import (member_mask_pallas, pack_rows_pallas,
                                        replicate_scatter_pallas,
                                        unpack_cols_pallas)
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR

I64_MAX = np.iinfo(np.int64).max
SPECIAL = np.array([-0.0, np.nan, 1.5, 0.0]).view(np.int64).tolist() + \
    [0x7FF8_0000_0000_0ABC, -0x0008_0000_0000_0001]   # NaN payloads


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vals(rng, r, d):
    vals = rng.randint(-2 ** 62, 2 ** 62, size=(r, d)).astype(np.int64)
    if r and d:
        flat = vals.reshape(-1)
        flat[:min(len(SPECIAL), flat.size)] = SPECIAL[:flat.size]
    return vals


def _same(*arrays):
    first = np.asarray(arrays[0])
    for a in arrays[1:]:
        a = np.asarray(a)
        assert a.shape == first.shape and a.dtype == first.dtype, \
            (a.shape, first.shape, a.dtype, first.dtype)
        assert np.array_equal(a, first), (a, first)


PACK_CASES = [(r, m, d, seed) for seed, (r, m, d) in enumerate(
    [(1, 1, 1), (1, 9, 1), (7, 33, 2), (20, 17, 3), (33, 60, 4),
     (60, 5, 2), (16, 16, 1), (17, 129, 3)])]


@pytest.mark.parametrize("r,m,d,seed", PACK_CASES)
def test_pack_rows_matches_reference(r, m, d, seed):
    rng = np.random.RandomState(seed)
    vals = _vals(rng, r, d)
    idx = rng.randint(-3, r + 3, m).astype(np.int32)
    idx[0], idx[-1] = -1, r                    # both edges out of range
    ok = rng.randint(0, 2, m).astype(bool)
    want = RR.pack_rows_ref(jnp.asarray(vals), jnp.asarray(idx),
                            jnp.asarray(ok))
    pallas = pack_rows_pallas(jnp.asarray(vals), jnp.asarray(idx),
                              jnp.asarray(ok), block_m=16, block_src=16)
    for okt in (_t(ok), _t(ok.astype(np.int32))):
        for idxt in (_t(idx), _t(idx.astype(np.int64))):
            _same(want, pallas, TR.pack_rows_ref(_t(vals), idxt, okt),
                  TK.pack_rows(_t(vals), idxt, okt))


def test_pack_rows_all_masked_and_empty():
    vals = np.ones((9, 2), np.int64)
    idx = np.arange(9, dtype=np.int32)
    ok = np.zeros(9, bool)
    want = RR.pack_rows_ref(jnp.asarray(vals), jnp.asarray(idx),
                            jnp.asarray(ok))
    got = TK.pack_rows(_t(vals), _t(idx), _t(ok))
    _same(want, got, np.zeros((9, 2), np.int64))
    empty = TK.pack_rows(torch.zeros((0, 3), dtype=torch.int64),
                         _t(np.array([0, -1, 2], np.int32)),
                         _t(np.ones(3, bool)))
    _same(empty, np.zeros((3, 3), np.int64))


@pytest.mark.parametrize("r,m,d,repl,seed", [
    (1, 1, 1, 1, 0), (5, 17, 2, 3, 1), (20, 80, 3, 6, 2), (33, 70, 4, 2, 3),
    (9, 50, 1, 8, 4), (60, 13, 2, 5, 5)])
def test_replicate_scatter_matches_reference(r, m, d, repl, seed):
    rng = np.random.RandomState(seed)
    vals = _vals(rng, r, d)
    vidx = rng.randint(-3, r * repl + 5, m).astype(np.int32)
    vidx[0] = -1                               # the pad sentinel
    ok = rng.randint(0, 2, m).astype(bool)
    want = RR.replicate_scatter_ref(jnp.asarray(vals), jnp.asarray(vidx),
                                    jnp.asarray(ok), repl)
    pallas = replicate_scatter_pallas(jnp.asarray(vals), jnp.asarray(vidx),
                                      jnp.asarray(ok), repl,
                                      block_m=16, block_src=16)
    _same(want, pallas,
          TR.replicate_scatter_ref(_t(vals), _t(vidx), _t(ok), repl),
          TK.replicate_scatter(_t(vals), _t(vidx), _t(ok), repl))


def test_replicate_scatter_repl_one_is_pack_rows():
    rng = np.random.RandomState(0)
    vals = _vals(rng, 20, 3)
    idx = rng.randint(-2, 22, 33).astype(np.int32)
    ok = rng.randint(0, 2, 33).astype(bool)
    _same(TK.pack_rows(_t(vals), _t(idx), _t(ok)),
          TK.replicate_scatter(_t(vals), _t(idx), _t(ok), 1),
          pack_rows_pallas(jnp.asarray(vals), jnp.asarray(idx),
                           jnp.asarray(ok), block_m=8, block_src=8))


def test_replicate_scatter_each_replica_lands():
    repl, r = 3, 5
    vals = (np.arange(r, dtype=np.int64) * 10)[:, None]
    vidx = np.arange(r * repl, dtype=np.int32)
    ok = np.ones(r * repl, bool)
    _same(TK.replicate_scatter(_t(vals), _t(vidx), _t(ok), repl),
          np.repeat(np.arange(r) * 10, repl)[:, None].astype(np.int64))


@pytest.mark.parametrize("m,d,seed", [(1, 1, 0), (17, 3, 1), (70, 5, 2),
                                      (129, 10, 3), (256, 2, 4)])
def test_unpack_cols_matches_reference(m, d, seed):
    rng = np.random.RandomState(seed)
    buf = _vals(rng, m, d)
    want = RR.unpack_cols_ref(jnp.asarray(buf))
    pallas = unpack_cols_pallas(jnp.asarray(buf), block_t=16)
    got = TK.unpack_cols(_t(buf))
    assert got.is_contiguous()
    _same(want, pallas, TR.unpack_cols_ref(_t(buf)), got)


@pytest.mark.parametrize("n,n_heavy,seed,shuffle", [
    (1, 0, 0, False), (70, 12, 1, False), (33, 40, 2, True),
    (64, 5, 3, True), (17, 1, 4, False), (50, 12, 5, True)])
def test_member_mask_matches_reference(n, n_heavy, seed, shuffle):
    """INT64_MAX never matches as a key or as a heavy slot; the kernel's
    contract holds for an unsorted set, and on a sorted one it equals
    the searchsorted path of ``skew.is_member``."""
    from repro.core.skew import is_member as ref_is_member
    from repro_torch.core.skew import is_member
    rng = np.random.RandomState(seed)
    keys = rng.randint(-40, 40, n).astype(np.int64)
    if n > 2:
        keys[rng.randint(0, n, max(n // 4, 1))] = I64_MAX
    heavy = np.full(40, I64_MAX, np.int64)
    heavy[:n_heavy] = np.sort(rng.choice(np.arange(-40, 40), size=n_heavy,
                                         replace=False))
    srt = heavy.copy()
    if shuffle:
        rng.shuffle(heavy)                     # I64_MAX padding in between
    want = RR.member_mask_ref(jnp.asarray(keys), jnp.asarray(heavy))
    pallas = member_mask_pallas(jnp.asarray(keys), jnp.asarray(heavy),
                                block_n=16)
    _same(want, pallas, TR.member_mask_ref(_t(keys), _t(heavy)),
          TK.member_mask(_t(keys), _t(heavy)),
          is_member(_t(keys), _t(srt)), is_member(_t(keys), _t(srt),
                                                  use_kernel=True),
          ref_is_member(jnp.asarray(keys), jnp.asarray(srt)))


def test_wrappers_refuse_other_devices():
    """A device with neither a kernel nor a plain version raises; the
    meta device (the dry-run's) takes the plain version."""
    other = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel"):
        TK._route(other, "unpack_cols")
    meta = torch.zeros((3, 2), dtype=torch.int64, device="meta")
    out = TK.unpack_cols(meta)
    assert out.device.type == "meta" and out.shape == (2, 3)


def test_cpu_calls_launch_nothing():
    TK.reset_launch_counts()
    rng = np.random.RandomState(0)
    vals = _vals(rng, 5, 2)
    idx = np.arange(5, dtype=np.int32)
    ok = np.ones(5, bool)
    TK.pack_rows(_t(vals), _t(idx), _t(ok))
    TK.replicate_scatter(_t(vals), _t(idx), _t(ok), 2)
    TK.unpack_cols(_t(vals))
    TK.member_mask(_t(idx.astype(np.int64)), _t(idx.astype(np.int64)))
    counts = TK.launch_counts()
    for k in ("pack_rows", "replicate_scatter", "unpack_cols",
              "member_mask"):
        assert counts[k] == 0, counts
