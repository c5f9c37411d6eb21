"""The ported kernels: their plain PyTorch versions against the
reference's Pallas kernels (interpret mode) and its jnp oracles, bit for
bit, over sweeps like ``test_kernels.py`` and over the edge cases that
``chip_smoke.py`` also runs on the card; and the dispatch rules. The
CUDA kernels themselves are tested in ``test_torch_cuda.py``."""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels import ref as R
from repro.kernels.gather_join import gather_rows_pallas, \
    merge_positions_pallas
from repro.kernels import ops as RK
from repro.kernels.segment_fused import segment_sum_first_pallas
from repro.kernels.segment_reduce import segment_reduce_pallas
from repro_torch.kernels import gather_join as TG
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR
from repro_torch.kernels import segment_fused as TSF
from repro_torch.kernels import segment_reduce as TSR
from repro_torch.obs import reset_telemetry

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402
from test_torch_cuda import assert_bits_equal, plain, sweep_args, to_np  # noqa: E402,E501

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def _np(x):
    return [np.asarray(a) for a in (x if isinstance(x, tuple) else (x,))]


def _reference_outputs(name, args):
    """(Pallas interpret, jnp oracle) outputs of the reference kernel."""
    a = [jnp.asarray(x.numpy()) if torch.is_tensor(x) else x for x in args]
    if name == "segment_sum_first":
        return (_np(segment_sum_first_pallas(*a, block_rows=16,
                                             block_segs=8)),
                _np(R.segment_sum_first_ref(*a)))
    if name == "merge_positions":
        return (_np(merge_positions_pallas(*a, block_q=16, block_r=16)),
                _np(R.merge_positions_ref(*a)))
    return (_np(gather_rows_pallas(a[0], a[1], block_n=16, block_src=16)),
            _np(R.gather_rows_ref(a[0], a[1].astype(jnp.int32))))


# ---------------------------------------------------------------------------
# plain versions vs the reference, on the CPU
# ---------------------------------------------------------------------------

EDGE = chip_smoke.edge_cases(CPU, large=False)
REDUCE = chip_smoke.reduce_edge_cases(CPU, large=False)


@pytest.mark.parametrize("case", range(len(EDGE)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(EDGE)])
def test_edge_cases_match_reference(case):
    name, args = EDGE[case]
    pallas, oracle = _reference_outputs(name, args)
    got = to_np(plain(name, args))
    assert_bits_equal(got, oracle)
    assert_bits_equal(got, pallas)
    # the dispatch takes the plain version for CPU tensors
    assert_bits_equal(to_np(getattr(TK, name)(*args)), oracle)


@pytest.mark.parametrize("name", ["segment_sum_first", "merge_positions",
                                  "gather_rows"])
@pytest.mark.parametrize("seed", range(5))
def test_sweep_matches_reference(name, seed):
    args = sweep_args(name, seed)
    pallas, oracle = _reference_outputs(name, args)
    got = to_np(plain(name, args))
    assert_bits_equal(got, oracle)
    assert_bits_equal(got, pallas)


def test_dispatch_counts_only_launches_and_refuses_other_devices():
    TK.reset_launch_counts()
    for name, args in EDGE:
        getattr(TK, name)(*args)
    for name, args in REDUCE:
        TK.segment_reduce(*args)
    assert TK.launch_counts() == {
        "segment_reduce": 0, "segment_sum_first": 0, "merge_positions": 0, "gather_rows": 0,
        "rle_expand": 0, "delta_unpack": 0, "bitunpack": 0,
        "dict_gather": 0, "member_mask": 0, "pack_rows": 0,
        "unpack_cols": 0, "replicate_scatter": 0}
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        TK.merge_positions(meta, meta)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never computes on the CPU: it checks its inputs
    before it builds or launches anything."""
    name, args = EDGE[0]
    with pytest.raises(ValueError):
        TSF.segment_sum_first_cuda(*args)
    with pytest.raises(ValueError):
        TSR.segment_reduce_cuda(*REDUCE[0][1])
    sk = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        TG.merge_positions_cuda(sk, sk)
    with pytest.raises(ValueError):
        TG.gather_rows_cuda(sk[:, None], sk)


# ---------------------------------------------------------------------------
# segment_reduce: the plain version against the reference's Pallas kernel
# (interpret mode) and its jnp oracle, as tests/test_kernels.py runs them
# ---------------------------------------------------------------------------

def _reduce_reference(vals, seg, S, block_rows, block_segs):
    """(Pallas interpret, jnp oracle) of the reference's segment_reduce;
    the Pallas kernel takes no empty shapes (None then)."""
    v, g = jnp.asarray(vals.numpy()), jnp.asarray(seg.numpy())
    oracle = np.asarray(R.segment_reduce_ref(v, g, S))
    if S == 0 or vals.shape[0] == 0:
        return None, oracle
    return np.asarray(segment_reduce_pallas(
        v, g, S, block_rows=block_rows, block_segs=block_segs)), oracle


@pytest.mark.parametrize("case", range(len(REDUCE)),
                         ids=[f"segment_reduce-{i}" for i in range(len(REDUCE))])
def test_segment_reduce_edge_cases_match_reference(case):
    """Every edge case chip_smoke.py holds the kernel to, bit for bit:
    ids out of range at either end and between two rows of one id (all
    three versions sum across it), S = 0, n = 0, d > 1."""
    _, (vals, seg, S) = REDUCE[case]
    pallas, oracle = _reduce_reference(vals, seg, S, 16, 8)
    got = TR.segment_reduce_ref(vals, seg, S).numpy()
    assert_bits_equal([got], [oracle])
    if pallas is not None:
        assert_bits_equal([got], [pallas])
    assert_bits_equal([TK.segment_reduce(vals, seg, S).numpy()], [oracle])


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 200), st.integers(1, 5), st.integers(1, 50),
       st.integers(0, 3))
def test_segment_reduce_hypothesis(n, d, num_segments, seed):
    rng = np.random.RandomState(seed)
    seg = np.sort(rng.randint(0, num_segments, n)).astype(np.int32)
    vals = rng.randn(n, d).astype(np.float32)
    pallas, oracle = _reduce_reference(torch.from_numpy(vals),
                                       torch.from_numpy(seg), num_segments,
                                       32, 16)
    got = TK.segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg),
                            num_segments).numpy()
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=1e-4)


def test_segment_reduce_out_of_range_dropped():
    seg = torch.tensor([-1, 0, 0, 1, 5], dtype=torch.int32)
    got = TK.segment_reduce(torch.ones((5, 1)), seg, 2)
    assert got[:, 0].tolist() == [2.0, 1.0]


@pytest.mark.parametrize("n,num_segments", [(33, 7), (32, 7), (33, 8),
                                            (5, 50)])
def test_segment_reduce_padding_edges(n, num_segments):
    rng = np.random.RandomState(7)
    seg = np.sort(rng.randint(0, num_segments, n)).astype(np.int32)
    vals = rng.randint(0, 50, size=(n, 3)).astype(np.float32)
    pallas, oracle = _reduce_reference(torch.from_numpy(vals),
                                       torch.from_numpy(seg), num_segments,
                                       16, 8)
    got = TK.segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg),
                            num_segments).numpy()
    # integer-valued floats: every summation order is exact -> bitwise
    assert_bits_equal([got], [pallas])
    assert_bits_equal([got], [oracle])


def test_segment_reduce_all_invalid():
    seg = torch.full((19,), -1, dtype=torch.int32)
    got = TK.segment_reduce(torch.ones((19, 2)), seg, 6)
    assert got.shape == (6, 2) and (got == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_reduce_dispatch_squeezes_and_casts_like_reference(dtype):
    """values (n,) come back (S,), in their own dtype, summed in f32."""
    rng = np.random.RandomState(3)
    seg = np.sort(rng.randint(-1, 9, 40)).astype(np.int32)
    vals = rng.randint(0, 20, 40).astype(np.float64)
    got = TK.segment_reduce(torch.from_numpy(vals).to(dtype),
                            torch.from_numpy(seg), 8)
    want = np.asarray(RK.segment_reduce(
        jnp.asarray(vals, dtype=jnp.float32 if dtype == torch.float32
                    else jnp.float64), jnp.asarray(seg), 8))
    assert got.dtype == dtype and got.shape == (8,)
    assert_bits_equal([got.numpy()], [want])
