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

import jax.numpy as jnp

from repro.kernels import ref as R
from repro.kernels.gather_join import gather_rows_pallas, \
    merge_positions_pallas
from repro.kernels.segment_fused import segment_sum_first_pallas
from repro_torch.kernels import gather_join as TG
from repro_torch.kernels import ops as TK
from repro_torch.kernels import segment_fused as TSF
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
    assert TK.launch_counts() == {
        "segment_sum_first": 0, "merge_positions": 0, "gather_rows": 0,
        "rle_expand": 0, "delta_unpack": 0, "bitunpack": 0,
        "dict_gather": 0}
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        TK.merge_positions(meta, meta)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never computes on the CPU: it checks its inputs
    before it builds or launches anything."""
    name, args = EDGE[0]
    with pytest.raises(ValueError):
        TSF.segment_sum_first_cuda(*args)
    sk = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        TG.merge_positions_cuda(sk, sk)
    with pytest.raises(ValueError):
        TG.gather_rows_cuda(sk[:, None], sk)
