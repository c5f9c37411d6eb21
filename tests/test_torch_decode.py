"""The decode kernels' plain PyTorch versions (``repro_torch.kernels.ref``)
against the reference's kernels, bit for bit: its ``kernels.ops``
wrappers (the Pallas kernels in interpret mode, as ``test_kernels.py``
runs them on the CPU) and its jnp oracles, over the edge cases that
``chip_smoke.py`` also runs on the card and over sweeps like
``test_kernels.py``'s; plus the dispatch rules and the int64 wraparound
that the plain delta decode relies on. The CUDA kernels themselves are
tested in ``test_torch_cuda.py``."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as RK
from repro.kernels import ref as R
from repro.storage import encodings as RE
from repro_torch.kernels import decode as TD
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR
from repro_torch.obs import reset_telemetry
from repro_torch.storage import encodings as TE

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max
U64 = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def plain(name, args):
    return {"rle_expand": TR.rle_expand_ref,
            "delta_unpack": TR.delta_unpack_ref,
            "bitunpack": TR.bitunpack_ref,
            "dict_gather": TR.dict_gather_ref}[name](*args)


def reference(name, args):
    """(reference kernels.ops output, jnp oracle output) as numpy."""
    if name == "rle_expand":
        # the reference takes the runs as [starts, ends), which its
        # reader makes from the stored lengths
        v, lengths, n = args
        ends = np.cumsum(lengths.numpy().astype(np.int64))
        a = [jnp.asarray(x) for x in (v.numpy(), ends - lengths.numpy(),
                                      ends)]
        return (np.asarray(RK.rle_expand(*a, n)),
                np.asarray(R.rle_expand_ref(*a, n)))
    if name == "delta_unpack":
        z, first = args
        zj = jnp.asarray(z.numpy().astype(np.uint64))
        fj = jnp.asarray(np.array([first & U64], np.uint64))
        return (np.asarray(RK.delta_unpack(zj, fj)),
                np.asarray(R.delta_unpack_ref(zj, fj)))
    if name == "bitunpack":
        words, k, vpw, n, lo = args
        wj = jnp.asarray(words.numpy())
        return (np.asarray(RK.bitunpack(wj, k, vpw, n, lo)),
                np.asarray(R.bitunpack_ref(wj, k, vpw, n, lo)))
    values, codes = args
    vj = jnp.asarray(values.numpy())
    cj = jnp.asarray(codes.numpy().astype(np.int32))
    # the jnp oracle cannot gather from an empty dictionary; by the
    # contract every code is then out of range and gathers 0
    oracle = np.asarray(R.dict_gather_ref(vj, cj)) if values.shape[0] \
        else np.zeros(codes.shape[0], np.int64)
    return np.asarray(RK.dict_gather(vj, cj)), oracle


def assert_same(got: torch.Tensor, want: np.ndarray) -> None:
    g = got.numpy()
    assert g.dtype == np.int64 and want.dtype == np.int64, (g.dtype,
                                                            want.dtype)
    assert g.shape == want.shape, (g.shape, want.shape)
    assert np.array_equal(g, want), (g[:8], want[:8])


# ---------------------------------------------------------------------------
# the edge cases of chip_smoke phase 2
# ---------------------------------------------------------------------------

EDGE = chip_smoke.decode_edge_cases(CPU, large=False)


@pytest.mark.parametrize("case", range(len(EDGE)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(EDGE)])
def test_edge_cases_match_reference(case):
    name, args = EDGE[case]
    pallas, oracle = reference(name, args)
    got = plain(name, args)
    assert_same(got, oracle)
    assert_same(got, pallas)
    # the dispatch takes the plain version for CPU tensors
    assert_same(getattr(TK, name)(*args), oracle)


# ---------------------------------------------------------------------------
# sweeps (tests/test_kernels.py's decode sweeps, same sizes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_rle_expand_sweep(seed):
    rng = np.random.RandomState(seed)
    n, max_run = int(rng.randint(1, 301)), int(rng.randint(1, 10))
    lengths = []
    while sum(lengths) < n:
        lengths.append(rng.randint(1, max_run + 1))
    lengths[-1] -= sum(lengths) - n
    lengths = np.array([x for x in lengths if x], np.int32)
    values = rng.randint(I64_MIN, I64_MAX, lengths.size, dtype=np.int64)
    args = (torch.from_numpy(values), torch.from_numpy(lengths), n)
    pallas, oracle = reference("rle_expand", args)
    got = plain("rle_expand", args)
    assert_same(got, oracle)
    assert_same(got, pallas)
    assert np.array_equal(got.numpy(), np.repeat(values, lengths))


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_delta_unpack_sweep(seed, extreme):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 301))
    if extreme:
        a = rng.randint(I64_MIN, I64_MAX, n, dtype=np.int64)
    else:
        a = np.cumsum(rng.randint(-100, 100, n)).astype(np.int64)
    enc, blob = TE.encode_chunk(a, "delta")
    z = TE.unpack_members(enc, blob)["deltas"]
    args = (torch.from_numpy(z.copy()), int(enc["first"]))
    pallas, oracle = reference("delta_unpack", args)
    got = plain("delta_unpack", args)
    assert_same(got, oracle)
    assert_same(got, pallas)
    assert np.array_equal(got.numpy(), a)


@pytest.mark.parametrize("span_bits", [0, 1, 7, 15, 16])
def test_bitunpack_sweep(span_bits):
    rng = np.random.RandomState(span_bits)
    n = int(rng.randint(1, 301))
    a = (-37 + rng.randint(0, 1 << span_bits, n)).astype(np.int64)
    enc, blob = TE.encode_chunk(a, "bitpack")
    words = TE.unpack_members(enc, blob)["words"]
    args = (torch.from_numpy(words.copy()), enc["k"], enc["vpw"], enc["n"],
            enc["lo"])
    pallas, oracle = reference("bitunpack", args)
    got = plain("bitunpack", args)
    assert_same(got, oracle)
    assert_same(got, pallas)
    assert np.array_equal(got.numpy(), a)


@pytest.mark.parametrize("seed", range(5))
def test_dict_gather_sweep(seed):
    rng = np.random.RandomState(seed)
    n, card = int(rng.randint(1, 301)), int(rng.randint(1, 41))
    values = np.unique(rng.randint(I64_MIN, I64_MAX, card, dtype=np.int64))
    codes = rng.randint(0, values.size, n).astype(np.uint8)
    args = (torch.from_numpy(values), torch.from_numpy(codes))
    pallas, oracle = reference("dict_gather", args)
    got = plain("dict_gather", args)
    assert_same(got, oracle)
    assert_same(got, pallas)
    assert np.array_equal(got.numpy(), values[codes])


# ---------------------------------------------------------------------------
# int64 arithmetic the plain delta decode relies on
# ---------------------------------------------------------------------------

def test_cumsum_on_int64_wraps_at_the_extremes():
    """``torch.cumsum`` over int64 wraps modulo 2**64, as the modular
    uint64 prefix sum of the reference needs: at the extremes it equals
    numpy's uint64 cumsum bit for bit."""
    rng = np.random.RandomState(5)
    d = np.concatenate([[I64_MAX, I64_MAX, 1, I64_MIN, -1, I64_MIN],
                        rng.randint(I64_MIN, I64_MAX, 500,
                                    dtype=np.int64)]).astype(np.int64)
    with np.errstate(over="ignore"):
        want = np.cumsum(d.view(np.uint64), dtype=np.uint64).view(np.int64)
    got = torch.cumsum(torch.from_numpy(d), 0).numpy()
    assert np.array_equal(got, want)
    assert got[1] == -2 and got[2] == -1          # I64_MAX + I64_MAX + 1


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64])
def test_delta_unpack_reads_every_stored_width(dtype):
    """The widest zigzag code of each width decodes as the reference's
    NumPy codec does (the top bit of a uint64 code included)."""
    top = np.iinfo(dtype).max
    z = np.array([0, top, top - 1, 1, 2, top], dtype)
    first = I64_MAX - 1
    enc = {"codec": "delta", "first": first & U64, "w": str(np.dtype(dtype)),
           "dtype": "int64"}
    enc["members"], blob = RE._pack_members({"deltas": z})
    want = RE.decode_chunk(enc, blob)
    got = TR.delta_unpack_ref(torch.from_numpy(z), first)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_dispatch_counts_only_launches_and_writes_out():
    TK.reset_launch_counts()
    for name, args in EDGE:
        want = plain(name, args)
        out = torch.full(want.shape, 7, dtype=torch.int64)
        got = getattr(TK, name)(*args, out=out)
        assert got is out and torch.equal(out, want), name
    assert all(v == 0 for v in TK.launch_counts().values()), \
        TK.launch_counts()
    # the meta device (the dry-run's) takes the plain versions; a device
    # with neither a kernel nor a plain version raises
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    for out in (TK.dict_gather(meta, meta),
                TK.delta_unpack(meta.to(torch.uint8), 0)):
        assert out.device.type == "meta" and out.shape == (4,)
    with pytest.raises(ValueError, match="no kernel"):
        TK._route(SimpleNamespace(device=torch.device("xpu")),
                  "dict_gather")


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never computes on the CPU: it checks its inputs
    before it builds or launches anything."""
    v = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        TD.rle_expand_cuda(v, v.to(torch.int32), 10)
    with pytest.raises(ValueError):
        TD.delta_unpack_cuda(v.to(torch.uint8), 0)
    with pytest.raises(ValueError):
        TD.bitunpack_cuda(v.to(torch.uint32), 4, 8, 4, 0)
    with pytest.raises(ValueError):
        TD.dict_gather_cuda(v, v)
