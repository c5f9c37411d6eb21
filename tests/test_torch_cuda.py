"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a GPU and skips without one. The file imports no
JAX and nothing of the reference, so it also runs on a machine that has
only PyTorch (the conftest's reference fixture then has to be left out):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The helpers at the top are shared with ``test_torch_kernels.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.kernels import decode as TD  # noqa: E402
from repro_torch.kernels import gather_join as TG  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import segment_fused as TSF  # noqa: E402
from repro_torch.obs import reset_telemetry  # noqa: E402

KERNELS = ["segment_sum_first", "merge_positions", "gather_rows"]
DECODE = ["rle_expand", "delta_unpack", "bitunpack", "dict_gather"]


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def to_np(x) -> list:
    return [a.cpu().numpy() for a in (x if isinstance(x, tuple) else (x,))]


def assert_bits_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), (g, w)


def plain(name, args):
    return {"segment_sum_first": TR.segment_sum_first_ref,
            "merge_positions": TR.merge_positions_ref,
            "gather_rows": TR.gather_rows_ref}[name](*args)


def sweep_args(name, seed):
    """Random dispatch arguments at the sizes of ``test_kernels.py``'s
    sweeps (CPU tensors)."""
    rng = np.random.RandomState(seed)
    if name == "segment_sum_first":
        n, d, S, k = (int(rng.randint(1, 80)), int(rng.randint(1, 4)),
                      int(rng.randint(1, 40)), int(rng.randint(1, 4)))
        seg = np.sort(rng.randint(0, S, n)).astype(np.int32)
        vals = rng.randint(0, 100, size=(n, d)).astype(np.float32)
        keys = rng.randint(-2 ** 62, 2 ** 62, size=(n, k)).astype(np.int64)
        return (torch.from_numpy(vals), torch.from_numpy(keys),
                torch.from_numpy(seg), S)
    if name == "merge_positions":
        r, n = int(rng.randint(1, 100)), int(rng.randint(1, 80))
        srk = np.sort(rng.randint(-20, 20, r)).astype(np.int64)
        q = rng.randint(-25, 25, n).astype(np.int64)
        return torch.from_numpy(srk), torch.from_numpy(q)
    r, n, d = (int(rng.randint(1, 60)), int(rng.randint(1, 60)),
               int(rng.randint(1, 5)))
    vals = rng.randint(-2 ** 62, 2 ** 62, size=(r, d)).astype(np.int64)
    idx = rng.randint(-3, r + 3, n).astype(np.int64)
    return torch.from_numpy(vals), torch.from_numpy(idx)


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_edge_cases_bit_exact(cuda):
    for name, args in chip_smoke.edge_cases(cuda, large=True):
        kern, plain_fn, _, _ = chip_smoke.kernel_fns(name, args)
        assert chip_smoke.max_abs_err(kern(), plain_fn()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("seed", range(5))
def test_sweep_bit_exact_and_counted(cuda, name, seed):
    args = tuple(a.to(cuda) if torch.is_tensor(a) else a
                 for a in sweep_args(name, seed))
    before = TK.launch_counts()[name]
    got = getattr(TK, name)(*args)
    assert TK.launch_counts()[name] == before + 1
    assert_bits_equal(to_np(got), to_np(plain(name, args)))


@pytest.mark.cuda
def test_wrappers_check_inputs(cuda):
    v = torch.zeros((4, 1), dtype=torch.float64, device=cuda)
    k = torch.zeros((4, 1), dtype=torch.int64, device=cuda)
    s = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        TSF.segment_sum_first_cuda(v, k, s, 4)
    with pytest.raises(TypeError):
        TG.merge_positions_cuda(s, s)
    with pytest.raises(ValueError):
        TSF.segment_sum_first_cuda(v.float()[::2], k[::2], s[::2], 4)
    lanes_major = torch.zeros((2, 4), dtype=torch.int64, device=cuda).t()
    with pytest.raises(TypeError):
        TG.gather_rows_cuda(lanes_major, s.long())


@pytest.mark.cuda
@pytest.mark.parametrize("domain_elimination", [True, False])
def test_slice_on_card_equals_port_on_cpu(cuda, domain_elimination):
    """n2n level 2 on the card through the kernels equals the port's
    plain run on the CPU, bag for bag."""
    from repro_torch.columnar.table import FlatBag, env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.core.unnesting import Catalog
    env_np = chip_smoke.shred_ncop2(chip_smoke.gen_tpch_columns(3000, 1))
    part_t, ncop2_t = chip_smoke.tpch_types()
    q = chip_smoke.nested_to_nested_query(2, "NCOP2", ncop2_t, part_t)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]),
                         {"NCOP2": ncop2_t, "Part": part_t},
                         domain_elimination=domain_elimination)
    cp = CG.compile_program(sp, Catalog(unique_keys={"Part__F": ("pid",)}))
    TK.reset_launch_counts()
    gpu = CG.run_flat_program(cp, env_from_numpy(env_np, cuda),
                              ExecSettings(use_kernel=True))
    assert all(TK.launch_counts()[k] > 0 for k in KERNELS)
    cpu = CG.run_flat_program(cp, env_from_numpy(env_np, "cpu"),
                              ExecSettings(use_kernel=False))
    for name in cp.outputs:
        host = FlatBag({c: a.cpu() for c, a in gpu[name].data.items()},
                       gpu[name].valid.cpu())
        chip_smoke.bags_bit_equal(cpu[name], host, name)


# ---------------------------------------------------------------------------
# the decode kernels and the stored path
# ---------------------------------------------------------------------------

def decode_sweep_args(name, seed, dev):
    """Random dispatch arguments for a decode kernel, through the
    codecs where one produces them (tensors on ``dev``)."""
    from repro_torch.storage import encodings as E
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 5000))
    if name == "rle_expand":
        lengths = rng.randint(1, 9, n).astype(np.int32)
        vals = rng.randint(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
        T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return T(vals), T(lengths), int(lengths.sum())
    if name == "delta_unpack":
        a = np.cumsum(rng.randint(-(10 ** (seed + 1)), 10 ** (seed + 1),
                                  n)).astype(np.int64)
        enc, blob = E.encode_chunk(a, "delta")
        z = E.unpack_members(enc, blob)["deltas"].copy()
        return torch.from_numpy(z).to(dev), int(enc["first"])
    if name == "bitunpack":
        a = (-5 + rng.randint(0, 1 << (3 * seed + 1), n)).astype(np.int64)
        enc, blob = E.encode_chunk(a, "bitpack")
        w = E.unpack_members(enc, blob)["words"].copy()
        return (torch.from_numpy(w).to(dev), enc["k"], enc["vpw"],
                enc["n"], enc["lo"])
    r = int(rng.randint(1, 9000))
    vals = rng.randint(-2 ** 63, 2 ** 63 - 1, r, dtype=np.int64)
    codes = rng.randint(-1, r + 1, n).astype(np.int32)
    return torch.from_numpy(vals).to(dev), torch.from_numpy(codes).to(dev)


@pytest.mark.cuda
def test_decode_edge_cases_bit_exact(cuda):
    for name, args in chip_smoke.decode_edge_cases(cuda, large=True):
        kern, plain_fn, _, _ = chip_smoke.kernel_fns(name, args)
        assert chip_smoke.max_abs_err(kern(), plain_fn()) == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", DECODE)
@pytest.mark.parametrize("seed", range(4))
def test_decode_sweep_bit_exact_and_counted(cuda, name, seed):
    args = decode_sweep_args(name, seed, cuda)
    _, plain_fn, _, _ = chip_smoke.kernel_fns(name, args)
    before = TK.launch_counts()[name]
    got = getattr(TK, name)(*args)
    assert TK.launch_counts()[name] == before + 1
    assert_bits_equal(to_np(got), to_np(plain_fn()))


@pytest.mark.cuda
def test_decode_wrappers_check_inputs(cuda):
    v = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        TD.dict_gather_cuda(v.float(), v)
    with pytest.raises(TypeError):
        TD.delta_unpack_cuda(v.to(torch.int32), 0)
    with pytest.raises(ValueError):
        TD.bitunpack_cuda(torch.empty(4, dtype=torch.uint32, device=cuda),
                          17, 2, 4, 0)
    with pytest.raises(ValueError):
        TD.rle_expand_cuda(v, v[:2].to(torch.int32), 4)
    with pytest.raises(TypeError):
        TD.rle_expand_cuda(v, v, 4)
    with pytest.raises(TypeError):
        TD.rle_expand_cuda(v[:1], v[:1].to(torch.int32) + 4, 4,
                           out=torch.empty(3, dtype=torch.int64,
                                           device=cuda))


@pytest.mark.cuda
def test_decode_calls_without_rows_launch_nothing(cuda):
    """A call with no rows to write returns its empty output and leaves
    its launch counter as it was."""
    e64 = torch.empty(0, dtype=torch.int64, device=cuda)
    calls = {"rle_expand": lambda: TK.rle_expand(
                 e64, torch.empty(0, dtype=torch.int32, device=cuda), 0),
             "delta_unpack": lambda: TK.delta_unpack(
                 torch.empty(0, dtype=torch.uint8, device=cuda), 5),
             "bitunpack": lambda: TK.bitunpack(
                 torch.empty(0, dtype=torch.uint32, device=cuda), 6, 5, 0,
                 1),
             "dict_gather": lambda: TK.dict_gather(
                 torch.arange(3, device=cuda),
                 torch.empty(0, dtype=torch.uint8, device=cuda))}
    TK.reset_launch_counts()
    for name, call in calls.items():
        got = call()
        assert got.shape == (0,) and got.dtype == torch.int64, name
    assert all(v == 0 for v in TK.launch_counts().values()), \
        TK.launch_counts()


@pytest.mark.cuda
def test_stored_path_on_card_equals_port_on_cpu(cuda, tmp_path):
    """The n2n query served from an auto-encoded dataset: on the card,
    decoded by the kernels, one-shot and streamed, equals the port on
    the CPU (bit for bit one-shot; as bags streamed)."""
    from repro_torch.columnar.table import FlatBag, env_from_numpy
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.core.unnesting import Catalog
    from repro_torch.serve import QueryService
    from repro_torch.storage import DatasetWriter, StoredDataset
    env_np = chip_smoke.shred_ncop2(chip_smoke.gen_tpch_columns(6000, 4))
    part_t, ncop2_t = chip_smoke.tpch_types()
    types = {"NCOP2": ncop2_t, "Part": part_t}
    w = DatasetWriter(str(tmp_path), "tpch", types, chunk_rows=1024)
    w.write_parts(env_from_numpy(env_np, "cpu"))
    q = chip_smoke.nested_to_nested_query(2, "NCOP2", ncop2_t, part_t)
    prog = N.Program([N.Assignment("Q", q)])
    cat = Catalog(unique_keys={"Part__F": ("pid",)})
    out = {}
    for dev, kernel in ((cuda, True), ("cpu", False)):
        ds = StoredDataset(w.dir, device=dev)
        svc = QueryService(types, catalog=cat,
                           settings=ExecSettings(use_kernel=kernel))
        TK.reset_launch_counts()
        one = svc.execute_stored(prog, ds)
        counts = TK.launch_counts()
        streamed = svc.execute_stored_streaming(prog, ds, morsel_rows=1024,
                                                root="NCOP2")
        out[str(dev)] = (one, streamed, counts)
    gpu, cpu = out["cuda"], out["cpu"]
    assert all(gpu[2][k] > 0 for k in ("rle_expand", "delta_unpack",
                                       "dict_gather", "segment_sum_first"))
    assert all(v == 0 for v in cpu[2].values())
    for name in cpu[0]:
        host = FlatBag({c: a.cpu() for c, a in gpu[0][name].data.items()},
                       gpu[0][name].valid.cpu())
        chip_smoke.bags_bit_equal(cpu[0][name], host, name)
        assert torch.equal(chip_smoke.sorted_rows(gpu[1][name]).cpu(),
                           chip_smoke.sorted_rows(cpu[1][name])), name
