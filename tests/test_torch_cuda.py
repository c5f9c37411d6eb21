"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a GPU and skips without one. The file imports no
JAX and nothing of the reference, so it also runs on a machine that has
only PyTorch (the conftest's reference fixture then has to be left out):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The helpers at the top are shared with ``test_torch_kernels.py``, and
the float-key spec with the parity tests (``test_torch_queries.py``).
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
SHUFFLE = ["member_mask", "pack_rows", "unpack_cols", "replicate_scatter"]


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
# a join on a float key (pid, w): the reference casts the second key
# column with astype(uint64), so every negative w joins every other one
# ---------------------------------------------------------------------------

FK_PARTS = [{"pid": 1, "w": -5.0, "pname": 100},
            {"pid": 1, "w": 2.0, "pname": 101}]
FK_ORD = [{"oid": 1, "oparts": [{"pid": 1, "w": -3.0, "qty": 1.0},
                                {"pid": 1, "w": 2.0, "qty": 4.0}]}]
# the reference's answer, which the oracle does not give (-3.0 != -5.0)
FK_REFERENCE_ROWS = [{"oid": 1, "parts": [{"pname": 100, "total": 1.0},
                                          {"pname": 101, "total": 4.0}]}]

FLOAT_KEY_VALUES = np.array(
    [np.nan, 0.0, -0.0, -3.0, -5.0, 2.1, 2.9, 1e30, -1e30, np.inf, -np.inf,
     2.0 ** 63, 2.0 ** 63 + 4096.0, 1.5 * 2.0 ** 63, 2.0 ** 64, -0.5, 0.5],
    dtype=np.float64)


def float_key_query(N):
    """(query, input types): for o in Ord, SumBy_pname over the parts
    joined on op.pid == p.pid && op.w == p.w, w REAL."""
    part_t = N.bag(N.tuple_t(pid=N.INT, w=N.REAL, pname=N.INT))
    ord_t = N.bag(N.tuple_t(
        oid=N.INT, oparts=N.bag(N.tuple_t(pid=N.INT, w=N.REAL,
                                          qty=N.REAL))))
    Ord, Part = N.Var("Ord", ord_t), N.Var("Part", part_t)

    def parts(o):
        joined = N.for_in("op", o.oparts, lambda op:
            N.for_in("p", Part, lambda p:
                N.IfThen(N.BoolOp("&&", op.pid.eq(p.pid), op.w.eq(p.w)),
                         N.Singleton(N.record(pname=p.pname,
                                              total=op.qty)))))
        return N.SumBy(joined, keys=("pname",), values=("total",))

    Q = N.for_in("o", Ord, lambda o: N.Singleton(N.record(
        oid=o.oid, parts=parts(o))))
    return Q, {"Ord": ord_t, "Part": part_t}


def float_key_data(n_orders: int, seed: int) -> dict:
    """Parts over pids 0-3 and every w of FLOAT_KEY_VALUES; orders whose
    parts draw pid and w from the same values and from their negatives,
    NaN, infinities and truncated neighbours included."""
    rng = np.random.RandomState(seed)
    ws = FLOAT_KEY_VALUES
    parts = [{"pid": p, "w": float(w), "pname": 100 + 20 * p + i}
             for p in range(4) for i, w in enumerate(ws)]
    draw = np.concatenate([ws, -ws, [2.5, -2.5, 7e29, 3.0]])
    orders = [{"oid": o, "oparts": [
        {"pid": int(rng.randint(0, 4)), "w": float(rng.choice(draw)),
         "qty": float(rng.randint(1, 9))}
        for _ in range(int(rng.randint(0, 6)))]} for o in range(n_orders)]
    return {"Ord": orders, "Part": parts}


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


def launched_once_twice_alike(name, args):
    """Launch ``name``'s kernel through its dispatch on ``args``: counted
    once, bit-exact against the plain version, and a second launch
    bit-identical to the first."""
    _, plain_fn, _, _ = chip_smoke.kernel_fns(name, args)
    k = {"rle_expand": 3, "delta_unpack": 2}.get(name, len(args))
    pos, kw = args[:k], ({"out": args[k]} if len(args) > k else {})
    before = TK.launch_counts()[name]
    got = to_np(getattr(TK, name)(*pos, **kw))
    got = [g.copy() for g in got]               # ``out`` is written again
    assert TK.launch_counts()[name] == before + 1
    assert_bits_equal(got, to_np(plain_fn()))
    assert_bits_equal(got, to_np(getattr(TK, name)(*pos, **kw)))


@pytest.mark.cuda
def test_gather_rows_tile_edges_bit_exact_repeatable_counted(cuda):
    """gather_rows around its 1024-row tiles (``gather_tile_cases``: one,
    two and more tiles than the grid's blocks, d from 1 to 12, ids -1,
    r, INT64_MAX and INT64_MIN, -0.0 and NaN payloads, values and ids
    viewed off a 16-byte boundary)."""
    for name, args in chip_smoke.gather_tile_cases(
            np.random.RandomState(9), cuda):
        launched_once_twice_alike(name, args)


@pytest.mark.cuda
def test_rle_expand_tile_edges_bit_exact_repeatable_counted(cuda):
    """rle_expand around its scan and row tiles (``rle_card_cases``: one
    run of more than 2^20 rows, runs of length 1, runs across row tiles,
    more scan tiles than resident blocks, r = 1, ``out`` off a 16-byte
    boundary)."""
    for name, args in chip_smoke.rle_card_cases(np.random.RandomState(12),
                                                cuda):
        launched_once_twice_alike(name, args)


@pytest.mark.cuda
def test_delta_unpack_tile_edges_bit_exact_repeatable_counted(cuda):
    """delta_unpack around its 4096-row tiles (``delta_card_cases``: every
    width with z 0-15 bytes off a 16-byte boundary, sums that wrap,
    ``first`` at the int64 extremes, look-backs over more than one
    window, ``out`` off a 16-byte boundary)."""
    for name, args in chip_smoke.delta_card_cases(np.random.RandomState(14),
                                                  cuda):
        launched_once_twice_alike(name, args)


@pytest.mark.cuda
def test_member_mask_paths_bit_exact_repeatable_counted(cuda):
    """member_mask on both paths (``member_card_cases``: sets of 0 to 256
    keys sorted by each block, with duplicates and padding between;
    257 and 1,000 keys staged; keys 8 bytes off a 16-byte boundary; more
    keys than one round of the grid)."""
    for name, args in chip_smoke.member_card_cases(
            np.random.RandomState(13), cuda):
        launched_once_twice_alike(name, args)


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
    q = chip_smoke.nested_to_nested_query(2, "NCOP2", ncop2_t)
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


@pytest.mark.cuda
def test_float_key_casts_on_card_equal_cpu(cuda):
    """The XLA-like casts of float key columns and ``combine64`` over
    them give on the card the bits they give on the CPU (which the
    parity tests hold to the reference's)."""
    from repro_torch.exec import hashing as H
    x = np.concatenate([FLOAT_KEY_VALUES, -FLOAT_KEY_VALUES])
    for dtype in (torch.float64, torch.float32):
        cpu = torch.as_tensor(x).to(dtype)
        gpu = cpu.to(cuda)
        for f in (H.to_int64_like_xla, H.to_uint64_bits_like_xla):
            assert torch.equal(f(gpu).cpu(), f(cpu)), (f.__name__, dtype)
        cols = [cpu, cpu.flip(0), cpu.roll(5)]
        assert torch.equal(H.combine64([c.to(cuda) for c in cols]).cpu(),
                           H.combine64(cols)), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("unique", [False, True],
                         ids=["general_join", "fk_join"])
def test_float_key_spec_on_card(cuda, unique):
    """The float-key join through the kernels on the card: the spec
    gives the reference's rows, and orders over every edge value (NaN,
    +-0.0, negatives, +-1e30, the infinities, [2^63, 2^64), 2.1 beside
    2.9) give the bits of the port's plain run on the CPU."""
    from repro_torch.columnar.table import FlatBag
    from repro_torch.core import codegen as CG
    from repro_torch.core import interpreter as I
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.core.unnesting import Catalog
    q, types = float_key_query(N)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]), types)
    cp = CG.compile_program(sp, Catalog(
        unique_keys={"Part__F": ("pid", "w")} if unique else {}))
    man = sp.manifests["Q"]
    for inputs, want in (({"Ord": FK_ORD, "Part": FK_PARTS},
                          FK_REFERENCE_ROWS),
                         (float_key_data(24, 0), None),
                         (float_key_data(24, 1), None)):
        gpu = CG.run_flat_program(
            cp, CG.columnar_shred_inputs(inputs, types, device=cuda),
            ExecSettings(use_kernel=True))
        gpu = {n: FlatBag({c: a.cpu() for c, a in b.data.items()},
                          b.valid.cpu()) for n, b in gpu.items()}
        cpu = CG.run_flat_program(
            cp, CG.columnar_shred_inputs(inputs, types, device="cpu"),
            ExecSettings(use_kernel=False))
        for name in cp.outputs:
            chip_smoke.bags_bit_equal(cpu[name], gpu[name], name)
        if want is not None:
            rows = CG.parts_to_rows(
                {(): gpu[man.top], **{p: gpu[n]
                                      for p, n in man.dicts.items()}},
                q.ty)
            assert I.bags_equal(rows, want), rows


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
    q = chip_smoke.nested_to_nested_query(2, "NCOP2", ncop2_t)
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


# ---------------------------------------------------------------------------
# the packed-shuffle kernels and the distributed route
# ---------------------------------------------------------------------------

def shuffle_sweep_args(name, seed, dev):
    """Random dispatch arguments for a packed-shuffle kernel at the sizes
    of ``test_kernels.py``'s sweeps (tensors on ``dev``)."""
    rng = np.random.RandomState(seed)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    r, m, d = (int(rng.randint(1, 60)), int(rng.randint(1, 80)),
               int(rng.randint(1, 6)))
    vals = rng.randint(-2 ** 62, 2 ** 62, size=(r, d)).astype(np.int64)
    ok = rng.randint(0, 2, m).astype(bool)
    if name == "unpack_cols":
        return (T(vals),)
    if name == "member_mask":
        keys = rng.randint(-40, 40, m).astype(np.int64)
        keys[::5] = np.iinfo(np.int64).max
        heavy = np.full(40, np.iinfo(np.int64).max, np.int64)
        heavy[:seed * 3] = rng.randint(-40, 40, seed * 3)
        rng.shuffle(heavy)
        return T(keys), T(heavy)
    if name == "pack_rows":
        idx = rng.randint(-3, r + 3, m).astype(np.int32)
        return T(vals), T(idx), T(ok)
    repl = seed + 1
    vidx = rng.randint(-3, r * repl + 5, m).astype(np.int32)
    return T(vals), T(vidx), T(ok), repl


@pytest.mark.cuda
def test_shuffle_edge_cases_bit_exact(cuda):
    """Every edge case bit-exact against the plain version; pack_rows and
    replicate_scatter also around their 1024-slot tiles
    (``pack_tile_cases``: one, two and more tiles than the grid's
    blocks, d from 1 to 12, int64 ids beyond 2^32, views off a 16-byte
    boundary), each call counted once and two launches bit-identical."""
    for name, args in chip_smoke.shuffle_edge_cases(cuda, large=True):
        _, plain_fn, _, _ = chip_smoke.kernel_fns(name, args)
        before = TK.launch_counts()[name]
        got = getattr(TK, name)(*args)
        assert_bits_equal(to_np(got), to_np(plain_fn()))
        if name in ("pack_rows", "replicate_scatter"):      # m, d >= 1
            assert TK.launch_counts()[name] == before + 1
            assert_bits_equal(to_np(got), to_np(getattr(TK, name)(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SHUFFLE)
@pytest.mark.parametrize("seed", range(4))
def test_shuffle_sweep_bit_exact_and_counted(cuda, name, seed):
    args = shuffle_sweep_args(name, seed, cuda)
    _, plain_fn, _, _ = chip_smoke.kernel_fns(name, args)
    before = TK.launch_counts()[name]
    got = getattr(TK, name)(*args)
    assert TK.launch_counts()[name] == before + 1
    assert_bits_equal(to_np(got), to_np(plain_fn()))


@pytest.mark.cuda
def test_shuffle_wrappers_check_inputs(cuda):
    from repro_torch.kernels import shuffle_pack as TS
    v = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    i = torch.zeros(4, dtype=torch.int32, device=cuda)
    ok = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        TS.pack_rows_cuda(v.double(), i, ok)
    with pytest.raises(TypeError):
        TS.pack_rows_cuda(v, i.double(), ok)
    with pytest.raises(ValueError):
        TS.pack_rows_cuda(v, i, ok[:3])
    with pytest.raises(ValueError):
        TS.replicate_scatter_cuda(v, i, ok, 0)
    with pytest.raises(TypeError):
        TS.unpack_cols_cuda(v.t())
    with pytest.raises(ValueError):
        TS.member_mask_cuda(v[:, 0].cpu(), v[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
def test_distributed_running_example_kernels_equal_plain(cuda, skew):
    """The running example over 8 sites on the card: use_kernel=True is
    bit-equal to use_kernel=False, and the shuffle kernels launched."""
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.core.unnesting import Catalog
    from repro_torch.exec.dist import device_mesh_1d, run_distributed
    env_np = chip_smoke.shred_ncop2(chip_smoke.gen_tpch_columns(4000, 2,
                                                                2.0))
    part_t, ncop2_t = chip_smoke.tpch_types()
    q = chip_smoke.nested_to_nested_query(2, "NCOP2", ncop2_t)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]),
                         {"NCOP2": ncop2_t, "Part": part_t},
                         domain_elimination=True)
    cp = CG.compile_program(sp, Catalog(unique_keys={"Part__F": ("pid",)}))
    from repro_torch.columnar.table import env_from_numpy
    env = chip_smoke.pad_sites(env_from_numpy(env_np, cuda))
    outs = {}
    for kernel in (True, False):
        def fn(env_local, ctx):
            return CG.run_flat_program(cp, env_local,
                                       ExecSettings(dist=ctx,
                                                    use_kernel=kernel))
        TK.reset_launch_counts()
        outs[kernel] = run_distributed(fn, env, device_mesh_1d(8),
                                       skew_default=skew, cap_factor=4.0,
                                       use_kernel=kernel)
        counts = TK.launch_counts()
        if kernel:
            assert counts["pack_rows"] > 0 and counts["unpack_cols"] > 0
            assert counts["member_mask"] > 0 or not skew
        else:
            assert all(v == 0 for v in counts.values()), counts
    assert outs[True][1] == outs[False][1]
    for name in cp.outputs:
        chip_smoke.bags_bit_equal(outs[True][0][name], outs[False][0][name],
                                  name)


# ---------------------------------------------------------------------------
# segment_reduce and the standard route
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_segment_reduce_edge_cases_bit_exact_and_counted(cuda):
    """Every edge case bit-exact against the plain version; a dispatch
    with segments launches once, one with none launches nothing."""
    for name, (vals, seg, S) in chip_smoke.reduce_edge_cases(cuda,
                                                             large=True):
        kern, plain_fn, _, _ = chip_smoke.kernel_fns(name, (vals, seg, S))
        assert chip_smoke.max_abs_err(kern(), plain_fn()) == 0.0, \
            (vals.shape, S)
        before = TK.launch_counts()["segment_reduce"]
        TK.segment_reduce(vals, seg, S)
        assert TK.launch_counts()["segment_reduce"] == before + (S > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_segment_reduce_repeats_bitwise_within_the_f32_bound(cuda, d):
    """Random values: two launches give the same bits, each segment
    within 2 n_s 2^-24 sum|x| of a float64 sum; a 1-D float64 input
    comes back 1-D float64."""
    from repro_torch.kernels import segment_reduce as TSR
    rng = np.random.RandomState(d)
    n, S = 300000, 2000
    seg = np.sort(rng.randint(0, S, n)).astype(np.int32)
    seg[:5000] = 0                                  # one block-sized range
    vals = rng.rand(n, d).astype(np.float32)
    v, g = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    a, b = TSR.segment_reduce_cuda(v, g, S), TSR.segment_reduce_cuda(v, g, S)
    assert torch.equal(a, b)
    want = np.zeros((S, d))
    np.add.at(want, seg, vals.astype(np.float64))
    n_s = np.bincount(seg, minlength=S)[:, None]
    assert (np.abs(a.cpu().numpy() - want) <= 2 * n_s * 2.0 ** -24 * want
            ).all()
    one = TK.segment_reduce(v[:, 0].double(), g, S)
    assert one.dtype == torch.float64 and one.shape == (S,)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_segment_reduce_tile_edges_bit_exact_counted_once(cuda, d):
    """Runs at the edges of the kernel's 2048-row tiles (a segment ending
    at a tile's end, one straddling two, one spanning 41 tiles,
    out-of-range rows at tiles' first and last rows, 35 tiles without an
    in-range id, empty segments before, between and after tiles, a tail
    tile), on integer values: bit-exact against the plain version, each
    call counted once."""
    from repro_torch.kernels import segment_reduce as TSR
    rng = np.random.RandomState(40 + d)
    for seg, S in chip_smoke.reduce_tile_edges(rng):
        vals = rng.randint(0, 100, (seg.shape[0], d)).astype(np.float32)
        v = torch.from_numpy(vals).to(cuda)
        g = torch.from_numpy(seg.astype(np.int32)).to(cuda)
        before = TSR.LAUNCHES
        got = TK.segment_reduce(v, g, S)
        assert TSR.LAUNCHES == before + 1
        assert chip_smoke.max_abs_err(got, TR.segment_reduce_ref(v, g, S)) \
            == 0.0, (seg.shape, S)


@pytest.mark.cuda
def test_segment_reduce_without_rows_or_segments(cuda):
    """n = 0 zeroes every segment (one launch); S = 0 returns (0, d)
    without a launch."""
    from repro_torch.kernels import segment_reduce as TSR
    v = torch.zeros((0, 3), device=cuda)
    g = torch.zeros((0,), dtype=torch.int32, device=cuda)
    before = TSR.LAUNCHES
    out = TSR.segment_reduce_cuda(v, g, 5)
    assert torch.equal(out, torch.zeros((5, 3), device=cuda))
    assert TSR.LAUNCHES == before + 1
    v = torch.ones((7, 2), device=cuda)
    g = torch.zeros((7,), dtype=torch.int32, device=cuda)
    assert TSR.segment_reduce_cuda(v, g, 0).shape == (0, 2)
    assert TSR.LAUNCHES == before + 1


DESCENDING = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.kernels import segment_reduce as SR
seg = torch.arange({n}, dtype=torch.int32, device="cuda") // 2
seg[{at}], seg[{at} + 1] = seg[{at} + 1] + 0, seg[{at}] + 0
out = SR.segment_reduce_cuda(torch.ones(({n}, 1), device="cuda"), seg, {S})
torch.cuda.synchronize()
print("RETURNED", float(out.sum()))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("n,at", [(100, 41), (5000, 95), (5000, 2047),
                                  (9000, 4095)])
def test_segment_reduce_stops_on_descending_ids(cuda, n, at):
    """The precondition (in-range ids non-decreasing) is checked on the
    card: a descending pair inside a thread's rows (row 41), between
    threads (rows 95, 96) and between two tiles (rows 2047, 2048 and
    4095, 4096) makes the kernel trap, so that the synchronisation
    after it raises and the process stops; it never returns sums. Run in
    a child process, since the trap loses the CUDA context."""
    import subprocess
    seg = np.arange(n) // 2
    assert seg[at] != seg[at + 1]
    code = DESCENDING.format(src=os.path.join(ROOT, "src"), n=n, at=at,
                             S=n // 2 + 1)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "RETURNED" not in run.stdout, run.stdout
    assert "seg_ids descend" in run.stdout + run.stderr, \
        (run.stdout, run.stderr[-2000:])


# ---------------------------------------------------------------------------
# segment_sum_first and merge_positions at card scale
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_segment_sum_first_at_card_scale_bit_exact_and_repeatable(cuda):
    """The 2048-row tiles' edges with d from 1 to 4, a run over 250
    tiles, sparse ids (a tile's ids wider than its 2048 slots), and a
    4M-row last group over an empty tail of 4M ids (the main path's
    shape), on integer values: bit-exact against the plain version, two
    launches bit-identical, each call counted once."""
    rng = np.random.RandomState(3)
    for vals, keys, seg, S in chip_smoke.first_card_cases(rng):
        args = (torch.from_numpy(vals).to(cuda),
                torch.from_numpy(keys).to(cuda),
                torch.from_numpy(seg).to(cuda), S)
        before = TSF.LAUNCHES
        got = TK.segment_sum_first(*args)
        assert TSF.LAUNCHES == before + 1
        assert chip_smoke.max_abs_err(got, TR.segment_sum_first_ref(*args)) \
            == 0.0, (seg.shape, S)
        assert chip_smoke.max_abs_err(got, TK.segment_sum_first(*args)) \
            == 0.0


@pytest.mark.cuda
def test_merge_positions_at_card_scale_bit_exact_and_repeatable(cuda):
    """r = 2^24 + 3 keys with runs of equal keys longer than a sector of
    heads and a fence bracket and an INT64_MAX tail; r at the fence count
    and one either side; ascending queries into a join's offsets:
    bit-exact, two launches bit-identical."""
    rng = np.random.RandomState(4)
    for sk, q in chip_smoke.merge_card_cases(rng):
        sk, q = torch.from_numpy(sk).to(cuda), torch.from_numpy(q).to(cuda)
        got = TG.merge_positions_cuda(sk, q)
        assert chip_smoke.max_abs_err(got, TR.merge_positions_ref(sk, q)) \
            == 0.0, (sk.shape, q.shape)
        assert chip_smoke.max_abs_err(got, TG.merge_positions_cuda(sk, q)) \
            == 0.0


SSF_DESCENDING = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.kernels import segment_fused as SF
seg = torch.arange({n}, dtype=torch.int32, device="cuda") // 2
seg[{at}], seg[{at} + 1] = seg[{at} + 1] + 0, seg[{at}] + 0
keys = torch.zeros(({n}, 2), dtype=torch.int64, device="cuda")
out = SF.segment_sum_first_cuda(torch.ones(({n}, 1), device="cuda"), keys,
                                seg, {S})
torch.cuda.synchronize()
print("RETURNED", float(out[0].sum()))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("n,at", [(5000, 89), (5000, 95), (9000, 4095)])
def test_segment_sum_first_stops_on_descending_ids(cuda, n, at):
    """segment_sum_first checks its precondition as segment_reduce does:
    a descending pair inside a thread's 16 rows (rows 89, 90), between
    threads (rows 95, 96) or between tiles (rows 4095, 4096) traps, and
    the synchronisation after it raises (in a child process: the trap
    loses the CUDA context)."""
    import subprocess
    seg = np.arange(n) // 2
    assert seg[at] != seg[at + 1]
    code = SSF_DESCENDING.format(src=os.path.join(ROOT, "src"), n=n, at=at,
                                 S=n // 2 + 1)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "RETURNED" not in run.stdout, run.stdout
    assert "seg_ids descend" in run.stdout + run.stderr, \
        (run.stdout, run.stderr[-2000:])


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_standard_route_on_card_equals_port_on_cpu(cuda, levels):
    """Fig. 7's n2n point at ``levels`` through run_standard with the
    kernels on the card equals the port's plain run on the CPU."""
    from repro_torch.columnar.table import FlatBag
    from repro_torch.core import codegen as CG
    from repro_torch.core.plans import ExecSettings
    from repro_torch.data.generators import gen_tpch
    from repro_torch.figures import tpch_nested as FT
    from repro_torch.figures.common import nested_to_nested_query
    db = gen_tpch(scale=200, skew=0.0, seed=1)
    name, nty, inputs, types = FT.nested_inputs(db, levels)
    splan = FT.standard_plan(nested_to_nested_query(levels, name, nty),
                             name, nty)
    TK.reset_launch_counts()
    gpu = CG.run_standard(splan, CG.columnar_shred_inputs(
        inputs, types, device=cuda), ExecSettings(use_kernel=True))
    assert all(TK.launch_counts()[k] > 0 for k in KERNELS)
    cpu = CG.run_standard(splan, CG.columnar_shred_inputs(
        inputs, types, device="cpu"), ExecSettings(use_kernel=False))
    assert list(gpu) == list(cpu)
    for path in cpu:
        host = FlatBag({c: a.cpu() for c, a in gpu[path].data.items()},
                       gpu[path].valid.cpu())
        chip_smoke.bags_bit_equal(cpu[path], host, str(path))


# ---------------------------------------------------------------------------
# the LM kernels: flash_attention and rwkv6
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "rwkv6"])
def test_lm_kernels_within_their_bound_and_counted(cuda, name):
    """chip_smoke.py phase 2's LM edge cases: the kernel within the f32
    rounding bound of its plain version (+1 bf16 ulp in bf16), two
    launches bit-identical (``check_lm_kernel``), and one dispatch
    through ``kernels.ops`` counted once."""
    if name == "flash_attention":
        cases = [((q, k, v), kw) for q, k, v, kw in
                 chip_smoke.attention_edge_cases(cuda)]
    else:
        cases = [(a[:5], dict(chunk=a[5]))
                 for a in chip_smoke.rwkv6_edge_cases(cuda)]
    for args, kw in cases:
        chip_smoke.check_lm_kernel(name, args, kw)
    dispatch = TK.flash_attention if name == "flash_attention" \
        else TK.rwkv6_scan
    before = TK.launch_counts()[name]
    dispatch(*cases[-1][0], **cases[-1][1])
    assert TK.launch_counts()[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.attention_tile_shapes(),
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_tile_edges_by_path(cuda, shape):
    """The tensor-core kernel's tile edges (Sq and Sk at 64 and 128 +- 1,
    D in {16, 64, 128, 256}, GQA groups 1, 2 and 4, windows within and
    across tiles, with and without a softcap), in bf16 and f32: within
    the bound of the plain version, two launches bit-identical, and each
    launch counted on the path the rule gives (bf16 with D a multiple of
    16: tensor cores; f32: CUDA cores)."""
    from repro_torch.kernels import flash_attention as TFA
    B, H, Hkv, Sq, Sk, D = shape
    rng = np.random.RandomState(sum(shape))
    for dtype, path in ((torch.bfloat16, "tensor_cores"),
                        (torch.float32, "cuda_cores")):
        q, k, v = (torch.as_tensor(rng.randn(B, h, s, D), dtype=dtype,
                                   device=cuda)
                   for h, s in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
        for kw in chip_smoke.ATTN_TILE_VARIANTS:
            if kw.get("window") and Sq - kw["window"] > Sk - 1:
                continue
            TK.reset_launch_counts()
            chip_smoke.check_lm_kernel("flash_attention", (q, k, v), kw)
            assert TFA.PATH_LAUNCHES == {path: 2, **{
                p: 0 for p in TFA.PATH_LAUNCHES if p != path}}, \
                (TFA.PATH_LAUNCHES, dtype)


@pytest.mark.cuda
def test_flash_attention_path_rule_on_the_card(cuda):
    """bf16 with D not a multiple of 16 runs on the CUDA cores, and the
    C entry point's rule, which picks the kernel, is the one that
    ``kernel_path`` counts by, for every D and both dtypes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as TFA
    rule = build.load("flash_attention").flash_attention_uses_tensor_cores
    for dtype in (torch.bfloat16, torch.float32):
        for D in range(1, 257):
            assert bool(rule(int(dtype == torch.bfloat16), D)) == (
                TFA.kernel_path(dtype, D) == "tensor_cores"), (dtype, D)
    for dtype, D in ((torch.bfloat16, 8), (torch.bfloat16, 24),
                     (torch.float32, 64)):
        q = torch.randn(1, 2, 40, D, device=cuda).to(dtype)
        TK.reset_launch_counts()
        out = TK.flash_attention(q, q, q, causal=True)
        assert TFA.PATH_LAUNCHES["cuda_cores"] == 1
        assert TFA.PATH_LAUNCHES["tensor_cores"] == 0
        chip_smoke.within(out, TR.attention_ref(q, q, q),
                          chip_smoke.attention_bound(q, q, q))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128,
                               129])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_rwkv6_around_sub_chunk_and_chunk_edges(cuda, T, chunk):
    """T around multiples of the kernel's 16-step sub-chunk and of the
    chunk, bf16 and f32: within ``rwkv6_bound`` of the plain version,
    two launches bit-identical, each launch counted on the kernel's one
    path (the tensor cores)."""
    from repro_torch.kernels import rwkv6_scan as TRW
    rng = np.random.RandomState(T * 100 + chunk)
    for dtype in (torch.bfloat16, torch.float32):
        r, k, w = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (
            rng.randn(2, 3, T, 64) * 0.5, rng.randn(2, 3, T, 64) * 0.5,
            0.2 + 0.79 * rng.rand(2, 3, T, 64)))
        v = torch.as_tensor(rng.randn(2, 3, T, 48), dtype=dtype, device=cuda)
        u = torch.as_tensor(rng.randn(3, 64) * 0.3, dtype=torch.float32,
                            device=cuda)
        before = TRW.LAUNCHES
        chip_smoke.check_lm_kernel("rwkv6", (r, k, v, w, u),
                                   dict(chunk=chunk))
        assert TRW.LAUNCHES == before + 2 and TRW.PATH == "tensor_cores"


@pytest.mark.cuda
def test_lm_kernels_repeat_bitwise_at_larger_shapes(cuda):
    """Determinism over two launches at shapes with many blocks."""
    from repro_torch.kernels import flash_attention as TFA
    from repro_torch.kernels import rwkv6_scan as TRW
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    q = torch.randn(2, 8, 1000, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, 4, 1000, 128, generator=g, device=cuda).bfloat16()
    for kw in (dict(causal=True), dict(causal=True, window=300,
                                       softcap=50.0)):
        a = TFA.flash_attention_cuda(q, k, k, **kw)
        assert torch.equal(a, TFA.flash_attention_cuda(q, k, k, **kw))
    r = torch.randn(2, 16, 500, 64, generator=g, device=cuda)
    w = torch.rand(2, 16, 500, 64, generator=g, device=cuda)
    u = torch.randn(16, 64, generator=g, device=cuda)
    a = TRW.rwkv6_cuda(r, r, r, w, u)
    assert torch.equal(a, TRW.rwkv6_cuda(r, r, r, w, u))


@pytest.mark.cuda
def test_lm_wrappers_check_inputs(cuda):
    from repro_torch.kernels import flash_attention as TFA
    from repro_torch.kernels import rwkv6_scan as TRW
    q = torch.zeros(1, 4, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        TFA.flash_attention_cuda(q, q.double(), q)
    with pytest.raises(ValueError):
        TFA.flash_attention_cuda(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError):
        TFA.flash_attention_cuda(q.transpose(2, 3), q, q)
    r = torch.zeros(1, 2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="K=160"):
        TRW.rwkv6_cuda(r, r, r, r, torch.zeros(2, 160, device=cuda))
    r = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        TRW.rwkv6_cuda(r, r, r, r, torch.zeros(2, 16, device=cuda), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6_7b", "gemma2_27b"])
def test_smoke_prefill_on_card_equals_port_on_cpu(cuda, arch):
    """A smoke config's prefill in float32 with the kernels on the card
    (one launch per layer) within 1e-4 x max |logit| of the port's plain
    run on the CPU from the same weights."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(arch).reduced(dtype="float32")
    params = T.init_params(cfg, 0, device="cpu")
    on_card = T.params_from_numpy(cfg, _as_numpy(params), device=cuda)
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 150)))
    TK.reset_launch_counts()
    got = T.prefill(cfg, on_card, tokens.to(cuda)).cpu()
    name = "rwkv6" if arch == "rwkv6_7b" else "flash_attention"
    assert TK.launch_counts()[name] == cfg.n_layers
    want = T.prefill(cfg, params, tokens)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _as_numpy(tree):
    if torch.is_tensor(tree):
        return tree.numpy()
    return {k: _as_numpy(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# serving and observability on the card: EXPLAIN ANALYZE, execute_many,
# the runtime's warm replay
# ---------------------------------------------------------------------------

def _family_env(dev, seed=3, skew=0.0):
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core.unnesting import Catalog
    part_t, ncop2_t = chip_smoke.tpch_types()
    env_np = chip_smoke.shred_ncop2(chip_smoke.gen_tpch_columns(4000, seed,
                                                                skew))
    return (env_np, env_from_numpy(env_np, dev),
            {"NCOP2": ncop2_t, "Part": part_t},
            Catalog(unique_keys={"Part__F": ("pid",)}))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["local", "mesh"])
def test_explain_with_and_without_kernels_gives_equal_trees(cuda, where):
    """explain_analyze with use_kernel=True and False on the card: the
    same operators, rows out and in, and meters (wall times aside), and
    bit-equal outputs; the kernels launched in the first run."""
    from repro_torch.exec.dist import device_mesh_1d
    from repro_torch.obs import explain_analyze
    env_np, env, types, catalog = _family_env(cuda, skew=2.0)
    kw = {}
    if where == "mesh":
        env = chip_smoke.pad_sites(env)
        kw = dict(mesh=device_mesh_1d(8, device=cuda), skew_partitions=8,
                  skew_stats=chip_smoke.written_stats(env_np, types, "stats"))
    prog = chip_smoke.family_program(13.0)
    TK.reset_launch_counts()
    res = chip_smoke.explain_both(f"explain {where}", lambda k:
        explain_analyze(prog, chip_smoke.fresh_env(env), types,
                        catalog=catalog, use_kernel=k, **kw))
    counts = TK.launch_counts()
    if where == "local":
        assert all(counts[k] > 0 for k in KERNELS), counts
    else:     # the sites' local joins take no kernel, as in the reference
        assert all(counts[k] > 0 for k in ("segment_sum_first", "pack_rows",
                                           "unpack_cols")), counts
        assert res.distributed and res.find("SkewJoinP")
    assert all(n.rows_out is not None for n in res.nodes())


@pytest.mark.cuda
def test_execute_many_bit_equal_to_execute_on_card(cuda):
    from repro_torch.core import codegen as CG
    from repro_torch.core.plans import ExecSettings
    from repro_torch.serve import QueryService
    env_np, env, types, catalog = _family_env(cuda)
    svc = QueryService(types, catalog=catalog,
                       settings=ExecSettings(use_kernel=True))
    progs = [chip_smoke.family_program(q) for q in chip_smoke.M_MIN_QTY]
    svc.execute_many(progs, env)
    TK.reset_launch_counts()
    traces = CG.TRACE_STATS.get("traces", 0)
    outs = svc.execute_many(progs, env)
    assert CG.TRACE_STATS.get("traces", 0) == traces
    assert all(TK.launch_counts()[k] >= len(progs) for k in KERNELS)
    for q, out in zip(chip_smoke.M_MIN_QTY, outs):
        chip_smoke.outputs_bit_equal(out, svc.execute(
            chip_smoke.family_program(q), env), str(q))
    chip_smoke.check_oparts(outs[2][chip_smoke.M_OPARTS], None,
                            chip_smoke.family_want(env_np,
                                                   chip_smoke.M_MIN_QTY[2]))
    assert svc.stats["batch_calls"] == 2 and svc.stats["misses"] == 1


@pytest.mark.cuda
def test_warm_replay_builds_its_bags_on_the_card(cuda, tmp_path):
    """A fresh runtime on the GPU (no device given) replays the manifest
    on all-invalid bags on the card, of the recorded dtypes, and the
    next request rebuilds no plan."""
    from repro_torch.core import codegen as CG
    from repro_torch.core.plans import ExecSettings
    from repro_torch.serve import QueryRequest, QueryService, ServingRuntime
    from repro_torch.serve import runtime as RT
    _, env, types, catalog = _family_env(cuda)
    man = str(tmp_path / "plans.json")

    def service():
        return QueryService(types, catalog=catalog,
                            settings=ExecSettings(use_kernel=True))

    prog = chip_smoke.family_program(7.0)
    rt = ServingRuntime(service(), manifest_path=man)
    first = rt.submit(QueryRequest(prog, env))
    assert first.ok, first.error
    entry = next(iter(rt.manifest.entries.values()))
    synth = RT._synthetic_env(entry["schema"])
    for name, bag in synth.items():
        assert bag.valid.is_cuda and not bool(bag.valid.any())
        assert {c: a.dtype for c, a in bag.data.items()} == \
            {c: a.dtype for c, a in env[name].data.items()}
    rt2 = ServingRuntime(service(), manifest_path=man)
    assert rt2.warm_replay() == 1
    traces = CG.TRACE_STATS.get("traces", 0)
    r = rt2.submit(QueryRequest(chip_smoke.family_program(19.0), env))
    assert r.ok and CG.TRACE_STATS.get("traces", 0) == traces
