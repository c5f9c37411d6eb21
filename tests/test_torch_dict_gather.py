"""A model, on the CPU, of how the Hopper kernel behind ``dict_gather``
splits its work, held to the plain version; the plain version against
the reference; and the one launch helper every wrapper goes through.

A CUDA kernel cannot run here, so ``dict_model`` follows
``csrc/decode.cu``'s ``dict_launch`` and ``dict_gather_kernel`` in
Python at a small grid:

* a persistent grid of at most ``sms`` blocks of ``warps`` warps of 32
  lanes, fewer blocks where the chunk has fewer warp tiles; a warp tile
  is 32 16-byte vectors of codes, and tile t goes to the grid's warp t,
  then t + the grid's warps and so on, the warps counted block by block
  first (warp w of block b is the grid's warp w * blocks + b);
* each block stages the dictionary once, before its first row, where
  ``r <= stage_max``, ``stage_loads`` entries a thread at a time, and
  looks every row up in its own copy; above it every row reads
  ``values``;
* the body starts at the first 16-byte boundary at or after ``codes``
  (whose bytes lie among random ones): lane l loads vector l of its
  tile, 16 bytes there, into the warp's stage; the ``head`` rows before
  the body and the tail after its last full vector are read one at a
  time by the first threads of block 0;
* lane l then takes rows 2p and 2p + 1 of the tile for p = l, l + 32,
  ...: both codes from the stage, one 16-byte store; where out's rows
  of the body start 8 bytes off a boundary, the pairs are 2p + 1 and
  2p + 2 and the tile's first and last rows take an 8-byte store each.

It counts every row's writes (exactly one each), each block's staging
of each entry (once), the loads, the stores of each width and the tiles
of each warp. Two controls break a rule on purpose: a tail that is
dropped, and a body read from the slice's start rather than from its
boundary (a 16-byte load there takes the aligned block below it); each
disagrees with the plain version. The kernel itself runs on the card
in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import decode as RD
from repro.kernels import ref as R
from repro_torch.kernels import build
from repro_torch.kernels import decode as TD
from repro_torch.kernels import ref as TR

SENTINEL = -0x5A5A5A5A5A5A5A5B
STAGE_MAX = int(re.search(
    r"constexpr int DICT_STAGE_MAX = (\d+);",
    (build.CSRC / "decode.cu").read_text()).group(1))
KINDS = [np.uint8, np.uint16, np.uint32, np.int32]
SIZES = [1, 49, 4096, 4097, STAGE_MAX, STAGE_MAX + 1, 65536]


def dict_model(values, codes, *, sms=3, warps=2, stage_max=STAGE_MAX,
               stage_loads=2, codes_shift=0, out_shift=0, seed=0,
               fault=None):
    """dict_gather as ``dict_gather_kernel`` splits it. ``codes_shift``:
    the byte offset of codes from a 16-byte boundary; ``out_shift``:
    out's. Returns (out, counts), or None where the C entry point
    refuses the arguments (codes off their width, out off 8 bytes).
    ``fault``: "no_tail" drops the rows after the last full vector;
    "head_from_start" reads the body from the slice's start."""
    rng = np.random.RandomState(seed)
    values = np.asarray(values, np.int64)
    codes = np.asarray(codes)
    cb, n, r = codes.itemsize, len(codes), len(values)
    if codes_shift % cb or out_shift % 8:
        return None
    V, threads = 16 // cb, 32 * warps
    end = codes_shift + codes.nbytes
    mem = np.frombuffer(rng.bytes(end + 32), np.uint8).copy()
    mem[codes_shift:end] = codes.view(np.uint8)

    def code_at(b):
        return int(mem[b:b + cb].view(codes.dtype)[0])

    head = min(n, (16 - codes_shift % 16) % 16 // cb)
    if fault == "head_from_start":
        head = 0
    nvec = (n - head) // V
    tail = head + nvec * V
    tail_rows = 0 if fault == "no_tail" else n - tail
    tiles = -(-nvec // 32)
    blocks = min(sms, max(tiles, 1))
    grid_warps = blocks * warps
    staged = r <= stage_max
    odd = (out_shift // 8 + head) & 1
    out = np.full(n, SENTINEL, np.int64)
    c = dict(writes=np.zeros(n, np.int64), loads16=0, loads=0, stores16=0,
             stores8=0, stagings=0, misaligned=0, blocks=blocks,
             head=head, tail=n - tail, nvec=nvec, tiles=tiles, odd=odd,
             tiles_of=[[] for _ in range(grid_warps)],
             block_of_tile={})

    def store8(row, x):
        out[row] = x
        c["writes"][row] += 1
        c["stores8"] += 1

    def store16(row, x, y):
        assert (out_shift + 8 * row) % 16 == 0
        out[row:row + 2] = (x, y)
        c["writes"][row:row + 2] += 1
        c["stores16"] += 1

    for b in range(blocks):
        if staged:                                  # once, before any row
            table = np.full(r, SENTINEL, np.int64)
            staged_once = np.zeros(r, np.int64)
            for t0 in range(0, r, stage_loads * threads):
                # a round: entry t0 + k threads + th for thread th's k-th
                # load of the round
                e = (t0 + np.arange(stage_loads)[:, None] * threads
                     + np.arange(threads)[None, :]).ravel()
                e = e[e < r]
                table[e] = values[e]
                np.add.at(staged_once, e, 1)
            assert (staged_once == 1).all()
            c["stagings"] += 1
        else:
            table = values

        def entry(code):
            # (uint64) code < (uint64) r: a negative int32 is out of range
            return int(table[code]) if code % 2 ** 64 < r else 0

        for th in range(threads):
            tid = b * threads + th
            if tid < head:
                c["loads"] += 1
                store8(tid, entry(code_at(codes_shift + tid * cb)))
            if tid < tail_rows:
                c["loads"] += 1
                store8(tail + tid, entry(code_at(codes_shift
                                                 + (tail + tid) * cb)))
        for w in range(warps):
            g = w * blocks + b
            for t in range(g, tiles, grid_warps):
                c["tiles_of"][g].append(t)
                c["block_of_tile"][t] = b
                stage = []                          # the warp's 32 vectors
                for lane in range(32):
                    v = t * 32 + lane
                    if v >= nvec:
                        stage += [0] * V
                        continue
                    addr = codes_shift + (head + v * V) * cb
                    c["misaligned"] += addr % 16 != 0
                    base = addr - addr % 16         # what a 16-byte load reads
                    assert fault or (codes_shift <= base and base + 16 <= end)
                    c["loads16"] += 1
                    stage += [code_at(base + k * cb) for k in range(V)]
                o = head + t * 32 * V
                rows = min(32 * V, (nvec - t * 32) * V)
                for p in range(rows // 2):          # lane p % 32's pairs
                    if not odd:
                        store16(o + 2 * p, entry(stage[2 * p]),
                                entry(stage[2 * p + 1]))
                    elif p < rows // 2 - 1:
                        store16(o + 2 * p + 1, entry(stage[2 * p + 1]),
                                entry(stage[2 * p + 2]))
                    else:
                        store8(o, entry(stage[0]))
                        store8(o + rows - 1, entry(stage[rows - 1]))
    return out, c


def _inputs(r, dt, n, seed):
    """r random int64 entries; n codes of dtype ``dt`` over every code
    in range and a few past it (below 0 and the type's extremes for
    int32, the largest uint32)."""
    rng = np.random.RandomState(seed)
    values = rng.randint(-2 ** 63, 2 ** 63 - 1, r, dtype=np.int64)
    top = np.iinfo(dt).max
    if dt == np.int32:
        codes = rng.randint(-3, r + 3, n).astype(dt)
        codes[:3] = [np.iinfo(dt).min, -1, top]
    else:
        codes = rng.randint(0, min(r + 3, top + 1), n).astype(dt)
        if dt == np.uint32:
            codes[:2] = [top, r]
    rng.shuffle(codes)
    return values, codes


def _plain(values, codes):
    return TR.dict_gather_ref(torch.from_numpy(values),
                              torch.from_numpy(codes)).numpy()


@pytest.mark.parametrize("r", SIZES)
@pytest.mark.parametrize("dt", KINDS, ids=lambda d: np.dtype(d).name)
def test_dict_model_equals_plain(r, dt):
    """Bit-exact against the plain version at every offset of codes from
    a 16-byte boundary that their width allows and out on or 8 bytes off
    one, for a chunk shorter than the head and one with a body and a
    tail, on both sides of the staging limit: every row written once,
    every 16-byte load on a boundary inside the codes, each block
    staging each entry once where the dictionary is staged and never
    above it, the stores 16 bytes but for the head, the tail and, with
    out 8 bytes off, each tile's two ends."""
    w = np.dtype(dt).itemsize
    V = 16 // w
    for n in (3, 203):
        values, codes = _inputs(r, dt, n, seed=r + n)
        want = _plain(values, codes)
        for codes_shift in range(0, 16, w):
            for out_shift in (0, 8):
                out, c = dict_model(values, codes, codes_shift=codes_shift,
                                    out_shift=out_shift, seed=codes_shift)
                np.testing.assert_array_equal(out, want)
                assert (c["writes"] == 1).all()
                assert c["misaligned"] == 0 and c["loads16"] == c["nvec"]
                assert c["stagings"] == (c["blocks"] if r <= STAGE_MAX
                                         else 0)
                ends = c["head"] + c["tail"] + 2 * c["tiles"] * c["odd"]
                assert c["stores8"] == ends
                assert 2 * c["stores16"] + c["stores8"] == n
                assert c["head"] < V and c["tail"] < V


def test_stage_limit_is_the_sources():
    """The Python constant the smoke and the card tests size their cases
    by is the CUDA source's: the entries that fit in a block's 227 KB of
    shared memory beside its 16 warps' 512-byte stages of codes."""
    assert TD.DICT_STAGE_MAX == STAGE_MAX == (232448 - 16 * 512) // 8


@pytest.mark.parametrize("shifts", [(1, 0), (0, 4), (0, 12), (2, 1)])
def test_dict_model_refuses_what_the_entry_point_refuses(shifts):
    """uint16 codes on an odd byte, or out off 8 bytes: the entry point
    returns cudaErrorInvalidValue (the wrapper then raises)."""
    values, codes = _inputs(49, np.uint16, 40, seed=1)
    codes_shift, out_shift = shifts
    assert dict_model(values, codes, codes_shift=codes_shift,
                      out_shift=out_shift) is None


def test_dict_model_grid_is_persistent():
    """20,000 uint8 codes (40 tiles) over 3 blocks of 2 warps: the grid
    stays at its 3 blocks, each staging once, and the grid's warp g
    walks tiles g, g + 6, ...; 4 tiles reach all 3 blocks (dealt block
    by block first); a chunk of 20 rows takes one block."""
    values, codes = _inputs(300, np.uint8, 20000, seed=2)
    out, c = dict_model(values, codes, codes_shift=5)
    np.testing.assert_array_equal(out, _plain(values, codes))
    assert c["blocks"] == 3 and c["stagings"] == 3 and c["tiles"] == 40
    for g, ts in enumerate(c["tiles_of"]):
        assert ts == list(range(g, 40, 6))
    _, c = dict_model(values, codes[:4 * 512 + 11], codes_shift=5)
    assert c["tiles"] == 4 and set(c["block_of_tile"].values()) == {0, 1, 2}
    _, c = dict_model(values, codes[:20], codes_shift=5)
    assert c["blocks"] == 1 and c["stagings"] == 1


@pytest.mark.parametrize("stage_max", [0, 299, 300])
def test_dict_model_stages_at_most_stage_max_entries(stage_max):
    """The same rows with the dictionary staged (r <= stage_max) and
    read from ``values`` (r above it): the same bits."""
    values, codes = _inputs(300, np.uint16, 777, seed=3)
    out, c = dict_model(values, codes, stage_max=stage_max, codes_shift=6,
                        out_shift=8)
    np.testing.assert_array_equal(out, _plain(values, codes))
    assert c["stagings"] == (c["blocks"] if stage_max >= 300 else 0)


@pytest.mark.parametrize("fault", ["no_tail", "head_from_start"])
@pytest.mark.parametrize("dt", KINDS, ids=lambda d: np.dtype(d).name)
def test_dict_model_controls_disagree(fault, dt):
    """The controls: the tail dropped, and the body read from the
    slice's start (its loads off the boundary, taking the bytes before
    the codes); each disagrees with the plain version."""
    w = np.dtype(dt).itemsize
    values, codes = _inputs(49, dt, 16 // w * 7 + 3, seed=4)
    out, c = dict_model(values, codes, codes_shift=12,
                        fault=fault, seed=9)
    assert not np.array_equal(out, _plain(values, codes))
    if fault == "head_from_start":
        assert c["misaligned"] > 0


@pytest.mark.parametrize("r", [4096, 4097, STAGE_MAX + 1, 65536])
@pytest.mark.parametrize("dt", KINDS, ids=lambda d: np.dtype(d).name)
def test_plain_equals_reference_for_large_dictionaries(r, dt):
    """The plain version against the reference's jnp oracle and its
    Pallas kernel in interpret mode, at 256 rows (the Pallas form
    compares every row with every entry), codes in and out of range."""
    values, codes = _inputs(r, dt, 256, seed=r)
    got = _plain(values, codes)
    vj, cj = jnp.asarray(values), jnp.asarray(codes.astype(np.int64))
    np.testing.assert_array_equal(got, np.asarray(R.dict_gather_ref(vj, cj)))
    pallas = RD.dict_gather_pallas(vj, jnp.asarray(codes), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


# ---------------------------------------------------------------------------
# the launch helper
# ---------------------------------------------------------------------------

class _FakeCuda:
    """The three ``torch._C`` calls ``build.launch`` makes, on a host
    without CUDA: the current device and each device's current stream."""

    def __init__(self, device, streams):
        self.device, self.streams, self.log = device, streams, []

    def install(self, monkeypatch):
        for name, f in (("_cuda_getDevice", self.get),
                        ("_cuda_setDevice", self.set),
                        ("_cuda_getCurrentRawStream", self.stream)):
            monkeypatch.setattr(torch._C, name, f, raising=False)

    def get(self):
        return self.device

    def set(self, index):
        self.log.append(("set", index))
        self.device = index

    def stream(self, index):
        self.log.append(("stream", index, self.device))
        return self.streams[index]


def test_launch_passes_the_current_stream_and_counts(monkeypatch):
    """On the current device: no switch, the stream read on each call
    (a caller's ``torch.cuda.stream`` changes it between calls), the
    count added once a launch."""
    fake = _FakeCuda(0, {0: 111})
    fake.install(monkeypatch)
    seen, counts = [], {"N": 0}

    def fn(*args):
        seen.append(args)
        return 0

    build.launch(fn, 0, (7, 8), "k", counts, "N")
    fake.streams[0] = 222
    build.launch(fn, 0, (9,), "k", counts, "N")
    assert seen == [(7, 8, 111), (9, 222)] and counts["N"] == 2
    assert [e[0] for e in fake.log] == ["stream", "stream"]


def test_launch_switches_device_only_where_it_differs(monkeypatch):
    """A tensor on device 1 while 0 is current: the launch runs with 1
    current and its stream, then 0 is current again, also when the entry
    point returns an error, which raises and is not counted."""
    fake = _FakeCuda(0, {0: 5, 1: 6})
    fake.install(monkeypatch)
    counts = {"N": 0}
    build.launch(lambda *a: 0, 1, (), "k", counts, "N")
    assert fake.log == [("set", 1), ("stream", 1, 1), ("set", 0)]
    assert fake.device == 0 and counts["N"] == 1
    with pytest.raises(RuntimeError, match="k: CUDA launch failed with "
                                           "error 700"):
        build.launch(lambda *a: 700, 1, (), "k", counts, "N")
    assert fake.device == 0 and counts["N"] == 1


def test_wrappers_launch_through_the_one_helper():
    """No kernel module builds a stream object or enters a device context
    per call: each launches through ``build.launch``."""
    kernels = Path(build.__file__).parent
    for path in sorted(kernels.glob("*.py")):
        text = path.read_text()
        assert "torch.cuda.device(" not in text, path.name
        assert "current_stream" not in text, path.name
        assert "stream_handle" not in text, path.name
    users = {p.stem for p in kernels.glob("*.py")
             if "build.launch(" in p.read_text()}
    assert users == {"decode", "gather_join", "shuffle_pack",
                     "segment_fused", "segment_reduce", "flash_attention",
                     "rwkv6_scan"}


def test_dict_gather_cuda_refuses_cpu_tensors_with_its_message():
    """The folded check raises the messages of the two it replaced, before
    anything is built or launched."""
    v = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError, match=re.escape(
            "dict_gather_cuda: tensors must share one CUDA device; got "
            "['cpu', 'cpu']")):
        TD.dict_gather_cuda(v, v.to(torch.uint8))
    with pytest.raises(ValueError, match="must share one CUDA device"):
        TD.dict_gather_cuda(v.float(), v.to(torch.int16))
