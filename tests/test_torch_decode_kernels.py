"""A model, on the CPU, of how the Hopper kernels behind ``rle_expand``
and ``delta_unpack`` split their work, held to the plain versions.

A CUDA kernel cannot run here, so ``rle_model`` follows
``csrc/decode.cu``'s two kernels in Python at a small tile, warp and
block:

* ``rle_scan_kernel``: scan tiles of ``scan_tile`` runs taken in ticket
  order; each thread sums its consecutive runs, the block scans them,
  the tile publishes its sum, then looks back ``window`` tiles at a time
  (the warp's lanes), adding sums down to the nearest tile that has
  published its inclusive prefix, and publishes its own. Which earlier
  tiles have published their prefix when a tile looks back is drawn at
  random, except that a tile more than ``resident`` tickets back has
  finished (its block had to end before this one could start): every
  draw must give the same starts. Then each row tile whose first row
  lies in the scan tile's rows gets its first run, by a binary search
  over the tile's starts;
* ``rle_expand_kernel``: a block a row tile of ``rows`` rows stages the
  runs from its first run to the next tile's (at most ``rows + 1``);
  each thread finds the run of its first row by one binary search and
  walks forward over its consecutive rows; the tile is stored two rows
  a store where ``out`` is 16-byte aligned, else one.

It counts the writes of every start, row-tile entry and output row
(exactly one each), the binary searches (one a thread a tile) and the
look-back windows. Three controls break a rule on purpose: inclusive
starts in place of exclusive ones, a look-back that adds the sums past
the nearest prefix, and a thread that takes its first row's run for all
its rows; each disagrees with the plain version.

``delta_model`` follows ``delta_scan_kernel`` the same way: tiles of
``threads * 16`` rows counted from the 16-byte boundary at or below z
(z's bytes lie among random ones), taken in ticket order; each thread
loads its 16 rows in 16-byte words, only where a word's first row lies
before the end, and zeroes the rows before z and past its end; the
block scans the threads' sums; the tile publishes its sum, then looks
back ``lanes`` tiles a window (a lane waits for its tile to publish), and
publishes its prefix. A status is two words, each a state tag above one
half of the value; a reader takes a value only when both words carry
the same tag, and words it reads before their publication hold what the
scratch held before (the memset clears the tags). Which earlier tiles
have published their prefix, and which words of a status a reader sees
updated, is drawn at random, as in ``rle_model``. The tile goes out
through a stage whose slots are shifted by one where that puts pairs on
out's 16-byte boundaries: every row is written once, and every 16-byte
store is aligned. Three controls: an exclusive scan, a look-back past
the nearest prefix, and a value taken without its tags (stale words);
each disagrees with the plain version. The kernels themselves run on the card
in ``test_torch_cuda.py`` and ``chip_smoke.py`` over the same edges.
"""

from bisect import bisect_right

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as TR

SENTINEL = np.int64(-0x5A5A5A5A5A5A5A5B)
I64 = np.iinfo(np.int64)


def rle_model(values, lengths, n, *, scan_threads=4, scan_items=2,
              threads=4, items=2, window=4, resident=3, out_shift=0, seed=0,
              fault=None):
    """rle_expand as the two kernels split it. Returns (out, counts)."""
    rng = np.random.RandomState(seed)
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int32).astype(np.int64)
    r = len(lengths)
    scan_tile, rows = scan_threads * scan_items, threads * items
    tiles, nb = -(-r // scan_tile), -(-n // rows)
    starts = np.full(r, SENTINEL, np.int64)
    tile_run = np.full(nb, SENTINEL, np.int64)
    writes_s, writes_b = np.zeros(r, np.int64), np.zeros(nb, np.int64)
    aggregate, prefix = {}, {}
    windows = 0
    for t in range(tiles):                          # ticket order
        j0 = t * scan_tile
        cnt = min(scan_tile, r - j0)
        run = np.zeros(scan_tile, np.int64)
        run[:cnt] = lengths[j0:j0 + cnt]
        sums = run.reshape(scan_threads, scan_items).sum(axis=1)
        inc = np.cumsum(sums)                       # the block's scan
        total = int(inc[-1])
        aggregate[t] = total
        excl = 0
        top = t - 1
        while t > 0:                                # the look-back
            seen = []
            for lane in range(window):
                q = top - lane
                if q < 0:
                    seen.append((True, 0))          # before tile 0
                elif q < t - resident or rng.rand() < 0.5:
                    seen.append((True, prefix[q]))  # finished
                else:
                    seen.append((False, aggregate[q]))
            windows += 1
            stop = next((i for i, (p, _) in enumerate(seen) if p), None)
            take = window if stop is None or fault == "past_prefix" \
                else stop + 1
            excl += sum(v for _, v in seen[:take])
            if stop is not None:
                break
            top -= window
        prefix[t] = excl + total
        acc = excl + np.concatenate([[0], inc[:-1]])  # each thread's first
        tile_starts = np.zeros(scan_tile, np.int64)
        for th in range(scan_threads):
            a = int(acc[th])
            for k in range(scan_items):
                x = th * scan_items + k
                if fault == "inclusive":
                    a += int(run[x])
                tile_starts[x] = a
                if fault != "inclusive":
                    a += int(run[x])
        starts[j0:j0 + cnt] = tile_starts[:cnt]
        writes_s[j0:j0 + cnt] += 1
        end = excl + total
        b0 = 0 if excl <= 0 else (excl - 1) // rows + 1
        b1 = nb if j0 + cnt >= r else \
            (0 if end <= 0 else min(nb, (end - 1) // rows + 1))
        for b in range(b0, b1):
            a = bisect_right(tile_starts[:cnt].tolist(), b * rows)
            tile_run[b] = j0 + max(a - 1, 0)
            writes_b[b] += 1
    out = np.full(n + 2, SENTINEL, np.int64)        # room for a shift
    o = out_shift // 8
    writes, searches, stores = np.zeros(n, np.int64), 0, 0
    for b in range(nb):
        row0 = b * rows
        j0 = min(max(int(tile_run[b]), 0), r - 1)
        j1 = min(max(int(tile_run[b + 1]), j0), r - 1) if b + 1 < nb \
            else r - 1
        count = min(j1 - j0 + 1, rows + 1)
        s_start = starts[j0:j0 + count].tolist()
        s_val = values[j0:j0 + count]
        tile = np.zeros(rows, np.int64)
        for tid in range(threads):
            i0 = row0 + tid * items
            j = max(bisect_right(s_start, i0) - 1, 0)
            searches += 1
            for k in range(items):
                while fault != "no_walk" and j + 1 < count \
                        and s_start[j + 1] <= i0 + k:
                    j += 1
                tile[tid * items + k] = s_val[j]
        here = min(rows, n - row0)
        pair = (out_shift % 16) == 0
        for x in range(0, here - 1 if pair else 0, 2):
            out[o + row0 + x:o + row0 + x + 2] = tile[x:x + 2]
            writes[row0 + x:row0 + x + 2] += 1
            stores += 1
        for x in range(here - here % 2 if pair else 0, here):
            out[o + row0 + x] = tile[x]
            writes[row0 + x] += 1
            stores += 1
    counts = dict(starts=writes_s, tile_run=writes_b, rows=writes,
                  searches=searches, windows=windows, stores=stores,
                  tiles=tiles, row_tiles=nb, threads=threads,
                  rows_a_tile=rows)
    return out[o:o + n], counts


def _plain(values, lengths, n):
    return TR.rle_expand_ref(torch.as_tensor(np.asarray(values, np.int64)),
                             torch.as_tensor(np.asarray(lengths, np.int32)),
                             n).numpy()


def _runs(lengths, seed):
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int32)
    values = rng.randint(I64.min, I64.max, len(lengths), dtype=np.int64)
    values[:4] = np.array([-0.0, np.nan, 1.5, 0.0]).view(np.int64)[
        :len(values)]
    return values, lengths, int(lengths.sum())


def _cases():
    rng = np.random.RandomState(3)
    return [
        ("one run", [100]),
        ("r = 1, n = 1", [1]),
        ("runs of 1", np.ones(50)),
        ("runs that straddle tiles", rng.randint(1, 20, 40)),
        ("n an exact multiple of the row tile", [8, 8, 1, 7, 16]),
        ("n not a multiple of the tile", rng.randint(1, 4, 37)),
        ("long runs over many row tiles", [3, 70, 1, 1, 45, 2]),
        ("more tiles than resident blocks", rng.randint(1, 3, 300)),
    ]


CASES = _cases()
CONFIGS = [dict(), dict(scan_threads=2, scan_items=4, threads=8, items=1,
                        window=2, resident=1),
           dict(scan_threads=8, scan_items=1, threads=2, items=4, window=3,
                resident=5)]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("out_shift", [0, 8])
def test_rle_model_equals_plain(case, cfg, out_shift):
    """Bit-exact against the plain version for every look-back draw
    (three seeds); every start, row-tile entry and row written once; one
    binary search a thread a row tile; rows stored two a store where
    ``out`` is 16-byte aligned."""
    values, lengths, n = _runs(CASES[case][1], seed=case)
    want = _plain(values, lengths, n)
    for seed in range(3):
        out, c = rle_model(values, lengths, n, out_shift=out_shift,
                           seed=seed, **CONFIGS[cfg])
        np.testing.assert_array_equal(out, want)
        assert (c["starts"] == 1).all() and (c["tile_run"] == 1).all()
        assert (c["rows"] == 1).all()
        assert c["searches"] == c["row_tiles"] * c["threads"]
        here = [min(c["rows_a_tile"], n - b * c["rows_a_tile"])
                for b in range(c["row_tiles"])]
        assert c["stores"] == (sum(-(-h // 2) for h in here)
                               if out_shift == 0 else n)


def test_rle_model_looks_back_past_a_window():
    """300 runs in tiles of 8 over a window of 4: the draws leave tiles
    whose window holds no prefix, so the look-back goes on to the window
    before; the starts stay those of the plain version."""
    values, lengths, n = _runs(np.random.RandomState(1).randint(1, 3, 300),
                               seed=1)
    out, c = rle_model(values, lengths, n, resident=40, seed=4)
    assert c["tiles"] == 38 and c["windows"] > c["tiles"] - 1
    np.testing.assert_array_equal(out, _plain(values, lengths, n))


def test_rle_model_one_run_spreads_over_every_row_tile():
    """One run of 1,000 rows: the one scan tile writes every row tile's
    first run (each thread a share of them), and each row tile stages one
    run; no block writes more than its ``rows`` rows."""
    values, lengths, n = _runs([1000], seed=2)
    out, c = rle_model(values, lengths, n)
    assert c["tiles"] == 1 and c["row_tiles"] == 125
    assert (c["tile_run"] == 1).all()
    np.testing.assert_array_equal(out, _plain(values, lengths, n))


@pytest.mark.parametrize("fault", ["inclusive", "past_prefix", "no_walk"])
def test_rle_model_controls_disagree(fault):
    """The controls: inclusive starts, a look-back that adds sums past
    the nearest prefix, and no forward walk each disagree with the plain
    version."""
    values, lengths, n = _runs(np.random.RandomState(5).randint(1, 4, 120),
                               seed=5)
    out, _ = rle_model(values, lengths, n, seed=6, fault=fault)
    assert not np.array_equal(out, _plain(values, lengths, n))



# ---------------------------------------------------------------------------
# delta_unpack
# ---------------------------------------------------------------------------

M64 = 1 << 64
AGGREGATE, PREFIX = 1, 2


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ (M64 - (u & 1)) % M64


def _delta_slot(x: int) -> int:
    return x + 2 * (x >> 4)


def delta_model(z, first, *, threads=4, lanes=4, resident=3, z_shift=0,
                out_shift=0, seed=0, fault=None):
    """delta_unpack as ``delta_scan_kernel`` splits it. ``z_shift``: z's
    byte offset from a 16-byte boundary (a multiple of its width);
    ``out_shift``: out's (0 or 8). Returns (out, counts). ``fault``:
    "exclusive" writes the exclusive scan; "past_prefix" adds the values
    past the nearest prefix; "stale" takes a status on its first word's
    tag alone, whatever its second word holds."""
    rng = np.random.RandomState(seed)
    z = np.asarray(z)
    width, n, items = z.itemsize, len(z), 16
    tile = threads * items
    head, end = z_shift // width, len(z) + z_shift // width
    mem = np.frombuffer(rng.bytes(z_shift + z.nbytes + 32), np.uint8).copy()
    mem[z_shift:z_shift + z.nbytes] = z.view(np.uint8)
    blocks_end = -(-(z_shift + z.nbytes) // 16) * 16   # z's 16-byte blocks
    per = 16 // width                                  # rows a word
    tiles = -(-end // tile)
    value = {}                            # (tile, state) -> its value
    shift = (out_shift // 8 - head) & 1
    out = [None] * n
    writes = np.zeros(n, np.int64)
    loads = windows = spins = stores16 = stores8 = 0

    def word(q, state, half):
        """A status word as a reader sees it: 0 before its publication
        (the memset), else the state's tag above the value's half."""
        if state == 0:
            return 0, 0
        return state, (value[(q, state)] >> (32 * half)) & 0xFFFFFFFF

    for t in range(tiles):                          # ticket order
        v_tile = t * tile
        d = []
        for th in range(threads):
            v0 = v_tile + th * items
            e = [0] * items
            for j in range(items // per):
                v = v0 + j * per
                if v < end:                         # a word with a row of z
                    b = v * width
                    assert 0 <= b and b + 16 <= blocks_end
                    loads += 1
                    for k in range(per):
                        e[j * per + k] = int.from_bytes(
                            mem[b + k * width:b + (k + 1) * width].tobytes(),
                            "little")
            d += [_unzigzag(e[k]) if head <= v0 + k < end else 0
                  for k in range(items)]
        sums = [sum(d[th * items:(th + 1) * items]) % M64
                for th in range(threads)]
        total = sum(sums) % M64
        if t == 0:
            excl = first % M64
            value[(0, PREFIX)] = (excl + total) % M64
        else:
            value[(t, AGGREGATE)] = total
            excl, top = 0, t - 1
            while True:                             # the look-back
                seen = []
                for lane in range(lanes):
                    q = top - lane
                    if q < 0:
                        seen.append((PREFIX, 0))    # before tile 0
                        continue
                    done = q < t - resident
                    # what each word shows: tile 0 publishes no sum
                    states = [PREFIX] if done else \
                        [0, PREFIX] if q == 0 else [0, AGGREGATE, PREFIX]
                    while True:                     # the lane's spin
                        spins += 1
                        (f0, lo), (f1, hi) = (
                            word(q, states[rng.randint(len(states))], h)
                            for h in (0, 1))
                        if (f0 != 0 and fault == "stale") or f0 == f1 != 0:
                            break
                    seen.append((f0, lo | hi << 32))
                windows += 1
                stop = next((i for i, (f, _) in enumerate(seen)
                             if f == PREFIX), None)
                take = seen if stop is None or fault == "past_prefix" \
                    else seen[:stop + 1]
                excl = (excl + sum(v for _, v in take)) % M64
                if stop is not None:
                    break
                top -= lanes
            value[(t, PREFIX)] = (excl + total) % M64
        stage = {}
        acc = excl
        for th in range(threads):
            for k in range(items):
                x = th * items + k
                before, acc = acc, (acc + d[x]) % M64
                slot = _delta_slot(x + shift)
                assert slot not in stage
                stage[slot] = before if fault == "exclusive" else acc
        lo, hi = max(0, head - v_tile), min(tile, end - v_tile)
        for p in range((lo + shift) // 2, (hi + shift + 1) // 2):
            x = 2 * p - shift
            g = v_tile - head + x
            pair = (stage.get(_delta_slot(2 * p)),
                    stage.get(_delta_slot(2 * p + 1)))
            if x >= lo and x + 1 < hi:
                assert (out_shift + 8 * g) % 16 == 0
                out[g], out[g + 1] = pair
                writes[g:g + 2] += 1
                stores16 += 1
            else:
                for i in (0, 1):
                    if lo <= x + i < hi:
                        out[g + i] = pair[i]
                        writes[g + i] += 1
                        stores8 += 1
    out = np.array(out, np.uint64).view(np.int64)
    counts = dict(writes=writes, loads=loads, windows=windows, spins=spins,
                  tiles=tiles, stores16=stores16, stores8=stores8)
    return out, counts


def _delta_plain(z, first):
    return TR.delta_unpack_ref(torch.from_numpy(np.asarray(z)),
                               first).numpy()


WIDTHS = [np.uint8, np.uint16, np.uint32, np.uint64]
FIRSTS = [0, int(I64.min), int(I64.max), 2 ** 64 - 1, 77]


def _deltas(dt, n, seed):
    rng = np.random.RandomState(seed)
    top = 2 ** (8 * np.dtype(dt).itemsize)
    return rng.randint(0, top, n, dtype=np.uint64).astype(dt)


@pytest.mark.parametrize("dt", WIDTHS, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 300])
def test_delta_model_equals_plain(dt, n):
    """Bit-exact against the plain version at every offset of z from a
    16-byte boundary that its width allows, out on one or 8 bytes off,
    for every look-back draw (two seeds); sums wrap past 2^64 and
    ``first`` runs over the int64 extremes; every row written once, a
    16-byte store for each pair inside a tile, 8-byte stores only at a
    tile's ends."""
    w = np.dtype(dt).itemsize
    for z_shift in range(0, 16, w):
        z = _deltas(dt, n, seed=n + z_shift)
        first = FIRSTS[(z_shift // w) % len(FIRSTS)]
        want = _delta_plain(z, first)
        for out_shift in (0, 8):
            for seed in range(2):
                out, c = delta_model(z, first, z_shift=z_shift,
                                     out_shift=out_shift, seed=seed)
                np.testing.assert_array_equal(out, want)
                assert (c["writes"] == 1).all()
                assert c["stores8"] <= 2 * c["tiles"]
                assert 2 * c["stores16"] + c["stores8"] == n


@pytest.mark.parametrize("cfg", [dict(threads=2, lanes=4, resident=12),
                                 dict(threads=4, lanes=3, resident=6)])
def test_delta_model_looks_back_past_a_window(cfg):
    """2,000 rows in tiles of 32 or 64 over windows of 4 or 3 tiles:
    look-backs cross more than one window; the sums wrap (random
    uint64 deltas) and the result stays the plain version's."""
    z = _deltas(np.uint64, 2000, seed=3)
    out, c = delta_model(z, int(I64.min), z_shift=8, seed=5, **cfg)
    assert c["windows"] > c["tiles"] - 1
    np.testing.assert_array_equal(out, _delta_plain(z, int(I64.min)))


def test_delta_model_reads_each_word_once_inside_z():
    """The words read: one a 16 bytes of z's rows, none past the
    16-byte block of z's last byte (asserted in the model); rows before
    z in its first block count as 0 (they hold random bytes)."""
    for dt, z_shift in [(np.uint8, 13), (np.uint16, 6), (np.uint32, 12),
                        (np.uint64, 8)]:
        z = _deltas(dt, 100, seed=7)
        out, c = delta_model(z, 9, z_shift=z_shift)
        w = np.dtype(dt).itemsize
        assert c["loads"] == -(-(z_shift + 100 * w) // 16)
        np.testing.assert_array_equal(out, _delta_plain(z, 9))


@pytest.mark.parametrize("fault", ["exclusive", "past_prefix", "stale"])
def test_delta_model_controls_disagree(fault):
    """The controls: an exclusive scan, a look-back that adds the values
    past the nearest prefix, and a status taken on one word's tag each
    disagree with the plain version."""
    z = _deltas(np.uint32, 800, seed=9)
    out, _ = delta_model(z, 5, z_shift=4, seed=6, resident=8, fault=fault)
    assert not np.array_equal(out, _delta_plain(z, 5))
