"""A model, on the CPU, of how the Hopper kernels behind ``rle_expand``
split their work, held to the plain version.

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
its rows; each disagrees with the plain version. The kernels themselves
run on the card in ``test_torch_cuda.py`` and ``chip_smoke.py`` over the
same edges.
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

