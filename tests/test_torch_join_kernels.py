"""Models, on the CPU, of how the Hopper kernels ``segment_sum_first``,
``merge_positions`` and ``gather_rows`` split their work, held to the
plain versions.

A CUDA kernel cannot run here, so these tests run a model of its
partition logic in Python at a small tile or fence size, with
integer-valued floats so that every order of summation is exact:

* ``ssf_model`` follows ``csrc/segment_fused.cu`` (the tile
  pass's threads, its scans of ids, sums and first rows, the carry
  records; the carry pass's neighbours, its ownership of a run by the
  tile that holds the run's first row, its gaps) and counts the writes
  of every id, which must be exactly one each;
* ``merge_model`` follows ``csrc/gather_join.cu``'s merge_positions (the
  fences, the binary search over the sectors of the fence bracket in
  the heads (every 4th key), the sector that holds lo, the gallop for
  hi);
* ``gather_model`` follows ``csrc/gather_join.cu``'s gather_rows_kernel
  (the persistent grid's tiles, the ids staged from the 16-byte boundary
  below them a tile ahead, one offset resolved a row, each thread's
  (row, lane) walk with two lanes a load at even d) and counts the writes
  of every output lane, the lanes read and the resolutions.

Each model has a control: the rule broken on purpose (a tile that does
not own a run writes it; a bracket one fence off; the next tile's ids;
lanes paired at odd d) makes it disagree with the plain version. The kernels themselves run on the card in
``test_torch_cuda.py`` and ``chip_smoke.py`` over the same shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as TR

I32_MAX = 2 ** 31 - 1
I64 = np.iinfo(np.int64)


# ---------------------------------------------------------------------------
# segment_sum_first
# ---------------------------------------------------------------------------

class _Out:
    """The kernel's outputs, with the writer of each id and the count of
    writes."""

    def __init__(self, S, d, k):
        self.sums = np.full((S, d), np.nan, np.float32)
        self.fidx = np.full(S, -7, np.int64)
        self.fvals = np.full((S, k), -7, np.int64)
        self.writes = np.zeros(S, np.int64)
        self.writer = np.full(S, -1, np.int64)

    def run(self, s, total, row, keys, who):
        self.sums[s] = total
        self.fidx[s] = row
        self.fvals[s] = keys[row]
        self.writes[s] += 1
        self.writer[s] = who

    def gap(self, a, b, who):
        for s in range(a, b):
            self.sums[s] = 0.0
            self.fidx[s] = I32_MAX
            self.fvals[s] = 0
            self.writes[s] += 1
            self.writer[s] = who


def _tile_pass(t, ids, vals, rows0, S, keys, out, tile, items):
    """One tile: its threads of ``items`` rows, the block's scans, its
    writes; returns the carry record (first, last, carry_first,
    carry_last, row_first, row_last)."""
    d = vals.shape[1]
    threads = []
    for th in range(tile // items):
        head = tail = head_row = tail_row = -1
        single = True
        hsum = acc = np.zeros(d, np.float32)
        for i in range(th * items, (th + 1) * items):
            s = int(ids[i])
            if not 0 <= s < S:
                continue                                # dropped
            if s != tail:
                if tail >= 0:
                    assert s > tail, "in-range ids descend"
                    if single:
                        hsum, single = acc, False
                    else:                               # inside the thread
                        out.run(tail, acc, tail_row, keys, t)
                    out.gap(tail + 1, s, t)
                else:
                    head, head_row = s, rows0 + i
                tail, tail_row = s, rows0 + i
                acc = np.zeros(d, np.float32)
            acc = acc + vals[i]
        if single:
            hsum = acc
        threads.append(dict(head=head, tail=tail, head_row=head_row,
                            tail_row=tail_row, single=single, hsum=hsum,
                            acc=acc))
    in_range = [x["tail"] for x in threads if x["tail"] >= 0]
    first = min((x["head"] for x in threads if x["head"] >= 0),
                default=I32_MAX)
    last = max(in_range, default=-1)
    # the scans: each thread's previous id, the sum of that id's run so
    # far (segmented by the threads where a run starts) and the row where
    # it started (a max-scan: those rows rise with the thread)
    prev, run_sum, run_row = -1, np.zeros(d, np.float32), -1
    carry_first = row_first = None
    for x in threads:
        flag = x["tail"] >= 0 and not (x["single"] and x["head"] == prev)
        before, row_before = run_sum, run_row
        if x["tail"] >= 0:
            cont = x["head"] == prev
            if not cont and prev >= 0:                  # `prev` ended
                if prev == first:
                    carry_first, row_first = before, row_before
                else:
                    out.run(prev, before, row_before, keys, t)
                out.gap(prev + 1, x["head"], t)
            if not x["single"]:                         # head ends here
                tot = before + x["hsum"] if cont else x["hsum"]
                hrow = row_before if cont else x["head_row"]
                if x["head"] == first:
                    carry_first, row_first = tot, hrow
                else:
                    out.run(x["head"], tot, hrow, keys, t)
        run_sum = x["acc"] if flag else run_sum + x["acc"]
        if flag:
            run_row = x["tail_row"]
        prev = max(prev, x["tail"])
    if last >= 0 and first == last:
        carry_first, row_first = run_sum, run_row
    return dict(first=first if last >= 0 else -1, last=last,
                carry_first=carry_first, carry_last=run_sum,
                row_first=row_first, row_last=run_row)


def ssf_model(vals, keys, seg, S, tile=16, items=4, fault=None):
    """segment_sum_first as the kernel splits it, at ``tile`` rows a tile
    and ``items`` rows a thread. Returns (sums, fidx, fvals, writes,
    writer): writes[s] counts the writes of id s, writer[s] is the tile
    whose pass or carry warp wrote it last (-2: the grid's share of the
    end gaps). ``fault="owner"``: a tile inside a run that an earlier
    tile owns writes it too (the ownership rule broken)."""
    vals = np.asarray(vals, np.float32)
    keys, seg = np.asarray(keys), np.asarray(seg)
    n, d = vals.shape
    out = _Out(S, d, keys.shape[1])
    NT = -(-n // tile)
    recs = []
    for t in range(NT):
        lo, hi = t * tile, min(n, (t + 1) * tile)
        ids = np.full(tile, -1, np.int64)
        ids[: hi - lo] = seg[lo:hi]
        v = np.zeros((tile, d), np.float32)
        v[: hi - lo] = vals[lo:hi]
        recs.append(_tile_pass(t, ids, v, lo, S, keys, out, tile, items))
    nonempty = [t for t in range(NT) if recs[t]["first"] >= 0]
    for i, t in enumerate(nonempty):                    # carry pass
        r = recs[t]
        first, last = r["first"], r["last"]
        prev = recs[nonempty[i - 1]]["last"] if i > 0 else -1
        nxt = recs[nonempty[i + 1]]["first"] if i + 1 < len(nonempty) else S
        assert prev <= first, "in-range ids descend across tiles"
        if i + 1 < len(nonempty) and nxt > last + 1:
            out.gap(last + 1, nxt, t)
        if first != last and prev != first:             # first run all here
            out.run(first, r["carry_first"], r["row_first"], keys, t)
        if first == last and prev == first and fault != "owner":
            continue                                    # an earlier owner
        s, total = last, r["carry_last"]
        for q in nonempty[i + 1:] if nxt == s else ():
            f, lq = recs[q]["first"], recs[q]["last"]
            if f == s:
                total = total + recs[q]["carry_first"]
            if f != s or lq != s:                       # s ends at q
                break
        out.run(s, total, r["row_last"], keys, t)
    lo_end = recs[nonempty[0]]["first"] if nonempty else S
    hi_start = recs[nonempty[-1]]["last"] + 1 if nonempty else S
    out.gap(0, lo_end, -2)
    out.gap(hi_start, S, -2)
    return out.sums, out.fidx, out.fvals, out.writes, out.writer


def _runs(*spec):
    return np.concatenate([np.full(m, s) for s, m in spec]).astype(np.int32)


def ssf_cases():
    """(name, seg, S, d, k) at a 16-row tile of 4-row threads."""
    rng = np.random.RandomState(11)
    dense = np.repeat(np.arange(30), rng.randint(1, 4, 30))
    main = np.concatenate([dense, np.full(170, 29)])[:200]
    return [
        ("run over 3+ tiles", _runs((0, 5), (1, 60), (2, 3), (3, 20)), 6,
         2, 3),
        ("invalid tail of many tiles", main, 200, 1, 2),
        ("empty segments between tiles", _runs((0, 16), (5, 16), (9, 7),
                                               (14, 9)), 20, 3, 1),
        ("empty first tile", _runs((-1, 20), (2, 5), (3, 30)), 6, 1, 4),
        ("out of range at both ends", _runs((-1, 3), (0, 9), (1, 20),
                                            (7, 10), (9, 4)), 7, 2, 2),
        ("out of range between rows of one id",
         _runs((0, 6), (-1, 1), (0, 5), (1, 10), (9, 17), (1, 4), (2, 3)),
         3, 4, 1),
        ("S > n", np.sort(rng.randint(0, 40, 37)).astype(np.int32), 90, 1,
         3),
        ("n = 1", _runs((0, 1)), 1, 1, 1),
        ("n not a multiple of the tile",
         np.sort(rng.randint(0, 12, 53)).astype(np.int32), 12, 3, 2),
        ("every row invalid", _runs((-1, 35)), 5, 2, 1),
        ("runs of one row", np.arange(45, dtype=np.int32), 45, 1, 3),
    ] + [(f"d={d} k={5 - d}", np.sort(rng.randint(-1, 25, 70)).astype(
        np.int32), 22, d, 5 - d) for d in range(1, 5)]


SSF = ssf_cases()


def _ssf_args(seg, S, d, k, seed=0):
    rng = np.random.RandomState(seed)
    n = seg.shape[0]
    vals = rng.randint(0, 100, (n, d)).astype(np.float32)
    keys = rng.randint(-2 ** 62, 2 ** 62, (n, k)).astype(np.int64)
    return vals, keys, seg


def _plain_ssf(vals, keys, seg, S):
    got = TR.segment_sum_first_ref(torch.from_numpy(vals),
                                   torch.from_numpy(keys),
                                   torch.from_numpy(seg), S)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("case", range(len(SSF)), ids=[c[0] for c in SSF])
@pytest.mark.parametrize("tile,items", [(16, 4), (8, 8), (32, 4)])
def test_segment_sum_first_model_equals_plain(case, tile, items):
    """Every id written exactly once; sums, first rows and key lanes
    bit-equal to the plain version's."""
    _, seg, S, d, k = SSF[case]
    vals, keys, seg = _ssf_args(seg, S, d, k, case)
    sums, fidx, fvals, writes, _ = ssf_model(vals, keys, seg, S, tile, items)
    want = _plain_ssf(vals, keys, seg, S)
    assert (writes == 1).all(), np.nonzero(writes != 1)
    np.testing.assert_array_equal(sums, want[0])
    np.testing.assert_array_equal(fidx, want[1])
    np.testing.assert_array_equal(fvals, want[2])


def test_the_tile_of_a_runs_first_row_writes_its_first_row_and_keys():
    """A run over tiles 0-4 (16-row tiles) is written by tile 0, where it
    starts, with fidx its first row and that row's keys; the run from
    row 70 on, by tile 4."""
    seg = _runs((0, 5), (1, 60), (2, 3), (3, 20))
    vals, keys, seg = _ssf_args(seg, 6, 2, 3)
    _, fidx, fvals, _, writer = ssf_model(vals, keys, seg, 6)
    assert writer[1] == 0 and fidx[1] == 5
    np.testing.assert_array_equal(fvals[1], keys[5])
    assert writer[3] == 4 and fidx[3] == 68
    np.testing.assert_array_equal(fvals[3], keys[68])
    assert (writer[4:] == -2).all()                     # the end gap


def test_segment_sum_first_model_control_breaks_ownership():
    """The control: where tiles inside a run write it too, the run over
    3+ tiles is written several times, the last time with a partial
    sum."""
    _, seg, S, d, k = SSF[0]
    vals, keys, seg = _ssf_args(seg, S, d, k)
    sums, _, _, writes, _ = ssf_model(vals, keys, seg, S, fault="owner")
    assert writes[1] > 1
    assert not np.array_equal(sums, _plain_ssf(vals, keys, seg, S)[0])


# ---------------------------------------------------------------------------
# merge_positions
# ---------------------------------------------------------------------------

def _count(arr, m, n_arr, q):
    """Sector m of arr (4 entries, fewer at the end): its entries below q
    and at most q, and its length."""
    sector = arr[4 * m:min(4 * m + 4, n_arr)]
    return int((sector < q).sum()), int((sector <= q).sum()), len(sector)


def merge_model(keys, queries, max_fences, fault=None):
    """merge_positions as the kernel searches, one query after another:
    fences every w keys (w = 16 * 2^m, the least with at most
    ``max_fences`` fences: the kernel's MAX_FENCES, small here); a
    binary search over the sectors (4 entries) of the fence bracket in
    the heads (every 4th key), each probe counting its whole sector and
    ending the search where it holds an entry >= q; the keys' sector
    that holds lo; a gallop for hi. ``fault="bracket"``: the bracket
    taken one fence late."""
    keys = [int(x) for x in keys]
    r = len(keys)
    karr = np.asarray(keys, np.int64)
    wl = 4
    while -(-r // (1 << wl)) > max_fences:
        wl += 1
    nf = -(-r // (1 << wl))
    fences = [keys[f << wl] for f in range(nf)]
    heads = karr[::4]
    n_heads, sh = len(heads), wl - 2
    lo_out, hi_out = [], []
    for q in (int(x) for x in queries):
        a, b = 0, nf                                    # fences below q
        while a < b:
            m = (a + b) >> 1
            if fences[m] < q:
                a = m + 1
            else:
                b = m
        if fault == "bracket" and 0 < a < nf:
            a += 1
        sec = 0
        if a > 0:
            j, jb = ((a - 1) << sh) // 4, (min(a << sh, n_heads) + 3) // 4
            c = None
            while jb - j > 1:
                m = (j + jb) >> 1
                plt, _, ln = _count(heads, m, n_heads, q)
                if plt == 0:
                    jb = m
                    continue
                j, c = m, plt
                if plt < ln:
                    break
            if c is None:
                c, _, _ = _count(heads, j, n_heads, q)
            sec = 4 * j + c - 1                         # last head below q
        lt, le, _ = _count(karr, sec, r, q)
        length = min(4, r - 4 * sec)
        lo_out.append(4 * sec + lt)
        h = 4 * sec + le
        if le == length and h < r:                      # the gallop
            below = c = h
            step = 1
            while c < r and keys[c] <= q:
                below = c + 1
                c = h + step
                step <<= 1
            c = min(c, r)
            h = below
            while h < c:
                m = h + ((c - h) >> 1)
                if keys[m] <= q:
                    h = m + 1
                else:
                    c = m
        hi_out.append(h)
    return np.asarray(lo_out, np.int32), np.asarray(hi_out, np.int32)


def merge_cases():
    """(name, sorted keys, queries), for 8, 4, 2 or 1 fences of at least
    16 keys (at 4, w = 16 up to r = 64, 32 above: r = 63-65 sit at the
    fence count)."""
    rng = np.random.RandomState(12)
    probe = lambda sk: np.concatenate([  # noqa: E731
        sk, sk + 1, sk - 1, rng.randint(-60, 60, 40),
        [I64.min, I64.max, I64.min + 1, I64.max - 1]]).astype(np.int64)
    out = [("r = 1", np.array([5]), np.array([I64.min, 4, 5, 6, I64.max]))]
    for r in (63, 64, 65):
        sk = np.sort(rng.randint(-50, 50, r))
        out.append((f"r = {r}, at the fence count", sk, probe(sk)))
    sk = np.arange(100) * 3
    sk[12:20] = sk[12]                                 # over a line end
    sk[28:36] = sk[28]                                 # over a fence
    out.append(("duplicates over a fence and a line", sk, probe(sk)))
    sk = np.sort(np.concatenate([np.arange(40), np.full(23, 50),
                                 np.full(70, 60), np.arange(70, 90)]))
    out.append(("runs longer than a line and a bracket", sk, probe(sk)))
    sk = np.concatenate([np.arange(30), np.full(50, I64.max)])
    out.append(("an INT64_MAX tail", sk, probe(sk[:35])))
    out.append(("every key INT64_MAX", np.full(40, I64.max),
                np.array([I64.min, 0, I64.max - 1, I64.max])))
    offs = np.cumsum(rng.randint(0, 4, 90))
    out.append(("ascending queries", offs, np.arange(offs[-1] + 5)))
    return [(nm, np.asarray(k, np.int64), np.asarray(q, np.int64))
            for nm, k, q in out]


MERGE = merge_cases()


@pytest.mark.parametrize("case", range(len(MERGE)),
                         ids=[c[0] for c in MERGE])
@pytest.mark.parametrize("max_fences", [8, 4, 2, 1])
def test_merge_positions_model_equals_plain(case, max_fences):
    _, sk, q = MERGE[case]
    lo, hi = merge_model(sk, q, max_fences)
    want = TR.merge_positions_ref(torch.from_numpy(sk), torch.from_numpy(q))
    np.testing.assert_array_equal(lo, want[0].numpy())
    np.testing.assert_array_equal(hi, want[1].numpy())


@pytest.mark.parametrize("max_fences", [1, 2, 16384])
def test_merge_positions_model_at_any_fence_count(max_fences):
    """One fence (the whole array a bracket) and fences every 16 keys (r
    within the fences: one sector of heads a bracket) give the same
    answers."""
    _, sk, q = MERGE[4]
    lo, hi = merge_model(sk, q, max_fences=max_fences)
    want = TR.merge_positions_ref(torch.from_numpy(sk), torch.from_numpy(q))
    np.testing.assert_array_equal(lo, want[0].numpy())
    np.testing.assert_array_equal(hi, want[1].numpy())


def test_merge_positions_model_control_breaks_the_bracket():
    """The control: the bracket one fence late misses the keys of the
    right one."""
    _, sk, q = MERGE[4]
    lo, _ = merge_model(sk, q, max_fences=4, fault="bracket")
    want = TR.merge_positions_ref(torch.from_numpy(sk), torch.from_numpy(q))
    assert not np.array_equal(lo, want[0].numpy())


# ---------------------------------------------------------------------------
# gather_rows
# ---------------------------------------------------------------------------

SENTINEL = np.int64(-0x5A5A5A5A5A5A5A5B)
SPECIAL = np.array([-0.0, np.nan, 1.5]).view(np.int64).tolist() \
    + [0x7FF8_0000_0000_0ABC]


def _stage(mem, addr, nbytes):
    """``stage_bytes``: the chunks copied for ``nbytes`` bytes at byte
    ``addr`` of ``mem`` (byte 0 16-byte aligned), zero beyond the last
    byte; and where those bytes begin in them."""
    base, head = addr & ~15, addr & 15
    total = head + nbytes
    sh = np.zeros(16 * -(-total // 16), np.uint8)
    for c in range(len(sh) // 16):
        take = min(16, total - 16 * c)
        sh[16 * c:16 * c + take] = mem[base + 16 * c:base + 16 * c + take]
    return sh, head


def gather_model(values, idx, *, tile=32, threads=16, unroll=4, blocks=3,
                 idx_shift=0, aligned=True, fault=None):
    """gather_rows as ``csrc/gather_join.cu``'s gather_rows_kernel splits
    it: block b of a persistent grid walks tiles b, b + G, ... of
    ``tile`` rows; a tile's ids staged from the 16-byte boundary at or
    below their first byte (``idx_shift`` bytes off one), the next
    tile's before this one is read; each row resolved once to an element
    offset, -1 out of [0, r); each thread's (row, unit) walk stepped by
    adds, ``unroll`` lanes loaded before their stores, a unit two lanes
    where ``d`` is even and the bases aligned. Returns (out, writes of
    each output lane, lanes read, resolutions). ``fault``: "stale" reads
    the next tile's staged ids for this tile; "pair_odd" moves two lanes
    a unit whatever ``d``."""
    r, d = values.shape
    n = idx.shape[0]
    mem = np.zeros(idx_shift + idx.nbytes + 16, np.uint8)
    mem[idx_shift:idx_shift + idx.nbytes] = idx.view(np.uint8)
    flat = values.reshape(-1)
    out = np.full(n * d, SENTINEL, np.int64)
    writes = np.zeros(n * d, np.int64)
    reads = resolved = 0
    vec = 2 if aligned and (d % 2 == 0 or fault == "pair_odd") else 1
    du = d // vec
    step_s, step_u = divmod(threads, du)
    tiles = -(-n // tile)
    grid = min(tiles, blocks)

    def fill(t):
        rows = min(tile, n - t * tile)
        return _stage(mem, idx_shift + 8 * t * tile, 8 * rows)

    for blk in range(grid):
        stage = [fill(blk), None]
        t, b = blk, 0
        while t < tiles:
            if t + grid < tiles:
                stage[b ^ 1] = fill(t + grid)
            s0 = t * tile
            rows = min(tile, n - s0)
            sh, head = stage[b ^ 1] if fault == "stale" and t + grid < tiles \
                else stage[b]
            ti = sh[head:head + 8 * rows].view(np.int64)
            if len(ti) < rows:                 # a staged tile shorter
                ti = np.concatenate([ti, np.zeros(rows - len(ti), np.int64)])
            off = np.full(rows, -1, np.int64)
            for j in range(rows):
                v = int(ti[j])
                resolved += 1
                if 0 <= v < r:
                    off[j] = v * d
            for tid in range(threads):
                s, u = divmod(tid, du)
                while s < rows:
                    batch = []
                    for _ in range(unroll // vec):
                        batch.append((s, u))
                        s, u = s + step_s, u + step_u
                        if u >= du:
                            s, u = s + 1, u - du
                    xs = []
                    for ss, uu in batch:
                        x = np.zeros(vec, np.int64)
                        if ss < rows and off[ss] >= 0:
                            at = off[ss] + uu * vec
                            x = flat[at:at + vec].copy()
                            reads += vec
                        xs.append(x)
                    for (ss, uu), x in zip(batch, xs):
                        if ss < rows:
                            at = (s0 + ss) * d + uu * vec
                            out[at:at + vec] = x
                            writes[at:at + vec] += 1
            t, b = t + grid, b ^ 1
    return out.reshape(n, d), writes, reads, resolved


def _gather_inputs(r, n, d, seed):
    """Values with -0.0 and NaN payloads in row 0; ids in [-3, r + 3)
    with row 0, -1, r, INT64_MAX and INT64_MIN among them."""
    rng = np.random.RandomState(seed)
    values = rng.randint(-2 ** 62, 2 ** 62, (r, d)).astype(np.int64)
    values.reshape(-1)[:len(SPECIAL)] = SPECIAL[:values.size]
    idx = rng.randint(-3, r + 3, n).astype(np.int64)
    idx[:min(n, 4)] = [0, -1, r, I64.max][:min(n, 4)]
    idx[-1] = I64.min
    return values, idx


def _plain_gather(values, idx):
    return TR.gather_rows_ref(torch.from_numpy(values),
                              torch.from_numpy(idx)).numpy()


# (name, r, n, d, idx_shift, aligned)
GATHER = [
    ("one tile", 20, 32, 1, 0, True),
    ("two tiles, the second one row", 40, 33, 2, 0, True),
    ("one row", 3, 1, 3, 0, True),
    ("fewer rows than threads", 9, 7, 4, 8, True),
] + [
    (f"many tiles d={d}", 60, 300, d, 0, True) for d in range(1, 13)
] + [
    ("ids 8 bytes off a boundary, odd d", 50, 200, 5, 8, True),
    ("ids 8 bytes off a boundary, even d", 50, 201, 6, 8, True),
    ("values 8-byte aligned, even d", 50, 200, 4, 0, False),
    ("values 8-byte aligned, odd d", 50, 200, 7, 8, False),
]
GATHER_CONFIGS = [dict(tile=32, threads=16, unroll=4, blocks=3),
                  dict(tile=16, threads=8, unroll=8, blocks=5)]


@pytest.mark.parametrize("case", range(len(GATHER)),
                         ids=[c[0] for c in GATHER])
@pytest.mark.parametrize("cfg", range(len(GATHER_CONFIGS)))
def test_gather_rows_model_equals_plain(case, cfg):
    """Bit-exact against the plain version; every output lane written
    once; the lanes of each in-range row read once and nothing else; one
    resolution a row."""
    _, r, n, d, shift, aligned = GATHER[case]
    values, idx = _gather_inputs(r, n, d, seed=case)
    out, writes, reads, resolved = gather_model(
        values, idx, idx_shift=shift, aligned=aligned, **GATHER_CONFIGS[cfg])
    np.testing.assert_array_equal(out, _plain_gather(values, idx))
    assert (writes == 1).all()
    assert reads == d * int(((idx >= 0) & (idx < r)).sum())
    assert resolved == n


def test_gather_rows_model_walks_several_tiles_a_block_and_pairs_even_d():
    """At 300 rows in tiles of 32 over 3 blocks each block walks 3-4
    tiles (every tile but a block's first staged while the one before it
    was gathered), the last tile holds 12 rows, and an even d reads two
    lanes a load (the reads come in pairs, as many as one lane a load
    reads)."""
    values, idx = _gather_inputs(60, 300, 6, seed=1)
    out, writes, reads, _ = gather_model(values, idx)
    assert -(-300 // 32) == 10 and 300 % 32 == 12
    assert reads % 2 == 0 and (writes == 1).all()
    assert gather_model(values, idx, aligned=False)[2] == reads
    np.testing.assert_array_equal(out, _plain_gather(values, idx))


def test_gather_rows_model_control_stale_tile_ids_disagree():
    """The control: tile k gathered from the ids staged for the tile
    after it disagrees with the plain version."""
    values, idx = _gather_inputs(60, 300, 3, seed=2)
    out = gather_model(values, idx, fault="stale")[0]
    assert not np.array_equal(out, _plain_gather(values, idx))


def test_gather_rows_model_control_paired_lanes_at_odd_d_disagree():
    """The control: two lanes a unit at odd d leaves each row's last lane
    unwritten."""
    values, idx = _gather_inputs(60, 300, 5, seed=3)
    out, writes, _, _ = gather_model(values, idx, fault="pair_odd")
    assert (writes == 0).any()
    assert not np.array_equal(out, _plain_gather(values, idx))
