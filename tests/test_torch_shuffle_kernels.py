"""A model, on the CPU, of how the Hopper kernels behind ``pack_rows``,
``replicate_scatter`` and ``member_mask`` split their work, held to the
plain versions.

A CUDA kernel cannot run here, so ``pack_model`` follows
``csrc/shuffle_pack.cu``'s ``pack_rows_kernel`` in Python at a small tile,
block and grid:

* the persistent grid: block b walks tiles b, b + G, ... (G = the blocks,
  at most the tiles), and the last tile may hold fewer slots;
* the staging: a tile's ``idx`` and ``ok`` bytes copied in 16-byte chunks
  from the 16-byte boundary at or below the tile's first byte, the last
  chunk cut at the tile's end, and read back from the head's offset; the
  next tile's bytes copied into the other buffer before this one is
  read;
* each slot's element offset resolved once (the division by ``repl`` in
  unsigned 32 bits for int32 ids, against ``min(repl, 2^31)``; in 64 bits
  for int64 ids);
* each thread's (slot, unit) walk, stepped by adds, in batches of
  ``unroll`` lanes loaded before their stores; a unit is two lanes
  (a batch of ``unroll / 2`` loads) where ``d`` is even and the bases
  are 16-byte aligned, else one;
* empty slots stored as 0 without a load.

It counts every write of an output lane (exactly one each), every lane
read (the lanes of the slots that take a row, once each) and every
division (one a slot). Three controls break a rule on purpose: the next
tile's indices used for this one, two lanes a unit at odd ``d``, and
int64 ids divided in 32 bits; each disagrees with the plain version.

``member_model`` follows ``member_sorted_kernel`` (``member_mask`` for a
set of at most ``sort_max`` keys) the same way: each block of a
persistent grid rank-sorts the set's keys that are not padding into a
copy (ties broken by index, so that duplicates fill distinct slots;
the copy's other slots hold garbage until written), pads it with
INT64_MAX to a power of two P, and each thread takes 8 consecutive keys
a round, read in 16-byte words from the boundary at or below ``keys``
(a head of one key: five words), each found by a branchless binary
search of log2 P steps, the flags stored as one 8-byte store where all
8 lie before the end. A larger set is compared key by key with every
key of the set (``member_staged_kernel``). Three controls: equal keys
that take one rank, a search one step short, and keys taken from the
wrong head offset; each disagrees with the plain version. The kernels
themselves run on the card in ``test_torch_cuda.py`` and
``chip_smoke.py`` over the same edges.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as TR

SENTINEL = np.int64(-0x5A5A5A5A5A5A5A5B)


def _stage(mem: np.ndarray, addr: int, nbytes: int):
    """``stage_bytes``: the chunks copied for ``nbytes`` bytes at byte
    ``addr`` of ``mem`` (whose byte 0 is 16-byte aligned), zero beyond
    the last byte; and where those bytes begin in them."""
    base, head = addr & ~15, addr & 15
    total = head + nbytes
    chunks = -(-total // 16)
    sh = np.zeros(16 * chunks, np.uint8)
    for c in range(chunks):
        take = min(16, total - 16 * c)
        sh[16 * c:16 * c + take] = mem[base + 16 * c:base + 16 * c + take]
    return sh, head


def _global(a: np.ndarray, shift: int) -> np.ndarray:
    """``a``'s bytes at byte ``shift`` of an aligned buffer."""
    mem = np.zeros(shift + a.nbytes + 16, np.uint8)
    mem[shift:shift + a.nbytes] = np.ascontiguousarray(a).view(np.uint8)
    return mem


def pack_model(values, idx, ok, repl=0, *, tile=32, threads=16, unroll=4,
               blocks=3, idx_shift=0, ok_shift=0, aligned=True, fault=None):
    """``pack_rows`` (``repl`` 0) or ``replicate_scatter`` as the kernel
    splits it. ``idx_shift``/``ok_shift``: the byte offset of each array
    from a 16-byte boundary; ``aligned``: whether ``values`` and the
    output start on one. Returns (out, writes, reads, divisions).
    ``fault``: "stale" reads the next tile's staged indices for this
    tile; "pair_odd" moves two lanes a unit whatever ``d``; "div32"
    divides int64 ids in 32 bits."""
    r, d = values.shape
    m = idx.shape[0]
    isz, osz = idx.itemsize, ok.itemsize
    gidx, gok = _global(idx, idx_shift), _global(ok, ok_shift)
    flat = values.reshape(-1)
    out = np.full(m * d, SENTINEL, np.int64)
    writes = np.zeros(m * d, np.int64)
    reads = divisions = 0
    pair = aligned and (d % 2 == 0 or fault == "pair_odd")
    vec = 2 if pair else 1
    du = d // vec
    step_s, step_u = divmod(threads, du)
    repl32 = min(repl, 2 ** 31)
    tiles = -(-m // tile)
    grid = min(tiles, blocks)

    def fill(t):
        s0 = t * tile
        n = min(tile, m - s0)
        return (_stage(gidx, idx_shift + s0 * isz, n * isz),
                _stage(gok, ok_shift + s0 * osz, n * osz))

    for blk in range(grid):
        stage = [fill(blk), None]
        t, b = blk, 0
        while t < tiles:
            if t + grid < tiles:
                stage[b ^ 1] = fill(t + grid)
            s0 = t * tile
            n = min(tile, m - s0)
            use = stage[b ^ 1] if fault == "stale" and t + grid < tiles \
                else stage[b]
            (sh_i, hi), (sh_o, ho) = use
            ti = sh_i[hi:hi + n * isz].view(idx.dtype)
            to = sh_o[ho:ho + n * osz].view(ok.dtype)
            if len(ti) < n:                  # a staged tile shorter than n
                ti = np.concatenate([ti, np.zeros(n - len(ti), idx.dtype)])
                to = np.concatenate([to, np.zeros(n - len(to), ok.dtype)])
            off = np.full(n, -1, np.int64)
            for j in range(n):
                v = int(ti[j])
                if to[j] == 0 or v < 0:
                    continue
                if not repl:
                    src = v
                elif isz == 4 or fault == "div32":
                    src = (v % 2 ** 32) // (repl32 % 2 ** 32)
                    divisions += 1
                else:
                    src = v // repl
                    divisions += 1
                if src < r:
                    off[j] = src * d
            for tid in range(threads):
                s, u = divmod(tid, du)
                while s < n:
                    batch = []
                    for _ in range(unroll // vec):
                        batch.append((s, u))
                        s, u = s + step_s, u + step_u
                        if u >= du:
                            s, u = s + 1, u - du
                    xs = []
                    for ss, uu in batch:
                        x = np.zeros(vec, np.int64)
                        if ss < n and off[ss] >= 0:
                            at = off[ss] + uu * vec
                            x = flat[at:at + vec].copy()
                            reads += vec
                        xs.append(x)
                    for (ss, uu), x in zip(batch, xs):
                        if ss < n:
                            at = (s0 + ss) * d + uu * vec
                            out[at:at + vec] = x
                            writes[at:at + vec] += 1
            t, b = t + grid, b ^ 1
    return out.reshape(m, d), writes, reads, divisions


SPECIAL = np.array([-0.0, np.nan, 1.5]).view(np.int64).tolist() \
    + [0x7FF8_0000_0000_0ABC]


def _inputs(r, m, d, idt, okt, repl, seed, *, vmax=None):
    """Values with -0.0 and NaN payloads; ids in [-3, vmax) (default: 3
    past the last virtual row), the first -1 and the last one past the
    end; about 70% of the flags set."""
    rng = np.random.RandomState(seed)
    values = rng.randint(-2 ** 62, 2 ** 62, (r, d)).astype(np.int64)
    values.reshape(-1)[:len(SPECIAL)] = SPECIAL[:values.size]
    hi = vmax if vmax is not None else r * max(repl, 1) + 3
    idx = rng.randint(-3, hi, m).astype(np.int64)
    idx[0], idx[-1] = -1, r * max(repl, 1)
    ok = rng.rand(m) < 0.7
    return values, idx.astype(idt), ok.astype(okt)


def _plain(values, idx, ok, repl):
    v, i, o = (torch.from_numpy(np.ascontiguousarray(a))
               for a in (values, idx, ok))
    if repl:
        return TR.replicate_scatter_ref(v, i, o, repl).numpy()
    return TR.pack_rows_ref(v, i, o).numpy()


def _taken(values, idx, ok, repl):
    v = idx.astype(np.int64)
    src = v // max(repl, 1)
    return int((ok.astype(bool) & (v >= 0) & (src < values.shape[0])).sum())


# (name, r, m, d, idx dtype, ok dtype, repl, idx_shift, ok_shift, aligned)
CASES = [
    ("one tile, d=1", 20, 32, 1, np.int64, np.bool_, 0, 0, 0, True),
    ("two tiles, the second one slot", 40, 33, 2, np.int32, np.bool_, 0,
     0, 0, True),
    ("one slot", 1, 1, 3, np.int64, np.int32, 0, 0, 0, True),
    ("fewer slots than threads", 9, 7, 4, np.int32, np.int32, 0, 4, 0,
     True),
    ("r = 0", 0, 40, 2, np.int64, np.bool_, 0, 0, 0, True),
] + [
    (f"many tiles d={d}", 60, 300, d,
     np.int64 if d % 3 else np.int32, np.int32 if d % 4 == 1 else np.bool_,
     0, 0, 0, True) for d in range(1, 13)
] + [
    ("idx at 8 bytes, ok at 3", 50, 200, 6, np.int64, np.bool_, 0, 8, 3,
     True),
    ("int32 idx at 12, int32 ok at 4", 50, 200, 5, np.int32, np.int32, 0,
     12, 4, True),
    ("values 8-byte aligned, even d", 50, 200, 4, np.int64, np.bool_, 0, 0,
     0, False),
    ("values 8-byte aligned, odd d", 50, 200, 7, np.int32, np.bool_, 0, 0,
     0, False),
] + [
    (f"replicate repl={repl} {np.dtype(idt).name} d={d}", 40, 260, d, idt,
     np.bool_, repl, 0, 0, True)
    for repl in (1, 3, 8) for idt in (np.int32, np.int64) for d in (3, 4)
] + [
    ("replicate int32 ids at 4, ok at 1", 30, 150, 5, np.int32, np.bool_, 3,
     4, 1, True),
]

CONFIGS = [dict(tile=32, threads=16, unroll=4, blocks=3),
           dict(tile=16, threads=8, unroll=8, blocks=5)]


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_pack_model_equals_plain(case, cfg):
    """Bit-exact against the plain version; every output lane written
    once; the lanes of each slot that takes a row read once and nothing
    else; one division a slot where ``repl`` is given."""
    _, r, m, d, idt, okt, repl, ishift, oshift, aligned = CASES[case]
    values, idx, ok = _inputs(r, m, d, idt, okt, repl, seed=case)
    out, writes, reads, divs = pack_model(
        values, idx, ok, repl, idx_shift=ishift, ok_shift=oshift,
        aligned=aligned, **CONFIGS[cfg])
    np.testing.assert_array_equal(out, _plain(values, idx, ok, repl))
    assert (writes == 1).all()
    assert reads == d * _taken(values, idx, ok, repl)
    want_divs = int(((ok != 0) & (idx.astype(np.int64) >= 0)).sum())
    assert divs == (want_divs if repl else 0)


def test_replicate_int64_ids_beyond_2_32():
    """int64 virtual ids above 2^32 (repl 2^33 + 1 over 6 rows): the
    model's one 64-bit division a slot matches the plain version."""
    repl = 2 ** 33 + 1
    values, idx, ok = _inputs(6, 200, 3, np.int64, np.bool_, repl, seed=5,
                              vmax=6 * repl + 3)
    assert int(idx.max()) > 2 ** 32
    out = pack_model(values, idx, ok, repl)[0]
    np.testing.assert_array_equal(out, _plain(values, idx, ok, repl))


def test_replicate_int32_ids_over_a_repl_of_2_31_or_more():
    """An int32 id over a repl of 2^31 or more gives row 0, as in the
    plain version: the 32-bit division against min(repl, 2^31)."""
    for repl in (2 ** 31 - 1, 2 ** 31, 2 ** 40):
        values, idx, ok = _inputs(5, 90, 2, np.int32, np.bool_, 1, seed=7,
                                  vmax=2 ** 31 - 1)
        out = pack_model(values, idx, ok, repl)[0]
        np.testing.assert_array_equal(out, _plain(values, idx, ok, repl))


def test_pack_model_walks_several_tiles_a_block_and_pairs_even_d():
    """At 300 slots in tiles of 32 over 3 blocks each block walks 3-4
    tiles (so every tile but the first of a block was staged while the
    one before it was gathered), the last tile holds 12 slots, and an
    even d reads two lanes a load: the reads come in pairs."""
    values, idx, ok = _inputs(60, 300, 6, np.int64, np.bool_, 0, seed=1)
    out, writes, reads, _ = pack_model(values, idx, ok)
    assert -(-300 // 32) == 10 and 300 % 32 == 12
    assert reads % 2 == 0 and (writes == 1).all()
    assert pack_model(values, idx, ok, aligned=False)[2] == reads
    np.testing.assert_array_equal(out, _plain(values, idx, ok, 0))


def test_control_stale_tile_indices_disagree():
    """The control: tile k gathered from the indices staged for the tile
    after it disagrees with the plain version."""
    values, idx, ok = _inputs(60, 300, 3, np.int64, np.bool_, 0, seed=2)
    out = pack_model(values, idx, ok, fault="stale")[0]
    assert not np.array_equal(out, _plain(values, idx, ok, 0))


def test_control_paired_lanes_at_odd_d_disagree():
    """The control: two lanes a unit at odd d leaves each slot's last
    lane unwritten."""
    values, idx, ok = _inputs(60, 300, 5, np.int64, np.bool_, 0, seed=3)
    out, writes, _, _ = pack_model(values, idx, ok, fault="pair_odd")
    assert (writes == 0).any()
    assert not np.array_equal(out, _plain(values, idx, ok, 0))


def test_control_int64_ids_divided_in_32_bits_disagree():
    """The control: int64 ids above 2^32 divided in 32 bits take the
    wrong rows."""
    repl = 2 ** 33 + 1
    values, idx, ok = _inputs(6, 200, 3, np.int64, np.bool_, repl, seed=5,
                              vmax=6 * repl + 3)
    out = pack_model(values, idx, ok, repl, fault="div32")[0]
    assert not np.array_equal(out, _plain(values, idx, ok, repl))


# ---------------------------------------------------------------------------
# member_mask
# ---------------------------------------------------------------------------

I64_MAX = np.iinfo(np.int64).max


def member_model(keys, heavy, *, threads=4, blocks=3, sort_max=16,
                 key_shift=0, seed=0, fault=None):
    """``member_mask`` as its kernels split it. ``key_shift``: the byte
    offset of ``keys`` from a 16-byte boundary (0 or 8). Returns (out,
    counts). ``fault``: "ties" gives equal keys one rank; "short" stops
    the search a step early; "head" takes the keys at the other head
    offset."""
    rng = np.random.RandomState(seed)
    keys = np.asarray(keys, np.int64)
    heavy = np.asarray(heavy, np.int64)
    n, m, items = len(keys), len(heavy), 8
    head = key_shift // 8
    mem = rng.randint(-2 ** 62, 2 ** 62, n + 4).astype(np.int64)
    mem[head:head + n] = keys             # keys among random words
    out = np.full(n, 0x5A, np.uint8)
    writes = np.zeros(n, np.int64)
    counts = dict(writes=writes, stores8=0, steps=0, words=0, sorts=0)
    if m > sort_max:                      # member_staged_kernel
        for i, k in enumerate(keys):
            out[i] = k != I64_MAX and bool(((heavy == k)
                                            & (heavy != I64_MAX)).any())
            writes[i] += 1
        return out.astype(bool), counts
    chunks = -(-n // items)
    grid = min(blocks, -(-chunks // threads))
    use = 1 - head if fault == "head" else head
    for b in range(grid):
        s_sorted = rng.randint(-300, 300, sort_max).astype(np.int64)
        real = [(i, h) for i, h in enumerate(heavy) if h != I64_MAX]
        for i, h in real:                 # the rank sort
            rank = sum(1 for j, g in enumerate(heavy) if g < h or
                       (g == h and j < i and fault != "ties"))
            s_sorted[rank] = h
        counts["sorts"] += 1
        P = 1
        while P < len(real):
            P *= 2
        s_sorted[len(real):P] = I64_MAX
        for tid in range(threads):
            for c in range(b * threads + tid, chunks, grid * threads):
                r0 = c * items
                words = []
                for j in range(items // 2 + head):
                    if r0 + 2 * j - head < n:   # a word with a key
                        words.append(mem[r0 + 2 * j:r0 + 2 * j + 2])
                        counts["words"] += 1
                    else:
                        words.append(np.zeros(2, np.int64))
                flags = []
                for k in range(items):
                    key = words[min((k + use) // 2, len(words) - 1)][
                        (k + use) % 2]
                    at, h = 0, P // 2
                    if fault == "short":
                        h //= 2
                    while h > 0:
                        at += h if s_sorted[at + h] <= key else 0
                        h //= 2
                        counts["steps"] += 1
                    flags.append(key != I64_MAX and s_sorted[at] == key)
                here = min(items, n - r0)
                out[r0:r0 + here] = flags[:here]
                writes[r0:r0 + here] += 1
                counts["stores8"] += here == items
    return out.astype(bool), counts


def _member_plain(keys, heavy):
    return TR.member_mask_ref(torch.from_numpy(np.asarray(keys, np.int64)),
                              torch.from_numpy(np.asarray(heavy, np.int64))
                              ).numpy()


def _member_inputs(n, m, real, seed):
    """``real`` keys of the set drawn with replacement from 12 values
    (duplicates), INT64_MAX padding shuffled between them; keys from a
    wider range, every seventh INT64_MAX."""
    rng = np.random.RandomState(seed)
    heavy = np.concatenate([rng.randint(-6, 6, real),
                            np.full(m - real, I64_MAX)]).astype(np.int64)
    rng.shuffle(heavy)
    keys = rng.randint(-9, 9, n).astype(np.int64)
    keys[::7] = I64_MAX
    return keys, heavy


# (name, n, m, keys that are not padding)
MEMBER_CASES = [
    ("m = 0", 40, 0, 0),
    ("m = 1", 40, 1, 1),
    ("m = 1, padding only", 40, 1, 0),
    ("duplicates, padding between", 100, 12, 9),
    ("n < 8", 5, 6, 6),
    ("n = 8", 8, 6, 4),
    ("n = 9", 9, 6, 4),
    ("a power of two", 77, 8, 8),
    ("one over a power of two", 77, 9, 9),
    ("the largest sorted set", 130, 16, 16),
    ("more keys than one round of the grid", 300, 16, 11),
    ("staged: one over the largest sorted set", 60, 17, 10),
    ("staged", 60, 40, 30),
]
MEMBER_CONFIGS = [dict(threads=4, blocks=3), dict(threads=2, blocks=5)]


@pytest.mark.parametrize("case", range(len(MEMBER_CASES)),
                         ids=[c[0] for c in MEMBER_CASES])
@pytest.mark.parametrize("cfg", range(len(MEMBER_CONFIGS)))
@pytest.mark.parametrize("key_shift", [0, 8])
def test_member_model_equals_plain(case, cfg, key_shift):
    """Bit-exact against the plain version (INT64_MAX never matches);
    every flag written once, one 8-byte store for each 8 keys before
    the end; each key searched in log2 P steps; each block sorts the set
    once."""
    _, n, m, real = MEMBER_CASES[case]
    keys, heavy = _member_inputs(n, m, real, seed=case)
    out, c = member_model(keys, heavy, key_shift=key_shift,
                          **MEMBER_CONFIGS[cfg])
    np.testing.assert_array_equal(out, _member_plain(keys, heavy))
    assert (c["writes"] == 1).all()
    if m <= 16:
        steps = max(real - 1, 0).bit_length()
        assert c["steps"] == -(-n // 8) * 8 * steps
        assert c["stores8"] == n // 8
        assert c["words"] == sum(1 for r0 in range(0, n, 8)
                                 for j in range(4 + key_shift // 8)
                                 if r0 + 2 * j - key_shift // 8 < n)


def test_member_model_set_order_does_not_matter():
    """The same set sorted, reversed and shuffled: the same flags."""
    keys, heavy = _member_inputs(200, 14, 11, seed=3)
    want = _member_plain(keys, heavy)
    for h in (np.sort(heavy), np.sort(heavy)[::-1], heavy):
        np.testing.assert_array_equal(member_model(keys, h)[0], want)


@pytest.mark.parametrize("fault", ["ties", "short", "head"])
def test_member_model_controls_disagree(fault):
    """The controls: equal keys of the set that take one rank, a search
    one step short, and keys read at the wrong head offset each
    disagree with the plain version."""
    keys, heavy = _member_inputs(200, 16, 14, seed=4)
    out, _ = member_model(keys, heavy, key_shift=8, fault=fault)
    assert not np.array_equal(out, _member_plain(keys, heavy))
