"""Public wrappers for the ported kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel; a CPU tensor
runs the plain PyTorch version in ``ref.py``, and so does a tensor on
the ``meta`` device (shapes only, for the dry-run: a loop of identical
steps there, a recurrence's or the plain attention's over batch rows
and heads, runs its first step under ``meta_trips``); any other device
raises.
There is no fallback from a failed launch and no switch to the plain
version on the GPU: ``chip_smoke.py`` calls the ``ref`` functions
directly when it compares.

Gradients: ``flash_attention`` and ``rwkv6_scan`` are
``torch.autograd.Function``s (``FlashAttention``, ``RWKV6``) where grad
mode is on and an input requires grad. Their backward dispatches by
device as their forward does: the hand-written backward kernel on the
card, the plain backward formula (``ref.attention_bwd_ref``,
``ref.rwkv6_bwd_ref``) on the CPU. Every other kernel has no backward:
its wrapper raises on a CUDA input that requires grad in grad mode,
where the kernel's output would silently carry none.

The batched pass (``batched_pass``): inside it, ``segment_sum_first``,
``merge_positions`` and ``gather_rows`` go through ``torch.library``
custom ops, so that ``torch.func.vmap`` hands a batched call to the op's
vmap rule, which launches the batched kernel once for the whole batch on
the card and runs the plain version a slice at a time on the CPU.
Outside it the wrappers launch directly, with no dispatcher between.

Launch counts: ``launch_counts()`` reads the plain-integer counter each
kernel wrapper keeps, ``reset_launch_counts()`` zeroes them.
``batched_launch_counts()`` says how many of those launches ran a batch
(on the path, the vmap rules' launches on the card).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from . import (decode, flash_attention as flash_attention_kernel,
               gather_join, ref, rwkv6_scan as rwkv6_kernel, segment_fused,
               segment_reduce as segment_reduce_kernel, shuffle_pack)


def detect_backend() -> str:
    """The backend the kernels dispatch to, read from the device: "cuda"
    where PyTorch sees a GPU, else "cpu". It changes no routing (each
    call dispatches by its tensors' device), where the reference's sets
    its Pallas interpret mode."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _route(t: torch.Tensor, what: str, *inputs) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU and
    meta).
    Raises for a CUDA call where grad mode is on and one of ``inputs``
    (the kernel's tensors) requires grad: the kernel has no backward."""
    if t.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                torch.is_tensor(x) and x.requires_grad for x in inputs):
            raise RuntimeError(
                f"{what}: the CUDA kernel has no backward, and an input "
                "requires grad; call it under torch.no_grad() or on "
                "detached tensors")
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Sorted-segment sum. values (n,) or (n, d), summed in f32 and cast
    back to their dtype; rows with ids outside [0, num_segments) are
    dropped."""
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    dtype = values.dtype
    if not _route(seg_ids, "segment_reduce", values, seg_ids):
        out = ref.segment_reduce_ref(values.to(torch.float32), seg_ids,
                                     num_segments)
    else:
        out = segment_reduce_kernel.segment_reduce_cuda(
            values.to(torch.float32).contiguous(),
            seg_ids.to(torch.int32).contiguous(), num_segments)
    out = out.to(dtype)
    return out[:, 0] if squeeze else out


def segment_sum_first(values: torch.Tensor, keys: torch.Tensor,
                      seg_ids: torch.Tensor, num_segments: int) -> tuple:
    """Fused Gamma tail: (segment sums f32, first-row index i32,
    first-row key values i64). values (n, d); keys (n, k) int64
    bit-views; seg_ids (n,) non-decreasing."""
    if _in_batched_pass():
        return _batched_ops()["segment_sum_first"](values, keys, seg_ids,
                                                   num_segments)
    return _segment_sum_first(values, keys, seg_ids, num_segments)


def _segment_sum_first(values, keys, seg_ids, num_segments: int) -> tuple:
    if not _route(seg_ids, "segment_sum_first", values, keys, seg_ids):
        return ref.segment_sum_first_ref(values, keys, seg_ids,
                                         num_segments)
    return segment_fused.segment_sum_first_cuda(
        values.to(torch.float32).contiguous(), keys.contiguous(),
        seg_ids.to(torch.int32).contiguous(), num_segments)


def merge_positions(sorted_keys: torch.Tensor, queries: torch.Tensor
                    ) -> tuple:
    """(lo, hi) = searchsorted(sorted_keys, queries, left/right) as
    int32 — the join inner loop's position step."""
    if _in_batched_pass():
        return _batched_ops()["merge_positions"](sorted_keys, queries)
    return _merge_positions(sorted_keys, queries)


def _merge_positions(sorted_keys, queries) -> tuple:
    if not _route(queries, "merge_positions", sorted_keys, queries):
        return ref.merge_positions_ref(sorted_keys, queries)
    return gather_join.merge_positions_cuda(
        sorted_keys.to(torch.int64).contiguous(),
        queries.to(torch.int64).contiguous())


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather over int64 bit-views; out-of-range indices gather 0."""
    if _in_batched_pass():
        return _batched_ops()["gather_rows"](values, idx)
    return _gather_rows(values, idx)


def _gather_rows(values, idx) -> torch.Tensor:
    if not _route(values, "gather_rows", values, idx):
        return ref.gather_rows_ref(values, idx)
    return gather_join.gather_rows_cuda(values.contiguous(),
                                        idx.to(torch.int64).contiguous())


# ---------------------------------------------------------------------------
# the batched pass: custom ops whose vmap rules launch the batched kernels
# ---------------------------------------------------------------------------

_PASS = threading.local()
_OPS_LOCK = threading.Lock()
_OPS: dict = {}


def _in_batched_pass() -> bool:
    return getattr(_PASS, "on", False)


@contextlib.contextmanager
def batched_pass():
    """Inside the block (on this thread), ``segment_sum_first``,
    ``merge_positions`` and ``gather_rows`` call their custom ops
    (``repro_torch::<name>``). Under ``torch.func.vmap`` a call with a
    batched operand goes to the op's vmap rule: on the card one launch of
    the batched kernel for the whole batch (an operand without a batch
    axis is shared, batch stride 0, not copied), which raises if it
    cannot launch; on the CPU the plain version a slice at a time. A call
    whose operands carry no batch axis runs the op's own function: one
    launch, as outside the block. The batched executor
    (``core.codegen.vmap_program``) sets it around its vmap."""
    prev = _in_batched_pass()
    _PASS.on = True
    try:
        yield
    finally:
        _PASS.on = prev


def _operands(in_dims, *xs) -> tuple:
    """(tensor, batched) for each operand, the batch axis moved first."""
    return tuple((x, False) if d is None else (x.movedim(d, 0), True)
                 for x, d in zip(xs, in_dims))


def _slice_calls(B: int, fn, ops, *rest) -> tuple:
    """The plain version over the batch, a slice at a time, its outputs
    stacked along a new leading batch axis."""
    outs = [fn(*(x[b] if batched else x for x, batched in ops), *rest)
            for b in range(B)]
    if torch.is_tensor(outs[0]):
        return torch.stack(outs)
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _ssf_vmap(info, in_dims, values, keys, seg_ids, num_segments):
    ops = _operands(in_dims, values, keys, seg_ids)
    (v, _), (k, _), (s, _) = ops
    if not _route(s, "segment_sum_first", v, k, s):
        return _slice_calls(info.batch_size, ref.segment_sum_first_ref, ops,
                            num_segments), (0, 0, 0)
    return segment_fused.segment_sum_first_cuda(
        v.to(torch.float32).contiguous(), k.contiguous(),
        s.to(torch.int32).contiguous(), num_segments,
        info.batch_size), (0, 0, 0)


def _merge_vmap(info, in_dims, sorted_keys, queries):
    ops = _operands(in_dims, sorted_keys, queries)
    (k, _), (q, _) = ops
    if not _route(q, "merge_positions", k, q):
        return _slice_calls(info.batch_size, ref.merge_positions_ref,
                            ops), (0, 0)
    return gather_join.merge_positions_cuda(
        k.to(torch.int64).contiguous(), q.to(torch.int64).contiguous(),
        info.batch_size), (0, 0)


def _gather_vmap(info, in_dims, values, idx):
    ops = _operands(in_dims, values, idx)
    (v, _), (i, _) = ops
    if not _route(v, "gather_rows", v, i):
        return _slice_calls(info.batch_size, ref.gather_rows_ref, ops), 0
    return gather_join.gather_rows_cuda(
        v.contiguous(), i.to(torch.int64).contiguous(), info.batch_size), 0


def _batched_ops() -> dict:
    """The three custom ops, defined with their vmap rules at first use
    (nothing is registered when the module is imported)."""
    with _OPS_LOCK:
        if not _OPS:
            for name, fn, schema, rule in (
                    ("segment_sum_first", _segment_sum_first,
                     "(Tensor values, Tensor keys, Tensor seg_ids, "
                     "int num_segments) -> (Tensor, Tensor, Tensor)",
                     _ssf_vmap),
                    ("merge_positions", _merge_positions,
                     "(Tensor sorted_keys, Tensor queries) -> "
                     "(Tensor, Tensor)", _merge_vmap),
                    ("gather_rows", _gather_rows,
                     "(Tensor values, Tensor idx) -> Tensor", _gather_vmap)):
                op = torch.library.custom_op(f"repro_torch::{name}", fn,
                                             mutates_args=(), schema=schema)
                torch.library.register_vmap(op, rule)
                _OPS[name] = op
        return _OPS


def pack_rows(values: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor
              ) -> torch.Tensor:
    """The packed exchange's send buffer: out[j] = values[idx[j]] where
    ``ok[j]`` and idx in range, else 0. values (r, d) int64 bit-view
    lanes; idx int32/int64; ok bool/int32."""
    if not _route(values, "pack_rows", values, idx, ok):
        return ref.pack_rows_ref(values, idx, ok)
    return shuffle_pack.pack_rows_cuda(values.contiguous(), idx.contiguous(),
                                       ok.contiguous())


def replicate_scatter(values: torch.Tensor, vidx: torch.Tensor,
                      ok: torch.Tensor, repl: int) -> torch.Tensor:
    """The HyperCube replicating scatter: pack_rows from source row
    ``vidx[j] // repl``; negative ids give 0."""
    if not _route(values, "replicate_scatter", values, vidx, ok):
        return ref.replicate_scatter_ref(values, vidx, ok, repl)
    return shuffle_pack.replicate_scatter_cuda(
        values.contiguous(), vidx.contiguous(), ok.contiguous(), repl)


def unpack_cols(buf: torch.Tensor) -> torch.Tensor:
    """(rows, lanes) wire buffer -> contiguous (lanes, rows)."""
    if not _route(buf, "unpack_cols", buf):
        return ref.unpack_cols_ref(buf)
    return shuffle_pack.unpack_cols_cuda(buf.contiguous())


def member_mask(keys: torch.Tensor, heavy: torch.Tensor) -> torch.Tensor:
    """keys[i] in the padded heavy-key set (INT64_MAX never matches)."""
    if not _route(keys, "member_mask", keys, heavy):
        return ref.member_mask_ref(keys, heavy)
    return shuffle_pack.member_mask_cuda(keys.to(torch.int64).contiguous(),
                                         heavy.to(torch.int64).contiguous())


def _into(out: Optional[torch.Tensor], res: torch.Tensor) -> torch.Tensor:
    if out is None:
        return res
    return out.copy_(res)


def rle_expand(values: torch.Tensor, lengths: torch.Tensor, n: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run-length expand: out[i] = values[j] for the run j covering row
    i; the runs, ``lengths[j]`` rows each, tile [0, n). int64 bit-views;
    ``lengths`` at their stored width. ``out``: an optional (n,) int64
    tensor to decode into."""
    if not _route(values, "rle_expand", values, lengths, out):
        return _into(out, ref.rle_expand_ref(values, lengths, n))
    return decode.rle_expand_cuda(values.contiguous(), lengths.contiguous(),
                                  n, out)


def delta_unpack(z: torch.Tensor, first: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zigzag-delta decode: first + inclusive modular-uint64 prefix sum
    of the decoded deltas, as int64 bits. ``z`` unsigned at its stored
    width; ``first`` the uint64 start value as a Python int."""
    if not _route(z, "delta_unpack", z, out):
        return _into(out, ref.delta_unpack_ref(z, first))
    return decode.delta_unpack_cuda(z.contiguous(), first, out)


def bitunpack(words: torch.Tensor, k: int, vpw: int, n: int, lo: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame-of-reference unpack: k-bit values, vpw per uint32 word,
    + lo -> int64, trimmed to n rows."""
    if not _route(words, "bitunpack", words, out):
        return _into(out, ref.bitunpack_ref(words, k, vpw, n, lo))
    return decode.bitunpack_cuda(words.contiguous(), k, vpw, n, lo, out)


def dict_gather(values: torch.Tensor, codes: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dictionary decode: out[i] = values[codes[i]] (int64 bit-views;
    out-of-range codes gather 0). ``codes`` at their stored width."""
    if not _route(values, "dict_gather", values, codes, out):
        return _into(out, ref.dict_gather_ref(values, codes))
    return decode.dict_gather_cuda(values.contiguous(), codes.contiguous(),
                                   out)


# ---------------------------------------------------------------------------
# the meta device: loops of identical steps counted by their trip count
# ---------------------------------------------------------------------------

TRIP_COUNTERS: list = []
"""The counters of a dry-run (``launch.dryrun.Tally``) that are on: each
has ``mark()``, its totals so far, and ``repeat(mark, times)``, which
counts what it saw since ``mark`` ``times`` more times."""


@contextlib.contextmanager
def meta_trips(n: int):
    """Every op run inside counts ``n`` times in each of ``TRIP_COUNTERS``.
    A recurrence of ``n`` steps of one shape runs only its first step on
    the meta device, under this; the reference's dry-run scales a rolled
    loop's body by its trip count the same way
    (``launch/hlo_analysis.py``)."""
    marks = [(c, c.mark()) for c in TRIP_COUNTERS]
    yield
    for c, m in marks:
        c.repeat(m, n - 1)


def _meta_recurrence(fn, seqs: tuple, *rest):
    """``fn(*seqs, *rest)`` on the meta device, where the tensors of
    ``seqs`` run over T steps along dim 2: ``fn`` runs on their first
    step under ``meta_trips(T)``, and every output with a step dim gets
    T steps back."""
    T = seqs[0].shape[2]
    with meta_trips(T):
        out = fn(*(x[:, :, :1] for x in seqs), *rest)

    def full(o):
        if o.dim() < 3 or o.shape[2] != 1:
            return o
        return o.new_empty(o.shape[:2] + (T,) + o.shape[3:])

    return tuple(full(o) for o in out) if isinstance(out, tuple) \
        else full(out)


def _meta_heads(fn, qs: tuple, kvs: tuple):
    """``fn(*qs, *kvs)`` on the meta device, where the plain attention
    loops over batch rows and KV heads: it runs on batch row 0 and KV
    head 0 (``qs`` cut to that head's group of query heads) under
    ``meta_trips(B * Hkv)``. The caller shapes the outputs."""
    B, H = qs[0].shape[:2]
    Hkv = kvs[0].shape[1]
    with meta_trips(B * Hkv):
        return fn(*(x[:1, :H // Hkv] for x in qs),
                  *(x[:1, :1] for x in kvs))


def _needs_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in inputs)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient. Where autograd records
    (``record``), the forward also writes the row log-sum-exp and keeps
    its inputs and output, and the backward computes dq, dk and dv from
    them, by the kernels on the card and by ``ref.attention_bwd_ref`` on
    the CPU; otherwise the forward writes no log-sum-exp and keeps
    nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, record=True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _route(q, "flash_attention"):
            res = flash_attention_kernel.flash_attention_cuda(
                q, k, v, causal, window, softcap, scale, with_lse=record)
        else:
            flash_attention_kernel.check_masks(q.shape[2], k.shape[2],
                                               causal, window)
            if q.device.type == "meta":
                _meta_heads(lambda q, k, v: ref.attention_ref(
                    q, k, v, causal, window, softcap, scale,
                    with_lse=record), (q,), (k, v))
                o = q.new_empty(q.shape)
                res = (o, q.new_empty(q.shape[:3],
                                      dtype=ref._acc_dtype(q))) \
                    if record else o
            else:
                res = ref.attention_ref(q, k, v, causal, window, softcap,
                                        scale, with_lse=record)
        if not record:
            return res
        o, lse = res
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, softcap, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if _route(q, "flash_attention backward"):
            grads = flash_attention_kernel.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, *ctx.args)
        elif q.device.type == "meta":
            _meta_heads(lambda q, o, lse, do, k, v: ref.attention_bwd_ref(
                q, k, v, o, lse, do, *ctx.args), (q, o, lse, do), (k, v))
            grads = (q.new_empty(q.shape), k.new_empty(k.shape),
                     v.new_empty(v.shape))
        else:
            grads = ref.attention_bwd_ref(q, k, v, o, lse, do, *ctx.args)
        return (*grads, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Softmax attention of q (B, H, Sq, D) over k, v (B, Hkv, Sk, D)
    with GQA, causal and sliding-window masks (rows and keys counted
    from 0) and logit soft-capping; f32 arithmetic, out in q's dtype.
    Refuses calls where a query row has no unmasked key. Differentiable
    (``FlashAttention``) where grad mode is on and an input requires
    grad; otherwise the forward alone, which writes no log-sum-exp.

    ``block_q`` and ``block_k`` are the Pallas kernel's tile sizes, a TPU
    choice: the Hopper kernel does not read them (it tiles by its own
    rule), and values that are not positive integers raise."""
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if isinstance(b, bool) or not isinstance(b, int) or b < 1:
            raise ValueError(f"flash_attention: {name} must be a positive "
                             f"integer, got {b!r}")
    return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                _needs_grad(q, k, v))


class RWKV6(torch.autograd.Function):
    """``rwkv6_scan`` with its gradient (dr, dk, dv, dw and du), by the
    backward kernel on the card and by ``ref.rwkv6_bwd_ref`` on the
    CPU. u comes in f32 and its gradient goes out in f32. The forward
    keeps its inputs only where autograd records (``record``)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk, record=True):
        r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
        if _route(r, "rwkv6_scan"):
            o = rwkv6_kernel.rwkv6_cuda(r, k, v, w, u, chunk)
        elif r.device.type == "meta":
            o = _meta_recurrence(ref.rwkv6_ref, (r, k, v, w), u)
        else:
            o = ref.rwkv6_ref(r, k, v, w, u)
        if record:
            ctx.save_for_backward(r, k, v, w, u)
            ctx.chunk = chunk
        return o

    @staticmethod
    def backward(ctx, do):
        r, k, v, w, u = ctx.saved_tensors
        do = do.to(r.dtype).contiguous()
        if _route(r, "rwkv6_scan backward"):
            grads = rwkv6_kernel.rwkv6_bwd_cuda(r, k, v, w, u, do, ctx.chunk)
        elif r.device.type == "meta":
            grads = _meta_recurrence(
                lambda r, k, v, w, do: ref.rwkv6_bwd_ref(r, k, v, w, u, do,
                                                         ctx.chunk),
                (r, k, v, w, do))
        else:
            grads = ref.rwkv6_bwd_ref(r, k, v, w, u, do, ctx.chunk)
        return (*grads, None, None)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, chunk: int = 64
               ) -> torch.Tensor:
    """The RWKV-6 recurrence: r, k, w (B, H, T, K), v (B, H, T, V), u
    (H, K) -> (B, H, T, V) in r's dtype, f32 inside. The kernel runs the
    chunked form with chunks of ``chunk`` steps; the plain version the
    sequential recurrence (the chunk changes only the rounding).
    Differentiable (``RWKV6``) where grad mode is on and an input
    requires grad."""
    u = u.to(torch.float32)
    return RWKV6.apply(r, k, v, w, u, chunk, _needs_grad(r, k, v, w, u))


def launch_counts() -> dict:
    return {"segment_reduce": segment_reduce_kernel.LAUNCHES,
            "segment_sum_first": segment_fused.LAUNCHES,
            "merge_positions": gather_join.MERGE_LAUNCHES,
            "gather_rows": gather_join.GATHER_LAUNCHES,
            "rle_expand": decode.RLE_LAUNCHES,
            "delta_unpack": decode.DELTA_LAUNCHES,
            "bitunpack": decode.BITUNPACK_LAUNCHES,
            "dict_gather": decode.DICT_LAUNCHES,
            "member_mask": shuffle_pack.MEMBER_LAUNCHES,
            "pack_rows": shuffle_pack.PACK_LAUNCHES,
            "unpack_cols": shuffle_pack.UNPACK_LAUNCHES,
            "replicate_scatter": shuffle_pack.REPL_LAUNCHES,
            "flash_attention": sum(
                flash_attention_kernel.PATH_LAUNCHES.values()),
            "flash_attention_bwd": sum(
                flash_attention_kernel.BWD_PATH_LAUNCHES.values()),
            "rwkv6": rwkv6_kernel.LAUNCHES,
            "rwkv6_bwd": rwkv6_kernel.BWD_LAUNCHES}


def batched_launch_counts() -> dict:
    """Of ``launch_counts()``' segment_sum_first, merge_positions and
    gather_rows, the launches that ran a batch of calls (a wrapper given
    a batch size)."""
    return {"segment_sum_first": segment_fused.BATCHED_LAUNCHES,
            "merge_positions": gather_join.MERGE_BATCHED_LAUNCHES,
            "gather_rows": gather_join.GATHER_BATCHED_LAUNCHES}


def reset_launch_counts() -> None:
    segment_fused.BATCHED_LAUNCHES = 0
    gather_join.MERGE_BATCHED_LAUNCHES = 0
    gather_join.GATHER_BATCHED_LAUNCHES = 0
    segment_reduce_kernel.LAUNCHES = 0
    segment_fused.LAUNCHES = 0
    gather_join.MERGE_LAUNCHES = 0
    gather_join.GATHER_LAUNCHES = 0
    decode.RLE_LAUNCHES = 0
    decode.DELTA_LAUNCHES = 0
    decode.BITUNPACK_LAUNCHES = 0
    decode.DICT_LAUNCHES = 0
    shuffle_pack.MEMBER_LAUNCHES = 0
    shuffle_pack.PACK_LAUNCHES = 0
    shuffle_pack.UNPACK_LAUNCHES = 0
    shuffle_pack.REPL_LAUNCHES = 0
    flash_attention_kernel.reset_path_launches()
    rwkv6_kernel.LAUNCHES = 0
    rwkv6_kernel.BWD_LAUNCHES = 0
