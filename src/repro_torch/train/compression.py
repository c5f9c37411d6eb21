"""Gradient compression: int8 error-feedback all-reduce.

PyTorch twin of ``repro.train.compression``. For the slow inter-pod hop,
gradients are reduced in int8 with per-chunk fp32 scales and an
error-feedback residual (the quantization error is carried into the
next step). The collective is a reduce-scatter (an all_to_all of
quantized chunks, then a local sum) followed by an all_gather of the
re-quantized result:

    bytes ~ 2 x (P-1)/P x N x 1  vs  2 x (P-1)/P x N x 4  uncompressed

The reference runs it inside ``shard_map`` over the "pod" axis. Here it
runs once per site of a virtual mesh (``exec.dist.run_on_sites``), and
the site's ``DistContext`` holds the collectives: its rendezvous gives
the all_to_all and the all_gather, as it does for the query engine's
exchanges. A one-site run builds its own context. As in the reference,
nothing calls it: the launcher parses ``--compress`` and never reads it.

The results are the reference's bit for bit where XLA rounds op by op
(as ``jax.disable_jit()`` runs it), on the CPU and on the card alike:
``x / scale`` and the divisions by 127 and by the sites stay f32
divisions, ``torch.round``, like ``jnp.round``, rounds half to even, and
the received chunks are summed in site order. Compiled for the CPU, XLA
contracts ``x - q * scale`` into one fused multiply-add and turns the
division by 127 into a product with its reciprocal, so the reference's
jitted mean and residual move by an ulp here and there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import tree as TR
from ..exec.dist import DistContext


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` for a number ``b``, divided on every device: PyTorch's
    CUDA kernel multiplies by the reciprocal of a Python number instead,
    which can round otherwise."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _div(torch.max(torch.abs(x)), 127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _site_context(ctx: Optional[DistContext], axis: str, n: int,
                  device) -> DistContext:
    """The site's context: ``ctx``, checked against the axis and its size,
    or a one-site context of its own where ``n`` is 1."""
    if ctx is None:
        if n != 1:
            raise ValueError(
                f"a mean over {n} sites of axis {axis!r} needs the site's "
                f"DistContext (ctx=...): run it on every site of the mesh "
                f"(exec.dist.run_on_sites)")
        return DistContext(axis, 1, device=device)
    if ctx.axis != axis or ctx.P != n:
        raise ValueError(f"the site's context is of axis {ctx.axis!r} with "
                         f"{ctx.P} sites; the call names {axis!r} with {n}")
    return ctx


def _all_gather(ctx: DistContext, v: torch.Tensor) -> torch.Tensor:
    """``jax.lax.all_gather(v, axis, tiled=False)``: the sites' values
    stacked in site order."""
    return torch.stack(ctx._gather("all_gather", v))


def _sum_in_site_order(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x, axis=0)`` as XLA sums a few rows: one after the other.
    ``torch.sum`` over dim 0 of a short row may pair them otherwise."""
    acc = x[0]
    for row in x[1:]:
        acc = acc + row
    return acc


def compressed_psum_mean(x: torch.Tensor, axis: str, n: int,
                         residual: torch.Tensor,
                         ctx: Optional[DistContext] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean-all-reduce of a flat f32 vector over the
    ``n`` sites of ``axis``; ``ctx`` is this site's context (see the
    module docstring). Returns (mean, new_residual)."""
    ctx = _site_context(ctx, axis, n, x.device)
    x = x + residual                     # error feedback
    pad = (-x.shape[0]) % n
    xp = F.pad(x, (0, pad))
    chunks = xp.reshape(n, -1)           # chunk d -> destination d
    # per-chunk quantization
    scales = _div(torch.amax(torch.abs(chunks), dim=1), 127.0) + 1e-12
    q = torch.clamp(torch.round(chunks / scales[:, None]), -127, 127
                    ).to(torch.int8)
    # reduce-scatter: all_to_all chunks, sum dequantized locally
    q_recv = ctx._all_to_all(q)
    s_recv = ctx._all_to_all(scales.reshape(n, 1))
    local = _div(_sum_in_site_order(q_recv.to(torch.float32) * s_recv), n)
    # re-quantize the reduced shard and all_gather
    q2, s2 = quantize_int8(local)
    qg = _all_gather(ctx, q2)                                # (n, chunk)
    sg = _all_gather(ctx, s2.reshape(1))
    mean = (qg.to(torch.float32) * sg.reshape(n, 1)).reshape(-1)
    mean = mean[:x.shape[0]]
    # residual: what this site failed to communicate, against a second
    # quantization of the whole vector (the reference's, as written)
    sent = dequantize_int8(*quantize_int8(x))
    new_residual = x - sent
    return mean, new_residual


def tree_compressed_mean(grads, axis: str, n: int, residuals,
                         ctx: Optional[DistContext] = None):
    """Apply compressed mean-all-reduce leaf-wise (flattened)."""
    outs, new_res = [], []
    for g, r in zip(TR.leaves(grads), TR.leaves_up_to(grads, residuals)):
        m, nr = compressed_psum_mean(g.reshape(-1).to(torch.float32),
                                     axis, n, r.reshape(-1), ctx)
        outs.append(m.reshape(g.shape))
        new_res.append(nr.reshape(g.shape))
    return TR.unflatten_like(grads, outs), TR.unflatten_like(grads, new_res)
