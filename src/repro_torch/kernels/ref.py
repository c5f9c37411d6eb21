"""Plain PyTorch versions of the ported kernels (mirrors the matching
functions of ``repro.kernels.ref``). The dispatch in ``ops.py`` runs
them for tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card."""

from __future__ import annotations

from typing import Optional

import torch

I32_MAX = torch.iinfo(torch.int32).max
I64_MAX = torch.iinfo(torch.int64).max


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum with out-of-range ids dropped."""
    if num_segments == 0:      # no row to add into (CUDA asserts on it)
        return values.new_zeros((0,) + tuple(values.shape[1:]))
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    vals = torch.where(ok[:, None], values, torch.zeros_like(values))
    ids = torch.where(ok, seg_ids, torch.zeros_like(seg_ids)).to(torch.int64)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add(0, ids, vals)


def segment_sum_first_ref(values: torch.Tensor, keys: torch.Tensor,
                          seg_ids: torch.Tensor, num_segments: int) -> tuple:
    """(segment sums, first-row index per segment, first-row key
    values). Empty segments: firstidx == INT32_MAX, firstvals == 0.
    Out-of-range seg_ids are dropped."""
    n = seg_ids.shape[0]
    dev = seg_ids.device
    sums = segment_reduce_ref(values, seg_ids, num_segments)
    fidx = torch.full((num_segments,), I32_MAX, dtype=torch.int32,
                      device=dev)
    if num_segments > 0:
        # a dropped row takes part as INT32_MAX at slot 0, which moves no
        # minimum: no shape here depends on the data, so torch.func.vmap
        # maps it
        ok = (seg_ids >= 0) & (seg_ids < num_segments)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        fidx = fidx.scatter_reduce(
            0, torch.where(ok, seg_ids, 0).to(torch.int64),
            torch.where(ok, idx, I32_MAX), "amin")
    exists = fidx < n
    gathered = keys[fidx.clamp(0, max(n - 1, 0)).to(torch.int64)]
    fvals = torch.where(exists[:, None], gathered, torch.zeros_like(gathered))
    return sums, fidx, fvals


def merge_positions_ref(sorted_keys: torch.Tensor, queries: torch.Tensor
                        ) -> tuple:
    """Left/right insertion points (the double searchsorted of the join
    inner loop), as int32."""
    sorted_keys = sorted_keys.to(torch.int64)
    queries = queries.to(torch.int64)
    lo = torch.searchsorted(sorted_keys, queries, side="left",
                            out_int32=True)
    hi = torch.searchsorted(sorted_keys, queries, side="right",
                            out_int32=True)
    return lo, hi


def gather_rows_ref(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with out-of-range indices mapped to 0."""
    r = values.shape[0]
    ok = (idx >= 0) & (idx < r)
    g = values[idx.clamp(0, r - 1).to(torch.int64)]
    return torch.where(ok[:, None], g, torch.zeros_like(g))



# ---------------------------------------------------------------------------
# packed shuffle (repro.kernels.ref pack_rows_ref .. member_mask_ref)
# ---------------------------------------------------------------------------

def _masked_rows(values: torch.Tensor, src: torch.Tensor,
                 good: torch.Tensor) -> torch.Tensor:
    r = values.shape[0]
    if r == 0:
        return torch.zeros((src.shape[0],) + tuple(values.shape[1:]),
                           dtype=values.dtype, device=values.device)
    g = values[src.clamp(0, r - 1)]
    return torch.where(good[:, None], g, torch.zeros_like(g))


def pack_rows_ref(values: torch.Tensor, idx: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """Masked row gather that fills the packed shuffle send buffer:
    slots with ``ok`` False or an index outside [0, r) come back 0."""
    idx = idx.to(torch.int64)
    good = ok.to(torch.bool) & (idx >= 0) & (idx < values.shape[0])
    return _masked_rows(values, idx, good)


def replicate_scatter_ref(values: torch.Tensor, vidx: torch.Tensor,
                          ok: torch.Tensor, repl: int) -> torch.Tensor:
    """``pack_rows_ref`` over VIRTUAL row ids: slot j receives source row
    ``vidx[j] // repl`` (each source row has ``repl`` virtual replicas).
    Slots with ``ok`` False, a negative id or a source row out of range
    come back 0."""
    vidx = vidx.to(torch.int64)
    src = vidx // int(repl)
    good = ok.to(torch.bool) & (vidx >= 0) & (src < values.shape[0])
    return _masked_rows(values, src, good)


def unpack_cols_ref(buf: torch.Tensor) -> torch.Tensor:
    """(rows, lanes) wire buffer to contiguous (lanes, rows) columns."""
    return buf.t().contiguous()


def member_mask_ref(keys: torch.Tensor, heavy: torch.Tensor
                    ) -> torch.Tensor:
    """Per-key membership in the padded heavy-key set; INT64_MAX never
    matches, as a key or as a heavy slot. The set need not be sorted."""
    hit = (keys[:, None] == heavy[None, :]) & (heavy[None, :] != I64_MAX)
    return hit.any(dim=1) & (keys != I64_MAX)

# ---------------------------------------------------------------------------
# compressed-chunk decode (repro.kernels.ref rle_expand_ref .. dict_gather_ref)
# ---------------------------------------------------------------------------

def widen_unsigned(z: torch.Tensor) -> torch.Tensor:
    """An unsigned integer member (torch.uint8/16/32/64) as int64 holding
    the same bits: zero-extended below 64 bits, a bit view at 64."""
    if z.dtype == torch.uint64:
        return z.view(torch.int64)
    if z.dtype not in (torch.uint8, torch.uint16, torch.uint32):
        raise TypeError(f"widen_unsigned: want an unsigned integer "
                        f"tensor; got {z.dtype}")
    return z.to(torch.int64)


def rle_expand_ref(values: torch.Tensor, lengths: torch.Tensor,
                   n: int) -> torch.Tensor:
    """out[i] = the value of the run covering row i; run j is
    ``lengths[j]`` rows long and the runs tile [0, n). int64 bit-views.
    The reference's plain version takes the runs as ``[starts[j],
    ends[j])``, which its reader makes from these lengths on the host;
    the port takes the stored lengths."""
    ends = torch.cumsum(lengths.to(torch.int64), 0)
    starts = ends - lengths.to(torch.int64)
    idx = torch.searchsorted(starts,
                             torch.arange(n, dtype=torch.int64,
                                          device=values.device),
                             right=True) - 1
    r = values.shape[0]
    return values[idx.clamp(0, max(r - 1, 0))]


def delta_unpack_ref(z: torch.Tensor, first: int) -> torch.Tensor:
    """Zigzag-decode the deltas and take the inclusive prefix sum from
    ``first`` modulo 2**64, as int64 bits. ``z`` is an unsigned tensor
    at its stored width; ``first`` the uint64 start value (or its int64
    bits) as a Python int. Every step is int64 arithmetic: the logical
    shift is an arithmetic shift with the top bit cleared, and the sum
    wraps as two's complement does (``torch.cumsum`` on int64 wraps;
    ``tests/test_torch_decode.py`` pins that at the extremes)."""
    u = widen_unsigned(z)
    d = ((u >> 1) & I64_MAX) ^ -(u & 1)
    return torch.cumsum(d, 0) + _as_int64_bits(first)


def bitunpack_ref(words: torch.Tensor, k: int, vpw: int, n: int,
                  lo: int) -> torch.Tensor:
    """Frame-of-reference unpack of ``k``-bit values, ``vpw`` per uint32
    word (never straddling), plus ``lo`` (wrapping in int64)."""
    w = widen_unsigned(words)
    rep = torch.repeat_interleave(w, vpw)[:n]
    pos = torch.arange(n, dtype=torch.int64, device=w.device) % vpw
    vals = (rep >> (pos * k)) & ((1 << k) - 1)
    return vals + _as_int64_bits(lo)


def dict_gather_ref(values: torch.Tensor, codes: torch.Tensor
                    ) -> torch.Tensor:
    """out[i] = values[codes[i]]; out-of-range codes (negative, or
    >= r) gather 0, as ``gather_rows_ref`` does."""
    r = values.shape[0]
    c = codes.to(torch.int64)
    ok = (c >= 0) & (c < r)
    if r == 0:
        return torch.zeros(c.shape, dtype=values.dtype, device=values.device)
    g = values[c.clamp(0, r - 1)]
    return torch.where(ok, g, torch.zeros_like(g))


def _as_int64_bits(v: int) -> int:
    """A Python int in [-2**63, 2**64) as the int64 with its low 64
    bits."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# LM kernels (repro.kernels.ref attention_ref, rwkv6_ref)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The LM plain versions' arithmetic: f32, or f64 for f64 inputs (so
    that ``torch.autograd.gradcheck`` can hold the backward formulas to
    finite differences)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _attention_mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
                    device) -> torch.Tensor:
    rows = torch.arange(Sq, device=device)[:, None]
    cols = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def _scores(qg: torch.Tensor, kj: torch.Tensor, mask: torch.Tensor,
            scale: float, softcap: Optional[float]) -> tuple:
    """(masked scores, tanh(s / softcap) or None) of one batch row's
    group of query heads qg (G, Sq, D) over one KV head kj (Sk, D), f32."""
    acc = _acc_dtype(qg)
    # out of place: under selective checkpointing the product's output
    # is kept and handed back in the recomputation
    s = torch.matmul(qg.to(acc), kj.to(acc).t()) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = t * softcap
    s.masked_fill_(~mask, NEG_INF)
    return s, t


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None, with_lse: bool = False):
    """Materialized-scores softmax attention with GQA, causal and
    sliding-window masks and logit soft-capping, in f32; out in q's
    dtype. q (B, H, Sq, D); k, v (B, Hkv, Sk, D); query head h reads KV
    head h // (H // Hkv). The scores are materialized for one batch row
    and one KV head's group of query heads at a time, so that the peak
    stays at (H // Hkv) * Sq * Sk floats. ``with_lse``: also the f32 row
    log-sum-exp of the masked scores (B, H, Sq), what the backward
    needs."""
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    mask = _attention_mask(Sq, Sk, causal, window, q.device)
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    acc = _acc_dtype(q)
    lse = torch.empty((B, H, Sq), dtype=acc, device=q.device) \
        if with_lse else None
    for b in range(B):
        for j in range(Hkv):
            hs = slice(j * group, (j + 1) * group)
            s, _ = _scores(q[b, hs], k[b, j], mask, scale, softcap)
            if with_lse:
                lse[b, hs] = torch.logsumexp(s, dim=-1)
            p = torch.softmax(s, dim=-1)
            del s
            out[b, hs] = torch.matmul(p, v[b, j].to(acc)).to(q.dtype)
    return (out, lse) if with_lse else out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None) -> tuple:
    """(dq, dk, dv) of ``attention_ref`` for the output's cotangent do,
    given its output o and row log-sum-exp lse, in f32, each in its
    input's dtype. Per unmasked pair, with s = scale q.k and
    S = c tanh(s / c) (S = s without a softcap c):
    P = exp(S - lse), D = rowsum(do * o), dP = do.v^T,
    dS = P (dP - D) (1 - (S / c)^2); dq = scale dS.k,
    dk = scale dS^T.q and dv = P^T.do, dk and dv summed over the query
    heads of a KV head's group."""
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    mask = _attention_mask(Sq, Sk, causal, window, q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    acc = _acc_dtype(q)
    delta = (do.to(acc) * o.to(acc)).sum(-1)             # (B, H, Sq)
    for b in range(B):
        for j in range(Hkv):
            hs = slice(j * group, (j + 1) * group)
            s, t = _scores(q[b, hs], k[b, j], mask, scale, softcap)
            p = torch.exp(s - lse[b, hs, :, None])
            del s
            dof = do[b, hs].to(acc)
            dp = torch.matmul(dof, v[b, j].to(acc).t())
            ds = p * (dp - delta[b, hs, :, None])
            del dp
            if t is not None:
                ds.mul_(1 - t * t)
            del t
            dq[b, hs] = (torch.matmul(ds, k[b, j].to(acc)) * scale).to(
                q.dtype)
            dk[b, j] = (torch.einsum("gqk,gqd->kd", ds, q[b, hs].to(acc))
                        * scale).to(k.dtype)
            dv[b, j] = torch.einsum("gqk,gqd->kd", p, dof).to(v.dtype)
    return dq, dk, dv


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The sequential RWKV-6 recurrence in f32, vectorized over B and H;
    out in r's dtype.

      r, k, w: (B, H, T, K)   v: (B, H, T, V)   u: (H, K)
      S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: K x V)
      o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)      (1 x V)
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    acc = _acc_dtype(r)
    rf, kf, vf, wf = (x.to(acc) for x in (r, k, v, w))
    S = torch.zeros((B, H, K, V), dtype=acc, device=r.device)
    out = torch.empty((B, H, T, V), dtype=acc, device=r.device)
    for t in range(T):        # o_t = r_t S_{t-1} + (r_t . (u k_t)) v_t
        out[:, :, t] = torch.matmul(rf[:, :, t, None, :], S)[:, :, 0]
        S = torch.addcmul(wf[:, :, t, :, None] * S, kf[:, :, t, :, None],
                          vf[:, :, t, None, :])
    bonus = (rf * u.to(acc)[None, :, None, :] * kf).sum(-1, keepdim=True)
    return out.addcmul_(bonus, vf).to(r.dtype)


W_FLOOR = 1e-12   # decays below it get no gradient (the reference's
#                   log(maximum(w, 1e-12)) in its chunked form)


def rwkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                  chunk: int = 64) -> tuple:
    """(dr, dk, dv, dw, du) of ``rwkv6_ref`` for the output's cotangent
    do, in f32 (f64 for f64 inputs); dr, dk, dv, dw in their inputs'
    dtype, du (H, K) in that arithmetic's.
    Backward through the recurrence with G_t = dL/dS_t, G_{T-1} = 0 and
    G_{t-1} = diag(w_t) G_t + r_t do_t^T:

      dr_t = S_{t-1} do_t + (u k_t)(v_t . do_t)
      dk_t = G_t v_t + (u r_t)(v_t . do_t)
      dv_t = G_t^T k_t + (r_t . (u k_t)) do_t
      dw_t = rowsum(G_t * S_{t-1}), 0 where w_t < W_FLOOR
      du   = sum over b and t of r_t k_t (v_t . do_t)

    The states S_{t-1} are needed in reverse: the states at every
    ``chunk``-th step are kept from a forward pass, and each chunk's are
    formed again from its first (w is never divided by)."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    acc = _acc_dtype(r)
    rf, kf, vf, wf, dof = (x.to(acc) for x in (r, k, v, w, do))
    uf = u.to(acc)
    starts = []
    S = torch.zeros((B, H, K, V), dtype=acc, device=r.device)
    for t in range(T):
        if t % chunk == 0:
            starts.append(S)
        S = torch.addcmul(wf[:, :, t, :, None] * S, kf[:, :, t, :, None],
                          vf[:, :, t, None, :])
    a = (vf * dof).sum(-1, keepdim=True)                 # v_t . do_t
    bonus = (rf * uf[None, :, None, :] * kf).sum(-1, keepdim=True)
    dr = uf[None, :, None, :] * kf * a
    dk = uf[None, :, None, :] * rf * a
    dv = bonus * dof
    dw = torch.zeros_like(wf)
    G = torch.zeros((B, H, K, V), dtype=acc, device=r.device)
    for c0 in reversed(range(0, T, chunk)):
        prev = [starts[c0 // chunk]]                      # S_{t-1}
        for t in range(c0, min(c0 + chunk, T) - 1):
            prev.append(torch.addcmul(wf[:, :, t, :, None] * prev[-1],
                                      kf[:, :, t, :, None],
                                      vf[:, :, t, None, :]))
        for t in reversed(range(c0, min(c0 + chunk, T))):
            Sp = prev.pop()
            dr[:, :, t] += torch.matmul(Sp, dof[:, :, t, :, None])[..., 0]
            dk[:, :, t] += torch.matmul(G, vf[:, :, t, :, None])[..., 0]
            dv[:, :, t] += torch.matmul(kf[:, :, t, None, :], G)[..., 0, :]
            dw[:, :, t] = (G * Sp).sum(-1)
            G = torch.addcmul(wf[:, :, t, :, None] * G, rf[:, :, t, :, None],
                              dof[:, :, t, None, :])
    dw = torch.where(wf < W_FLOOR, torch.zeros_like(dw), dw)
    du = (rf * kf * a).sum((0, 2))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du)
