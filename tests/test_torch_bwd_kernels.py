"""CPU models of the backward kernels' arithmetic (``csrc/
flash_attention_bwd_tc.cu``'s tensor-core path, ``csrc/rwkv6_bwd.cu``'s
chunk-parallel stages), each held to ``kernels/ref.py``'s plain backward
within a quarter of the bound ``chip_smoke.py`` holds the kernels to on
the card, and each with controls that the bound catches. The kernels
themselves run in ``test_torch_cuda.py``."""

import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ref as TR

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


def _share(got: tuple, want: tuple, tols: tuple) -> float:
    """The largest |got - want| as a share of its elementwise bound."""
    worst = 0.0
    for x, y, t in zip(got, want, tols):
        if not bool(torch.isfinite(x).all()):
            return float("inf")
        err = (x.double() - y.double()).abs()
        worst = max(worst, float((err / t.double().clamp(min=1e-300)).max()))
    return worst


# ---------------------------------------------------------------------------
# flash_attention's backward on the tensor cores
# ---------------------------------------------------------------------------

def _bf16_parts(x: torch.Tensor, terms: int) -> tuple:
    hi = x.bfloat16().float()
    lo = (x - hi).bfloat16().float() if terms == 2 else torch.zeros_like(x)
    return hi, lo


def split_bwd_attention(q, k, v, o, lse, do, causal=True, window=None,
                        softcap=None, scale=None, ds_terms=2) -> tuple:
    """``attention_bwd_ref``'s arithmetic in f32 with the products as the
    tensor-core kernels take them: S and dP from the bf16 inputs (exact
    products, f32 sums), P = exp(S - lse) and dS in f32, then dv = P^T.dO,
    dq = scale dS.K and dk = scale dS^T.Q with P and dS each as hi =
    bf16(x) and lo = bf16(x - hi), hi.B + lo.B (``ds_terms`` = 1: dS
    rounded to bf16 once, the control). dk and dv summed over the GQA
    group. Out in f32."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kr, vr = (x.float().repeat_interleave(G, dim=1) for x in (k, v))
    s = torch.matmul(qf, kr.transpose(-1, -2)) * scale
    fac = 1.0
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        fac = 1 - t * t
    rows = torch.arange(Sq)[:, None]
    cols = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vr.transpose(-1, -2)) - delta) * fac
    ph, pl = _bf16_parts(p, 2)
    dh, dl = _bf16_parts(ds, ds_terms)
    dq = (torch.matmul(dh, kr) + torch.matmul(dl, kr)) * scale
    dk = (torch.matmul(dh.transpose(-1, -2), qf)
          + torch.matmul(dl.transpose(-1, -2), qf)) * scale
    dv = torch.matmul(ph.transpose(-1, -2), dof) \
        + torch.matmul(pl.transpose(-1, -2), dof)
    dk = dk.view(B, Hkv, G, Sk, D).sum(2)
    dv = dv.view(B, Hkv, G, Sk, D).sum(2)
    return dq, dk, dv


# test_torch_cuda.py's BWD_ATTN_SHAPES that the tensor cores take, the
# two Whisper calls (448 and 1500 rows over 1500 keys, 8 heads) cut to
# a quarter of their rows, keys and heads for the CPU
TC_BWD_SHAPES = [
    # (B, H, Hkv, Sq, Sk, D, kwargs)
    (1, 4, 2, 63, 63, 16, dict(causal=True)),
    (2, 4, 2, 130, 130, 64, dict(causal=True, window=40, softcap=20.0)),
    (1, 8, 2, 129, 129, 128, dict(causal=True, softcap=50.0)),
    (1, 4, 4, 70, 200, 64, dict(causal=False)),
    (2, 2, 2, 112, 375, 64, dict(causal=False)),     # Whisper's cross
    (1, 2, 2, 375, 375, 64, dict(causal=False)),     # Whisper's encoder
    (1, 14, 2, 200, 200, 64, dict(causal=True, softcap=30.0)),  # group 7
    (1, 2, 1, 64, 64, 64, dict(causal=True)),        # one 64-row tile
]


def _attention_case(i):
    B, H, Hkv, Sq, Sk, D, kw = TC_BWD_SHAPES[i]
    rng = np.random.RandomState(i)
    q, k, v = (torch.as_tensor(rng.randn(B, h, s, D), dtype=torch.bfloat16)
               for h, s in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
    do = torch.as_tensor(rng.randn(B, H, Sq, D) * 0.1, dtype=torch.bfloat16)
    o, lse = TR.attention_ref(q, k, v, with_lse=True, **kw)
    want = TR.attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                lse, do.float(), **kw)
    tols = chip_smoke.attention_bwd_bound(q, k, v, o, lse, do, **kw)
    return (q, k, v, o, lse, do), kw, want, tols


def test_bwd_kernel_path_rule():
    """bf16 with D a multiple of 16 up to 128 takes the tensor cores;
    f32, bf16 with any other D, and D = 256 the CUDA cores. Every
    TC_BWD_SHAPES case takes the tensor cores."""
    for D in (16, 64, 80, 128):
        assert TFA.bwd_kernel_path(torch.bfloat16, D) == "tensor_cores", D
    for dtype, D in ((torch.float32, 64), (torch.float32, 128),
                     (torch.bfloat16, 24), (torch.bfloat16, 100),
                     (torch.bfloat16, 256), (torch.bfloat16, 8)):
        assert TFA.bwd_kernel_path(dtype, D) == "cuda_cores", (dtype, D)
    assert {TFA.bwd_kernel_path(torch.bfloat16, s[5])
            for s in TC_BWD_SHAPES} == {"tensor_cores"}


def test_split_terms_enter_the_bound_on_the_tensor_core_path_only():
    """``attention_bwd_bound`` adds the two-term split's 2^-16 terms where
    the call takes the tensor cores, and nothing in f32."""
    args, kw, _, tols = _attention_case(0)
    f32 = tuple(a.float() for a in args)
    base = chip_smoke.attention_bwd_bound(*f32, **kw)
    for tc, f in zip(tols, base):
        assert bool((tc >= f).all()) and bool((tc > f).any())


@pytest.mark.parametrize("case", range(len(TC_BWD_SHAPES)))
def test_split_p_and_ds_within_a_quarter_of_the_bound(case):
    """The tensor-core kernels' arithmetic (bf16-exact S and dP, P and dS
    as two bf16 terms in the products) stays within a quarter of
    ``chip_smoke.attention_bwd_bound`` of the plain backward's f32
    result, so that the kernels keep the contract with room for their
    own summation order."""
    args, kw, want, tols = _attention_case(case)
    got = split_bwd_attention(*args, **kw)
    assert _share(got, want, tols) <= 0.25


@pytest.mark.parametrize("case", range(len(TC_BWD_SHAPES)))
def test_one_bf16_rounding_of_ds_breaks_the_bound(case):
    """The control: dS rounded to bf16 once (P still in two terms) lies
    beyond the bound."""
    args, kw, want, tols = _attention_case(case)
    got = split_bwd_attention(*args, ds_terms=1, **kw)
    assert _share(got, want, tols) > 1.0


# ---------------------------------------------------------------------------
# rwkv6's backward, parallel over chunks
# ---------------------------------------------------------------------------

def staged_rwkv6_bwd(r, k, v, w, u, do, chunk=64, carry_g=True,
                     dw_identity=False) -> tuple:
    """The chunk-parallel kernels' arithmetic in f32: chunks of C =
    min(chunk, T, 64) steps; (a, b) each chunk's L = sum_i (k_i prod_{s>i}
    w_s) v_i^T (S from 0 over it), M = sum_i (r_i prod_{s<i} w_s) do_i^T
    (G from 0 back over it) and D (the product of its decays), the
    products of w taken in sequence; the carry S_start <- D S_start + L forward and
    G_end <- D G_end + M backward; (c) each chunk's walks from its S_start
    (dr = S_{t-1} do_t) and G_end (dk = G_t v_t, dv = G_t^T k_t, dw =
    rowsum(G_t * S_{t-1})), the bonus terms and the du partials per chunk.
    Controls: ``carry_g`` False takes every G_end as 0 (G not carried
    across chunks); ``dw_identity`` takes dw from the cumulative-sum
    identity instead, d(log w)_j = sum_{t>j} r_t dr_t - sum_{i>=j} k_i
    dk_i + rowsum(G_end * S_end) over the chunk (dr, dk without their
    bonus terms), divided by w. Out in f32 (du as the kernel's caller
    sums it); f64 inputs run in f64."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf, dof = (x.to(acc) for x in (r, k, v, w, do))
    uf = u.to(acc)[None, :, None, :]
    C = min(chunk, T, 64)
    starts = list(range(0, T, C))
    zero = torch.zeros(B, H, K, V, dtype=acc)
    L, M, Dn = [], [], []
    for t0 in starts:
        t1 = min(t0 + C, T)
        s, g = zero, zero
        kt, rt = kf[:, :, t0:t1].clone(), rf[:, :, t0:t1].clone()
        p = torch.ones(B, H, K, dtype=acc)
        for i in reversed(range(t1 - t0)):      # k_i prod_{s>i} w_s
            kt[:, :, i] = kt[:, :, i] * p
            p = p * wf[:, :, t0 + i]
        d, p = p, torch.ones(B, H, K, dtype=acc)
        for i in range(t1 - t0):                # r_i prod_{s<i} w_s
            rt[:, :, i] = rt[:, :, i] * p
            p = p * wf[:, :, t0 + i]
        for i in range(t1 - t0):
            s = torch.addcmul(s, kt[:, :, i, :, None], vf[:, :, t0 + i, None, :])
            g = torch.addcmul(g, rt[:, :, i, :, None],
                              dof[:, :, t0 + i, None, :])
        L.append(s)
        M.append(g)
        Dn.append(d)
    s_start, g_end = [], [None] * len(starts)
    s = zero
    for n in range(len(starts)):
        s_start.append(s)
        s = Dn[n][..., None] * s + L[n]
    g = zero
    for n in reversed(range(len(starts))):
        g_end[n] = g if carry_g else zero
        g = Dn[n][..., None] * g + M[n]
    a = (vf * dof).sum(-1, keepdim=True)
    dr, dk, dv, dw = (torch.zeros_like(x) for x in (rf, kf, vf, wf))
    du = torch.zeros(H, K, dtype=acc)
    for n, t0 in enumerate(starts):
        t1 = min(t0 + C, T)
        s, prev = s_start[n], []
        for t in range(t0, t1):
            prev.append(s)
            dr[:, :, t] = torch.matmul(s, dof[:, :, t, :, None])[..., 0]
            s = torch.addcmul(wf[:, :, t, :, None] * s, kf[:, :, t, :, None],
                              vf[:, :, t, None, :])
        s_end = s
        g = g_end[n]
        for t in reversed(range(t0, t1)):
            dk[:, :, t] = torch.matmul(g, vf[:, :, t, :, None])[..., 0]
            dv[:, :, t] = torch.matmul(kf[:, :, t, None, :], g)[..., 0, :]
            dw[:, :, t] = (g * prev[t - t0]).sum(-1)
            g = torch.addcmul(wf[:, :, t, :, None] * g, rf[:, :, t, :, None],
                              dof[:, :, t, None, :])
        if dw_identity:
            sl = slice(t0, t1)
            rd = rf[:, :, sl] * dr[:, :, sl]
            kd = kf[:, :, sl] * dk[:, :, sl]
            after = torch.flip(torch.cumsum(torch.flip(rd, [2]), 2), [2]) - rd
            from_j = torch.flip(torch.cumsum(torch.flip(kd, [2]), 2), [2])
            const = (g_end[n] * s_end).sum(-1)[:, :, None]
            dw[:, :, sl] = (after - from_j + const) / wf[:, :, sl].clamp(
                min=TR.W_FLOOR)
        du = du + (rf[:, :, t0:t1] * kf[:, :, t0:t1] * a[:, :, t0:t1]).sum(2
                                                                          ).sum(0)
    dr = dr + uf * kf * a
    dk = dk + uf * rf * a
    dv = dv + (rf * uf * kf).sum(-1, keepdim=True) * dof
    dw = torch.where(wf < TR.W_FLOOR, torch.zeros_like(dw), dw)
    return dr, dk, dv, dw, du


def _rwkv_case(seed, B, H, T, K, V, decays, dtype=torch.float32):
    """Inputs as the card tests draw them; ``decays``: "mid" (w in [0.2,
    0.99]), "near1" (w in [0.9, 0.99]), "small" (channels of w at 1e-2,
    1e-4 and 1e-9 beside mid ones), "cut" (mid, one in seven steps of
    every third channel at 1e-14, below the 1e-12 clamp)."""
    rng = np.random.RandomState(seed)
    r = rng.randn(B, H, T, K) * 0.5
    k = rng.randn(B, H, T, K) * 0.5
    w = 0.2 + 0.79 * rng.rand(B, H, T, K)
    if decays == "near1":
        w = 0.9 + 0.09 * rng.rand(B, H, T, K)
    elif decays == "small":
        w[..., 1::4] = 1e-2
        w[..., 2::4] = 1e-4
        w[..., 3::4] = 1e-9
    elif decays == "cut":
        w[:, :, ::7, ::3] = 1e-14
    v = rng.randn(B, H, T, V)
    u = rng.randn(H, K) * 0.3
    do = rng.randn(B, H, T, V) * 0.1
    t = [torch.as_tensor(x, dtype=dtype) for x in (r, k, v, w)]
    return t + [torch.as_tensor(u, dtype=torch.float32),
                torch.as_tensor(do, dtype=dtype)]


RWKV_BWD_CASES = [
    # (seed, B, H, T, K, V, decays, chunk, dtype)
    (0, 1, 2, 130, 16, 16, "mid", 64, torch.float32),
    (1, 2, 2, 100, 16, 12, "near1", 32, torch.float32),
    (2, 1, 2, 150, 16, 16, "small", 64, torch.float32),
    (3, 1, 2, 77, 12, 20, "small", 16, torch.float32),
    (4, 1, 2, 140, 16, 16, "cut", 64, torch.float32),
    (5, 2, 1, 96, 8, 24, "small", 32, torch.bfloat16),
    (6, 1, 2, 21, 12, 20, "mid", 16, torch.bfloat16),
    (7, 1, 1, 200, 32, 8, "near1", 64, torch.float32),
]


def _rwkv_bwd(case):
    seed, B, H, T, K, V, decays, chunk, dtype = RWKV_BWD_CASES[case]
    args = _rwkv_case(seed, B, H, T, K, V, decays, dtype)
    want = TR.rwkv6_bwd_ref(*(a.float() for a in args), chunk)
    tols = chip_smoke.rwkv6_bwd_bound(*args, chunk)
    return args, chunk, want, tols


@pytest.mark.parametrize("case", range(len(RWKV_BWD_CASES)))
def test_staged_rwkv6_bwd_within_a_quarter_of_the_bound(case):
    """The chunk-parallel kernels' arithmetic (``staged_rwkv6_bwd``) at
    decays from 0.99 down to 1e-9, 1e-14 cut, K != V, T not a multiple
    of the chunk, f32 and bf16 inputs: every gradient within a quarter of
    ``chip_smoke.rwkv6_bwd_bound`` of the plain backward, dw 0 exactly
    where w < 1e-12 and at the last step (G = 0 there)."""
    args, chunk, want, tols = _rwkv_bwd(case)
    got = staged_rwkv6_bwd(*args, chunk)
    assert _share(got, want, tols) <= 0.25
    w = args[3].float()
    assert bool((got[3][w < TR.W_FLOOR] == 0).all())
    assert bool((got[3][:, :, -1] == 0).all())
    assert bool((want[3][:, :, -1] == 0).all())


def test_staged_rwkv6_bwd_matches_the_plain_one_in_float64():
    """In float64 the stages give the plain backward's gradients (the
    arithmetic is the same function, only its order differs)."""
    args = _rwkv_case(9, 1, 2, 90, 8, 8, "small", torch.float64)
    got = staged_rwkv6_bwd(*args, 32)
    want = TR.rwkv6_bwd_ref(*args, 32)
    for x, y in zip(got, want):
        assert float((x.double() - y.double()).abs().max()) <= 1e-5 * max(
            float(y.abs().max()), 1e-30)


def test_g_not_carried_across_chunks_breaks_the_bound():
    """The control: every chunk's G_end taken as 0 lies beyond the bound
    wherever there is more than one chunk."""
    for case in (0, 1, 3):
        args, chunk, want, tols = _rwkv_bwd(case)
        got = staged_rwkv6_bwd(*args, chunk, carry_g=False)
        assert _share(got, want, tols) > 1.0, case


def test_dw_from_the_cumulative_sum_identity_breaks_the_bound():
    """The control: dw from the cumulative-sum identity (differences of
    sums over the chunk, divided by w) lies beyond the bound at the
    channels whose decays are 1e-4, counting only entries with a
    non-zero bound, and leaves non-zero dw at the first step, where the
    plain version's is exactly 0 (S_{-1} = 0); in float64 the identity
    holds."""
    args, chunk, want, tols = _rwkv_bwd(2)
    got = staged_rwkv6_bwd(*args, chunk, dw_identity=True)
    w, tol = args[3].float(), tols[3].double()
    at = (w == w[..., 2:3]) & (tol > 0)           # the 1e-4 channels
    assert float(w[..., 2].max()) < 2e-4 and bool(at.any())
    err = (got[3].double() - want[3].double()).abs()
    assert float((err[at] / tol[at]).max()) > 1.0
    assert bool((want[3][:, :, 0] == 0).all())
    assert float(got[3][:, :, 0].abs().max()) > 0
    a64 = [x.double() if x.is_floating_point() else x for x in args]
    exact = staged_rwkv6_bwd(*a64, chunk, dw_identity=True)
    ref64 = TR.rwkv6_bwd_ref(*a64, chunk)
    assert float((exact[3].double() - ref64[3]).abs().max()) <= 1e-6 * float(
        ref64[3].abs().max())
