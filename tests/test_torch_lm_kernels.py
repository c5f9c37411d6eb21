"""The LM kernels' plain PyTorch versions (``attention_ref``,
``rwkv6_ref``) against the reference's Pallas kernels in interpret mode
and its jnp oracles, at the tolerances of ``tests/test_kernels.py``; and
their dispatch. The CUDA kernels themselves are tested in
``test_torch_cuda.py``."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rwkv6_scan import rwkv6_pallas
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR
from repro_torch.kernels import rwkv6_scan as TRW

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


def _jnp(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# attention_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", chip_smoke.ATTN_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 2, 24, 16), (2, 4, 2, 33, 8)])
def test_attention_ref_matches_pallas(kwargs, dtype, shape):
    """tests/test_kernels.py::test_flash_attention_variants's grid, with
    its inputs and tolerances: the plain version against the Pallas
    kernel in interpret mode and the jnp oracle."""
    B, H, Hkv, S, D = shape
    rng = np.random.RandomState(0)
    q, k, v = (torch.as_tensor(rng.randn(B, h, S, D), dtype=dtype)
               for h in (H, Hkv, Hkv))
    got = _f32(TR.attention_ref(q, k, v, **kwargs))
    pallas = _f32(flash_attention_pallas(_jnp(q), _jnp(k), _jnp(v),
                                         block_q=16, block_k=16, **kwargs))
    oracle = _f32(R.attention_ref(_jnp(q), _jnp(k), _jnp(v), **kwargs))
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    np.testing.assert_allclose(got, pallas, atol=atol)
    np.testing.assert_allclose(got, oracle, atol=atol)
    # the dispatch takes the plain version for CPU tensors
    assert torch.equal(TK.flash_attention(q, k, v, **kwargs),
                       TR.attention_ref(q, k, v, **kwargs))


ATTN_EDGE = chip_smoke.attention_edge_cases(CPU)
RWKV_EDGE = chip_smoke.rwkv6_edge_cases(CPU, large=False)


@pytest.mark.parametrize("case", range(0, len(ATTN_EDGE), 3))
def test_attention_edge_cases_match_oracle(case):
    """Every third of chip_smoke.py's flash edge cases (the card holds the
    kernel to the plain version on the whole list: GQA, D up to 256,
    Sq != Sk, window 1) against the jnp oracle."""
    q, k, v, kw = ATTN_EDGE[case]
    got = _f32(TR.attention_ref(q, k, v, **kw))
    want = _f32(R.attention_ref(_jnp(q), _jnp(k), _jnp(v), **kw))
    atol = 2e-2 if q.dtype == torch.bfloat16 else 2e-3
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("case", range(0, len(RWKV_EDGE), 4))
def test_rwkv6_edge_cases_match_oracle(case):
    """Every fourth of chip_smoke.py's small rwkv6 edge cases against the
    jnp oracle."""
    r, k, v, w, u, _ = RWKV_EDGE[case]
    got = _f32(TR.rwkv6_ref(r, k, v, w, u))
    want = _f32(R.rwkv6_ref(*(_jnp(x) for x in (r, k, v, w, u))))
    tol = dict(atol=2e-2, rtol=2e-2) if r.dtype == torch.bfloat16 \
        else dict(atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got, want, **tol)


def test_attention_ref_gqa_and_unequal_lengths():
    """Query head h reads KV head h // (H // Hkv); Sq != Sk."""
    rng = np.random.RandomState(3)
    q = torch.as_tensor(rng.randn(2, 6, 9, 8), dtype=torch.float32)
    k = torch.as_tensor(rng.randn(2, 3, 13, 8), dtype=torch.float32)
    v = torch.as_tensor(rng.randn(2, 3, 13, 8), dtype=torch.float32)
    for kw in (dict(causal=True), dict(causal=False, window=6)):
        got = _f32(TR.attention_ref(q, k, v, **kw))
        want = _f32(R.attention_ref(_jnp(q), _jnp(k), _jnp(v), **kw))
        np.testing.assert_allclose(got, want, atol=2e-6)
        # head 5 is head 2 of the KV heads' repeat
        one = TR.attention_ref(q[:, 5:6], k[:, 2:3], v[:, 2:3], **kw)
        assert torch.equal(TR.attention_ref(q, k, v, **kw)[:, 5:6], one)


# ---------------------------------------------------------------------------
# the tensor-core kernel's error model
# ---------------------------------------------------------------------------

def split_p_attention(q, k, v, causal=True, window=None, softcap=None,
                      scale=None, terms=2) -> torch.Tensor:
    """``attention_ref``'s arithmetic in f32 with P.V as the tensor-core
    kernel does it: P (f32) split into hi = bf16(P) and lo = bf16(P -
    hi), (hi.V + lo.V) / l with the row sums l from the f32 P (``terms``
    = 1: hi alone). Q.K^T of bf16 inputs is the same f32 product as in
    ``attention_ref`` (every bf16 x bf16 product is exact in f32). Out
    in f32."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    vf = v.float().repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq)[:, None]
    cols = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float() if terms == 2 else torch.zeros_like(p)
    return (torch.matmul(hi, vf) + torch.matmul(lo, vf)) / p.sum(-1, True)


TC_EDGE = [c for c in ATTN_EDGE
           if TFA.kernel_path(c[0].dtype, c[0].shape[-1]) == "tensor_cores"]


@pytest.mark.parametrize("case", range(0, len(TC_EDGE), 2))
def test_split_p_within_a_quarter_of_the_bound(case):
    """Every second of chip_smoke.py's flash edge cases that the tensor
    cores take: their arithmetic (bf16-exact Q.K^T, P.V as hi.V + lo.V)
    stays within a quarter of ``chip_smoke.attention_bound`` of the plain
    version's f32 result, so that the kernel keeps the f32 contract with
    room for its own summation order."""
    q, k, v, kw = TC_EDGE[case]
    want = TR.attention_ref(q.float(), k.float(), v.float(), **kw)
    got = split_p_attention(q, k, v, **kw)
    bound = chip_smoke.attention_bound(q, k, v, kw.get("scale"))
    err = float((got.double() - want.double()).abs().max())
    assert err <= bound / 4, (err, bound)


def test_one_bf16_rounding_of_p_breaks_the_bound():
    """The control: P.V with hi alone (P rounded once to bf16) leaves the
    bound on half of the cases at the default scale (the cases with
    scale 1 have scores, and so a bound, large enough to hide it)."""
    cases = [c for c in TC_EDGE if "scale" not in c[3]][::4]
    over = 0
    for q, k, v, kw in cases:
        want = TR.attention_ref(q.float(), k.float(), v.float(), **kw)
        got = split_p_attention(q, k, v, terms=1, **kw)
        bound = chip_smoke.attention_bound(q, k, v, kw.get("scale"))
        over += float((got.double() - want.double()).abs().max()) > bound
    assert over >= len(cases) // 2, (over, len(cases))


def test_kernel_path_rule():
    """bf16 with D a multiple of 16 takes the tensor cores; f32 and bf16
    with any other D the CUDA cores."""
    assert TFA.kernel_path(torch.bfloat16, 128) == "tensor_cores"
    assert TFA.kernel_path(torch.bfloat16, 16) == "tensor_cores"
    assert TFA.kernel_path(torch.bfloat16, 256) == "tensor_cores"
    for dtype, D in ((torch.float32, 128), (torch.float32, 16),
                     (torch.bfloat16, 8), (torch.bfloat16, 24),
                     (torch.bfloat16, 100)):
        assert TFA.kernel_path(dtype, D) == "cuda_cores", (dtype, D)
    kinds = {TFA.kernel_path(q.dtype, q.shape[-1]) for q, *_ in ATTN_EDGE}
    assert kinds == {"tensor_cores", "cuda_cores"}


# ---------------------------------------------------------------------------
# the rwkv6 kernel's error model
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _split_mm(a, b, rounding="tf32", terms=2, b_exact=False):
    """a @ b as the kernel's tensor cores take it: each f32 operand
    split into ``terms`` parts (x = hi + lo + ..., each part rounded to
    ``rounding``), the products of parts whose orders sum below
    ``terms`` accumulated in f32; ``b_exact``: b is exact in the format
    (bf16 v in TF32) and is not split."""
    rnd = _tf32 if rounding == "tf32" else (lambda x: x.bfloat16().float())

    def parts(x):
        out, rest = [], x
        for _ in range(terms):
            out.append(rnd(rest))
            rest = rest - out[-1]
        return out

    out = 0
    for i, x in enumerate(parts(a)):
        for j, y in enumerate([b] if b_exact else parts(b)):
            if i + j < terms:
                out = out + x @ y
    return out


def subchunk_rwkv6(r, k, v, w, u, chunk=64, rounding="tf32", terms=2,
                   one_reference=False):
    """The RWKV-6 kernel's arithmetic in torch, f32 out: chunks of
    ``chunk`` steps padded to multiples of 16 (w = 1, r = k = v = 0),
    log2-decays and their cumulative sums; A's blocks below the diagonal
    as split products of r and k scaled at the end b of the source's
    16-step sub-chunk (2^(cwe[t] - b) and 2^(b - cwi[i]), both <= 1),
    its diagonal blocks by a power of 2 per pair and channel with the u
    bonus on the diagonal; o = A v + (r 2^cwe) S and S <- diag(2^cwi[-1])
    S + (k 2^(cwi[-1] - cwi))^T v as split products. ``one_reference``:
    every pair of a chunk factored at the chunk's end instead, the
    diagonal blocks too (the control: 2^(cwe[t] - b) then exceeds 1)."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    v_exact = v.dtype == torch.bfloat16 and rounding == "tf32"
    C = min(chunk, T)
    CP = -(-C // 16) * 16
    S = torch.zeros(B, H, K, V)
    out = torch.empty(B, H, T, V)
    uf = u.float()[None, :, None, :]
    for c0 in range(0, T, C):
        n = min(C, T - c0)

        def pad(x, fill=0.0):
            p = torch.full((B, H, CP, x.shape[-1]), fill)
            p[:, :, :n] = x[:, :, c0:c0 + n]
            return p

        rc, kc, vc = pad(rf), pad(kf), pad(vf)
        cwi = torch.cumsum(torch.log2(pad(wf, 1.0).clamp(min=1e-12)), dim=2)
        cwe = torch.cat([torch.zeros(B, H, 1, K), cwi[:, :, :-1]], dim=2)
        bonus = torch.diag_embed((rc * uf * kc).sum(-1))
        if one_reference:
            end = cwi[:, :, -1:]
            A = bonus + torch.tril(_split_mm(
                rc * torch.exp2(cwe - end), (kc * torch.exp2(end - cwi)).mT,
                rounding, terms), -1)
        else:
            A = torch.zeros(B, H, CP, CP)
            for b in range(CP // 16):
                for a in range(b):
                    end = cwi[:, :, 16 * a + 15:16 * a + 16]
                    q = rc[:, :, 16 * b:16 * b + 16] * torch.exp2(
                        cwe[:, :, 16 * b:16 * b + 16] - end)
                    kt = kc[:, :, 16 * a:16 * a + 16] * torch.exp2(
                        end - cwi[:, :, 16 * a:16 * a + 16])
                    A[:, :, 16 * b:16 * b + 16, 16 * a:16 * a + 16] = \
                        _split_mm(q, kt.mT, rounding, terms)
            for b in range(CP // 16):
                sl = slice(16 * b, 16 * b + 16)
                e = torch.exp2(cwe[:, :, sl, None, :]
                               - cwi[:, :, None, sl, :])
                d = (rc[:, :, sl, None, :] * kc[:, :, None, sl, :] * e)
                A[:, :, sl, sl] = torch.tril(d.sum(-1), -1) \
                    + bonus[:, :, sl, sl]
        o = _split_mm(A, vc, rounding, terms, v_exact) \
            + _split_mm(rc * torch.exp2(cwe), S, rounding, terms)
        out[:, :, c0:c0 + n] = o[:, :, :n]
        last = cwi[:, :, -1]
        kt = kc * torch.exp2(last[:, :, None, :] - cwi)
        S = torch.exp2(last)[..., None] * S + _split_mm(
            kt.mT, vc, rounding, terms, v_exact)
    return out


RWKV_ALL = chip_smoke.rwkv6_edge_cases(CPU)


def _share_of_bound(got, case) -> float:
    r, k, v, w, u, chunk = case
    want = TR.rwkv6_ref(r.float(), k.float(), v.float(), w.float(), u)
    bound = chip_smoke.rwkv6_bound(r, k, v, w, u, chunk)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got.double() - want.double()).abs()
                  / bound.clamp(min=1e-300)).max())


@pytest.mark.parametrize("case", range(len(RWKV_ALL)))
def test_subchunk_tf32_within_a_quarter_of_the_bound(case):
    """Every chip_smoke.py rwkv6 edge case (decays near 0 and near 1,
    K != V, K = V = 128, T not a multiple of 16 or of the chunk, f32 and
    bf16): the kernel's arithmetic (``subchunk_rwkv6``: TF32 hi + lo
    splits, sub-chunk factoring, diagonal blocks per pair) stays within
    a quarter of ``chip_smoke.rwkv6_bound`` of the plain version's f32
    result, so that the kernel keeps the f32 contract with room for its
    own summation order."""
    r, k, v, w, u, chunk = RWKV_ALL[case]
    got = subchunk_rwkv6(r, k, v, w, u, chunk)
    assert _share_of_bound(got, RWKV_ALL[case]) <= 0.25


NEAR0 = [c for c in RWKV_ALL if float(c[3].float().max()) < 1e-2]


def test_one_rounding_or_one_reference_point_breaks_the_bound():
    """The controls. On the cases with decays near 0 (down to 1e-9 a
    step, 2^-30), one reference point per chunk (at its end) overflows to
    a non-finite result wherever the chunk spans more than 4 steps, and
    each case gives a non-finite or out-of-bound result under one of the
    two controls. One bf16 rounding per operand leaves the bound on at
    least half of every second edge case (not where a long chunk's sum of
    |log w| makes the bound loose)."""
    assert len(NEAR0) >= 10
    for case in NEAR0:
        r, k, v, w, u, chunk = case
        one_ref = subchunk_rwkv6(r, k, v, w, u, chunk, one_reference=True)
        finite = bool(torch.isfinite(one_ref).all())
        assert not finite or min(chunk, r.shape[2]) <= 4, r.shape
        once = subchunk_rwkv6(r, k, v, w, u, chunk, rounding="bf16",
                              terms=1)
        assert not finite or _share_of_bound(once, case) > 1.0, r.shape
    cases = RWKV_ALL[::2]
    over = sum(_share_of_bound(subchunk_rwkv6(
        *c[:5], c[5], rounding="bf16", terms=1), c) > 1.0 for c in cases)
    assert over >= len(cases) // 2, (over, len(cases))


# ---------------------------------------------------------------------------
# rwkv6_ref
# ---------------------------------------------------------------------------

def _rwkv_inputs(seed, B, H, T, K, V, decay="mid", dtype=torch.float32):
    rng = np.random.RandomState(seed)
    r = rng.randn(B, H, T, K) * 0.5
    k = rng.randn(B, H, T, K) * 0.5
    v = rng.randn(B, H, T, V)
    w = {"mid": 0.2 + 0.79 * rng.rand(B, H, T, K),
         "near0": 10.0 ** rng.uniform(-9, -3, (B, H, T, K)),
         "near1": 1.0 - 10.0 ** rng.uniform(-6, -3, (B, H, T, K))}[decay]
    u = rng.randn(H, K) * 0.3
    t = [torch.as_tensor(a, dtype=dtype) for a in (r, k, v, w)]
    return t + [torch.as_tensor(u, dtype=torch.float32)]


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("T,B,seed", [(4, 1, 0), (23, 2, 1), (40, 1, 2)])
def test_rwkv6_ref_matches_pallas(chunk, T, B, seed):
    """tests/test_kernels.py::test_rwkv6_hypothesis's inputs and
    tolerances (atol 2e-3, rtol 1e-3): the plain version against the
    Pallas kernel in interpret mode and the jnp oracle."""
    r, k, v, w, u = _rwkv_inputs(seed, B, 2, T, 8, 8)
    got = _f32(TR.rwkv6_ref(r, k, v, w, u))
    pallas = _f32(rwkv6_pallas(*(_jnp(x) for x in (r, k, v, w, u)),
                               chunk=chunk))
    oracle = _f32(R.rwkv6_ref(*(_jnp(x) for x in (r, k, v, w, u))))
    np.testing.assert_allclose(got, pallas, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got, oracle, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("decay", ["near0", "near1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_ref_extreme_decays_and_k_ne_v(decay, dtype):
    """Decays near 0 and near 1, K != V, T not a multiple of the chunk:
    the plain version against the Pallas kernel (chunk 16) and the
    oracle; in bf16 the output rounds to bf16 in every version."""
    r, k, v, w, u = _rwkv_inputs(5, 1, 2, 37, 8, 12, decay, dtype)
    got = _f32(TR.rwkv6_ref(r, k, v, w, u))
    pallas = _f32(rwkv6_pallas(*(_jnp(x) for x in (r, k, v, w, u)),
                               chunk=16))
    oracle = _f32(R.rwkv6_ref(*(_jnp(x) for x in (r, k, v, w, u))))
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got, pallas, **tol)
    np.testing.assert_allclose(got, oracle, **tol)


def test_rwkv6_dispatch_takes_the_plain_version_and_counts_nothing():
    TK.reset_launch_counts()
    r, k, v, w, u = _rwkv_inputs(7, 1, 2, 20, 8, 8)
    assert torch.equal(TK.rwkv6_scan(r, k, v, w, u, chunk=8),
                       TR.rwkv6_ref(r, k, v, w, u))
    q = torch.zeros(1, 2, 5, 8)
    TK.flash_attention(q, q, q)
    counts = TK.launch_counts()
    assert counts["rwkv6"] == 0 and counts["flash_attention"] == 0, counts


# ---------------------------------------------------------------------------
# the wrappers' checks (before anything is built or launched)
# ---------------------------------------------------------------------------

def test_flash_attention_refuses_rows_without_keys():
    """The kernel skips the key tiles the masks hide, which is exact only
    while every row keeps an unmasked key: both routes refuse the rest,
    so that the answer does not depend on the device."""
    q = torch.zeros(1, 1, 10, 8)
    k = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="no key in their window"):
        TK.flash_attention(q, k, k, causal=True, window=3)
    with pytest.raises(ValueError, match="masks every key"):
        TK.flash_attention(q, q, q, causal=True, window=0)
    TFA.check_masks(10, 4, True, 7)           # the last row keeps key 3
    TFA.check_masks(10, 4, True, None)


def test_cuda_wrappers_refuse_cpu_and_bad_inputs():
    q = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError, match="cpu"):
        TFA.flash_attention_cuda(q, q, q)
    r = torch.zeros(1, 2, 5, 8)
    u = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="cpu"):
        TRW.rwkv6_cuda(r, r, r, r, u)
    # the meta device (the dry-run's) takes the plain versions: outputs
    # of the right shape, no data
    meta = torch.zeros(1, 2, 5, 8, device="meta")
    for out in (TK.flash_attention(meta, meta, meta),
                TK.rwkv6_scan(meta, meta, meta, meta,
                              torch.zeros(2, 8, device="meta"))):
        assert out.device.type == "meta" and out.shape == meta.shape
