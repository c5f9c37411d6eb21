"""Gradients of the port's LM on the CPU, held to the reference: the
backward formulas of ``FlashAttention`` and ``RWKV6`` (the plain
versions, ``ref.attention_bwd_ref`` and ``ref.rwkv6_bwd_ref``, through
the ``torch.autograd.Function``s) against ``jax.vjp`` of the reference's
``chunked_attention`` and ``rwkv6_chunked`` in f32, and against finite
differences (``torch.autograd.gradcheck``) in f64; the remat modes;
and ``chunked_xent``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch import configs as TC
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR_ref
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import train_loop as TLOOP

from _torch_train_parity import _batch, _two_torch_threads  # noqa: F401

# |port grad - reference grad| / max |reference grad|, per input: two f32
# evaluations of the same derivative whose sums run in other orders (the
# reference's online softmax over 16-key chunks and its chunked RWKV-6
# form, the port's materialized scores and sequential recurrence; 1.3e-6
# measured at most)
BWD_BOUND = 1e-5

ATTN_CASES = [
    # (B, H, Hkv, Sq, Sk, D, kwargs)
    (2, 4, 2, 37, 37, 16, dict(causal=True)),                    # GQA 2
    (1, 8, 2, 40, 40, 16, dict(causal=True, window=8,
                               softcap=5.0)),                   # GQA 4
    (2, 4, 4, 20, 33, 8, dict(causal=False)),     # cross: Sq != Sk
    (1, 2, 1, 30, 30, 8, dict(causal=False, window=6)),
    (1, 4, 2, 33, 33, 16, dict(causal=True, softcap=2.0)),
]


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_backward_matches_jax_vjp(case):
    B, H, Hkv, Sq, Sk, D, kw = case
    rng = np.random.RandomState(Sq + Sk)
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k, v = (rng.randn(B, Hkv, Sk, D).astype(np.float32) for _ in range(2))
    do = rng.randn(B, H, Sq, D).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: RL.chunked_attention(
        q, k, v, causal=kw["causal"], window=kw.get("window"),
        softcap=kw.get("softcap"), chunk=16), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    got_out = TK.flash_attention(*ts, **kw)
    assert got_out.grad_fn is not None and "FlashAttention" in \
        type(got_out.grad_fn).__name__
    assert _rel_err(got_out.detach(), out) <= BWD_BOUND
    got = torch.autograd.grad(got_out, ts, torch.tensor(do))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        assert _rel_err(g, w) <= BWD_BOUND, name


def _rwkv_inputs(rng, B, H, T, K, V):
    r, k = (rng.randn(B, H, T, K).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.randn(B, H, T, V).astype(np.float32)
    w = (0.2 + 0.79 * rng.rand(B, H, T, K)).astype(np.float32)
    u = (rng.randn(H, K) * 0.3).astype(np.float32)
    do = rng.randn(B, H, T, V).astype(np.float32)
    return r, k, v, w, u, do


def _rwkv_both(r, k, v, w, u, do, chunk):
    _, vjp = jax.vjp(lambda *a: RS.rwkv6_chunked(*a, chunk=chunk),
                     *map(jnp.asarray, (r, k, v, w, u)))
    want = vjp(jnp.asarray(do))
    ts = [torch.tensor(x, requires_grad=True) for x in (r, k, v, w, u)]
    out = TK.rwkv6_scan(*ts, chunk=chunk)
    got = torch.autograd.grad(out, ts, torch.tensor(do))
    return got, want


@pytest.mark.parametrize("shape", [(2, 2, 37, 8, 8, 16),     # a tail of 5
                                   (1, 3, 64, 16, 8, 64),    # one chunk
                                   (1, 2, 20, 4, 12, 64)])   # T < chunk
def test_rwkv6_backward_matches_jax_vjp(shape):
    B, H, T, K, V, chunk = shape
    rng = np.random.RandomState(T)
    got, want = _rwkv_both(*_rwkv_inputs(rng, B, H, T, K, V), chunk)
    for name, g, w in zip(("r", "k", "v", "w", "u"), got, want):
        assert _rel_err(g, w) <= BWD_BOUND, name


def test_rwkv6_decays_below_1e_12_get_no_gradient():
    """The reference takes log(maximum(w, 1e-12)): jax.grad gives such a
    decay 0, and so does the port (the model's decay reaches 1.8e-24).
    One such decay a chunk and channel: more of them overflow the
    reference's masked pairwise decays, whose gradient is then NaN."""
    rng = np.random.RandomState(5)
    r, k, v, w, u, do = _rwkv_inputs(rng, 1, 2, 40, 8, 4)
    tiny = [(5, 0, 1e-14), (20, 3, 1e-13), (33, 1, 5e-13)]
    for t, c, x in tiny:
        w[:, :, t, c] = x
    got, want = _rwkv_both(r, k, v, w, u, do, chunk=16)
    for name, g, wn in zip(("r", "k", "v", "w", "u"), got, want):
        assert _rel_err(g, wn) <= BWD_BOUND, name
    for t, c, _ in tiny:
        assert float(np.abs(np.asarray(want[3])[:, :, t, c]).max()) == 0.0
        assert float(got[3][:, :, t, c].abs().max()) == 0.0
    # and where w is 1e-12 or above, the gradient is not cut
    assert float(got[3].abs().min()) >= 0 and float(
        got[3][:, :, 6].abs().max()) > 0


def test_backward_formulas_pass_gradcheck_in_float64():
    torch.manual_seed(0)
    for B, H, Hkv, Sq, Sk, D, kw in [(1, 4, 2, 9, 9, 4, dict(
            causal=True, window=4, softcap=5.0)), (2, 2, 1, 5, 7, 4, dict(
                causal=False))]:
        ts = [torch.randn(B, h, s, D, dtype=torch.float64,
                          requires_grad=True)
              for h, s in ((H, Sq), (Hkv, Sk), (Hkv, Sk))]
        assert torch.autograd.gradcheck(
            lambda q, k, v: TK.FlashAttention.apply(
                q, k, v, kw["causal"], kw.get("window"), kw.get("softcap"),
                None), ts)
    for B, H, T, K, V, chunk in [(1, 2, 7, 3, 4, 3), (2, 1, 5, 2, 2, 64)]:
        r, k = (torch.randn(B, H, T, K, dtype=torch.float64,
                            requires_grad=True) for _ in range(2))
        w = (torch.rand(B, H, T, K, dtype=torch.float64) * 0.9
             + 0.05).requires_grad_(True)
        v = torch.randn(B, H, T, V, dtype=torch.float64, requires_grad=True)
        u = torch.randn(H, K, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda *a: TK.RWKV6.apply(*a, chunk), (r, k, v, w, u))


def test_rwkv6_bwd_ref_agrees_with_itself_across_chunks():
    """The plain backward keeps the states at every ``chunk``-th step and
    forms each chunk's again: the chunk changes no value but the order
    of nothing (the same sequential arithmetic)."""
    rng = np.random.RandomState(3)
    r, k, v, w, u, do = (torch.as_tensor(x) for x in
                         _rwkv_inputs(rng, 1, 2, 23, 4, 4))
    a = TR_ref.rwkv6_bwd_ref(r, k, v, w, u, do, chunk=5)
    b = TR_ref.rwkv6_bwd_ref(r, k, v, w, u, do, chunk=64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# remat and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2_27b", "rwkv6_7b",
                                  "jamba_v0_1_52b", "whisper_base"])
def test_remat_modes_change_no_value(arch):
    """``block`` and ``dots`` give the loss and every gradient bit for bit
    as ``none`` does (the recomputed forward is the same arithmetic)."""
    base = TC.get_smoke(arch).reduced(dtype="float32")
    params = TT.init_params(base, 0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(base).items()}
    out = {}
    for mode in ("none", "block", "dots"):
        cfg = base.reduced(remat=mode)
        out[mode] = TLOOP.value_and_grad(TLOOP.make_loss(cfg), params, batch)
    from repro_torch import tree as TR
    for mode in ("block", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(TR.leaves(out[mode][1]), TR.leaves(out["none"][1])):
            assert torch.equal(a, b), mode


def test_dots_remat_saves_the_products_and_recomputes_the_rest():
    """Under ``dots`` the x @ W products are not run again in the
    backward; under ``block`` they are."""
    base = TC.get_smoke("gemma2_27b").reduced(dtype="float32")
    params = TT.init_params(base, 0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(base).items()}
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for mode in ("none", "block", "dots"):
        with Count() as c:
            TLOOP.value_and_grad(TLOOP.make_loss(base.reduced(remat=mode)),
                                 params, batch)
        counts[mode] = c.mm
    assert counts["dots"] == counts["none"] < counts["block"], counts


@pytest.mark.parametrize("S,chunk,cap", [(16, 512, None), (37, 8, 30.0),
                                         (24, 8, None)])
def test_chunked_xent_matches_reference(S, chunk, cap):
    rng = np.random.RandomState(S)
    h = rng.randn(2, S, 12).astype(np.float32)
    emb = rng.randn(50, 12).astype(np.float32)
    labels = rng.randint(0, 50, (2, S)).astype(np.int32)
    labels[1, -5:] = -1
    want = RL.chunked_xent(jnp.asarray(h), jnp.asarray(emb),
                           jnp.asarray(labels), chunk=chunk,
                           final_softcap=cap)
    th, te = (torch.tensor(x, requires_grad=True) for x in (h, emb))
    got = TL.chunked_xent(th, te, torch.as_tensor(labels), chunk=chunk,
                          final_softcap=cap)
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    wg = jax.grad(lambda h, e: RL.chunked_xent(
        h, e, jnp.asarray(labels), chunk=chunk, final_softcap=cap),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    for g, w in zip(torch.autograd.grad(got, (th, te)), wg):
        assert _rel_err(g, w) <= BWD_BOUND
    # no label at all: 0 over a count of at least 1
    none = TL.chunked_xent(th, te, torch.full((2, S), -1), chunk=chunk)
    assert float(none.detach()) == 0.0
