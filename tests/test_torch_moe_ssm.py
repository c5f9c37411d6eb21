"""The port's MoE layer and Mamba mixer against the reference on the CPU:
``moe_apply`` (outputs and both metrics, with the skew-aware heavy path
on and off, ties among router probabilities, tokens dropped at
capacity), the MoE feed-forward with Arctic's dense residual,
``mamba_mixer`` in prefill and decode with its states, the per-op
rounding that bf16 parity rests on, and ``init_params``' draw slices at
MoE sizes. Inputs come from numpy seeds and go through both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import moe as RM
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

F32_BOUND = 1e-4       # as tests/test_torch_lm.py
BF16_BOUND = 2.0 ** -4
PER_OP = {"xla_allow_excess_precision": False}


def _close(got, want, bound):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound * scale, (err, scale, err / scale)


def _moe_params(rng, d, ff, E, mlp, scale=0.3):
    return {n: rng.randn(*s).astype(np.float32) * scale
            for n, s in RM.moe_param_shapes(d, ff, E, mlp).items()}


def _both(p: dict, x: np.ndarray, dtype=np.float32):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ({k: jnp.asarray(v, jd) for k, v in p.items()}, jnp.asarray(x, jd),
            {k: torch.as_tensor(v).to(td) for k, v in p.items()},
            torch.as_tensor(x).to(td))


def _moe_both(p, x, **kw):
    rp, rx, tp, tx = _both(p, x)
    want, wm = RM.moe_apply(rp, rx, **kw)
    got, gm = TM.moe_apply(tp, tx, **kw)
    return want, wm, got, gm


def _metrics_equal(gm: dict, wm: dict):
    """``dropped_frac`` (float64, from integer counts) equal bit for bit;
    ``heavy_mass`` (float32) is a ratio of sums of router probabilities
    over the sequence, which XLA adds in an order of its own: equal to
    within f32 rounding, 1e-6 relative."""
    assert sorted(gm) == sorted(wm) == ["dropped_frac", "heavy_mass"]
    for k in wm:
        want = np.asarray(wm[k])
        assert str(gm[k].dtype).split(".")[-1] == str(want.dtype), k
    assert float(gm["dropped_frac"]) == float(wm["dropped_frac"])
    assert float(gm["heavy_mass"]) == pytest.approx(
        float(wm["heavy_mass"]), rel=1e-6, abs=0)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skew_aware", [True, False])
@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_moe_apply_matches_reference(mlp, skew_aware):
    """Outputs within the float32 bound, ``dropped_frac`` (float64) and
    ``heavy_mass`` (float32) equal; B = 3 sequences, each with its own
    heaviest expert and its own capacity ranks."""
    rng = np.random.RandomState(0)
    p = _moe_params(rng, 16, 24, 6, mlp)
    x = rng.randn(3, 20, 16).astype(np.float32)
    want, wm, got, gm = _moe_both(p, x, mlp=mlp, num_experts=6, top_k=2,
                                  skew_aware=skew_aware)
    _close(got, want, F32_BOUND)
    _metrics_equal(gm, wm)
    assert (float(gm["heavy_mass"]) > 0) == skew_aware


@pytest.mark.parametrize("skew_aware", [True, False])
def test_moe_top_k_ties_pick_the_lowest_experts(skew_aware):
    """A zero router makes every row of probabilities uniform:
    ``lax.top_k`` then picks experts 0 and 1, which ``torch.topk`` does
    not; the port takes its top k from a stable sort. With the heavy
    path on, expert 0 (the first maximum of the mass) runs densely."""
    probs = torch.full((1, 4), 0.25)
    assert torch.topk(probs, 2).indices.tolist() != [[0, 1]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
                      ).tolist() == [[0, 1]]
    assert TM._top_k(probs, 2)[1].tolist() == [[0, 1]]
    rng = np.random.RandomState(1)
    p = _moe_params(rng, 16, 24, 4, "swiglu")
    p["router"][:] = 0.0
    x = rng.randn(2, 10, 16).astype(np.float32)
    want, wm, got, gm = _moe_both(p, x, mlp="swiglu", num_experts=4,
                                  top_k=2, skew_aware=skew_aware)
    _close(got, want, F32_BOUND)
    _metrics_equal(gm, wm)
    # every token picks experts 0 and 1 at weight 1/2; each expert keeps
    # C = int(1.25 * 10 * 2 / 4) = 6 of its 10 slots (with the heavy
    # path, expert 0 runs densely and only expert 1's slots count)
    assert float(gm["dropped_frac"]) == pytest.approx(0.4)


def test_moe_drops_tokens_beyond_capacity_as_the_reference():
    """A capacity factor of 0.3 leaves C = int(0.3 * 24 * 2 / 4) = 3
    slots per expert; the rank is counted over the flattened (token, k)
    slots, token-major, so the tokens dropped are the reference's."""
    rng = np.random.RandomState(2)
    p = _moe_params(rng, 16, 24, 4, "swiglu")
    x = rng.randn(2, 24, 16).astype(np.float32)
    for skew in (True, False):
        want, wm, got, gm = _moe_both(p, x, mlp="swiglu", num_experts=4,
                                      top_k=2, capacity_factor=0.3,
                                      skew_aware=skew)
        assert float(gm["dropped_frac"]) > 0.3
        _metrics_equal(gm, wm)
        _close(got, want, F32_BOUND)


def test_moe_bf16_rounds_as_the_reference_per_op():
    """bf16: the router in f32 from bf16 activations, the heavy weights
    and the gates cast to bf16 before their products: equal to the
    reference rounded per op, and the metrics equal."""
    rng = np.random.RandomState(3)
    p = _moe_params(rng, 32, 48, 8, "swiglu")
    x = rng.randn(2, 16, 32).astype(np.float32)
    rp, rx, tp, tx = _both(p, x, "bfloat16")
    kw = dict(mlp="swiglu", num_experts=8, top_k=2)
    want, wm = jax.jit(lambda a, b: RM.moe_apply(a, b, **kw)).lower(
        rp, rx).compile(compiler_options=PER_OP)(rp, rx)
    got, gm = TM.moe_apply(tp, tx, **kw)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2.0 ** -8)
    _metrics_equal(gm, wm)


def test_moe_ffn_with_the_dense_residual_matches_reference():
    """Arctic's MoE layer adds a dense MLP in parallel (``dense_*``
    weights) to the routed experts."""
    rc = RC.get_smoke("arctic_480b").reduced(dtype="float32")
    tc = TC.get_smoke("arctic_480b").reduced(dtype="float32")
    assert rc.moe.dense_residual
    rp = RT.init_params(rc, jax.random.PRNGKey(4))
    layer = jax.tree.map(lambda a: np.asarray(a[0]), rp["blocks"]["0"])
    assert any(k.startswith("dense_") for k in layer)
    h = np.random.RandomState(4).randn(2, 12, rc.d_model).astype(np.float32)
    want = RT._ffn(rc, 0, {k: jnp.asarray(v) for k, v in layer.items()},
                   jnp.asarray(h))
    layer = {k: v.copy() for k, v in layer.items()}
    got = TT._ffn(tc, 0, {k: torch.as_tensor(v) for k, v in layer.items()},
                  torch.as_tensor(h))
    _close(got, want, F32_BOUND)


# ---------------------------------------------------------------------------
# mamba_mixer
# ---------------------------------------------------------------------------

def _mamba_layer(seed, d=32):
    cfg = RC.get_smoke("jamba_v0_1_52b").reduced(d_model=d)
    rng = np.random.RandomState(seed)
    p = {n: rng.randn(*s).astype(np.float32) * 0.3 for n, s in
         RS.mamba_params(d, cfg.mamba_expand, cfg.mamba_d_state,
                         cfg.mamba_conv, max(d // 16, 8)).items()}
    p["A_log"] = rng.rand(*p["A_log"].shape).astype(np.float32)
    p.pop("ln")
    return cfg, TC.get_smoke("jamba_v0_1_52b").reduced(d_model=d), p


@pytest.mark.parametrize("S", [1, 5, 300])
def test_mamba_prefill_matches_reference(S):
    """Prefill: the causal depthwise conv, the selective scan in f32 (S
    = 300 crosses the port's 256-step chunk of formed updates, and the
    reference's chunking), and the last kw - 1 conv inputs it returns."""
    rcfg, tcfg, p = _mamba_layer(5)
    x = np.random.RandomState(6).randn(2, S, 32).astype(np.float32)
    rp, rx, tp, tx = _both(p, x)
    want, (wc, ws) = RS.mamba_mixer(rp, rx, rcfg)
    got, (gc, gs) = TS.mamba_mixer(tp, tx, tcfg)
    _close(got, want, F32_BOUND)
    assert ws is None and gs is None
    _close(gc, wc, F32_BOUND)


def test_mamba_decode_steps_carry_both_states():
    """Decode: five one-token steps from zero states; each step's output,
    conv window and f32 ssm state within the bound of the reference's,
    each package carrying its own states."""
    rcfg, tcfg, p = _mamba_layer(7)
    x = np.random.RandomState(8).randn(2, 5, 32).astype(np.float32)
    rp, rx, tp, tx = _both(p, x)
    din, kw, n = 2 * 32, rcfg.mamba_conv, rcfg.mamba_d_state
    rconv, rssm = jnp.zeros((2, kw - 1, din)), jnp.zeros((2, din, n))
    tconv, tssm = torch.zeros(2, kw - 1, din), torch.zeros(2, din, n)
    for t in range(5):
        want, (rconv, rssm) = RS.mamba_mixer(
            rp, rx[:, t:t + 1], rcfg, conv_state=rconv, ssm_state=rssm,
            decode=True)
        got, (tconv, tssm) = TS.mamba_mixer(
            tp, tx[:, t:t + 1], tcfg, conv_state=tconv, ssm_state=tssm,
            decode=True)
        _close(got, want, F32_BOUND)
        _close(tconv, rconv, F32_BOUND)
        _close(tssm, rssm, F32_BOUND)
        assert tssm.dtype == torch.float32
    with pytest.raises(ValueError, match="1 token"):
        TS.mamba_mixer(tp, tx[:, :2], tcfg, conv_state=tconv,
                       ssm_state=tssm, decode=True)


def test_mamba_bf16_rounds_as_the_reference_per_op():
    """bf16: silu and softplus as XLA lowers them op by op, dt*h formed
    in bf16 and cast to f32 for the scan: the mixer lies within one bf16
    rounding of the reference rounded per op."""
    rcfg, tcfg, p = _mamba_layer(9)
    x = np.random.RandomState(10).randn(2, 12, 32).astype(np.float32)
    rp, rx, tp, tx = _both(p, x, "bfloat16")
    want = jax.jit(lambda a, b: RS.mamba_mixer(a, b, rcfg)[0]).lower(
        rp, rx).compile(compiler_options=PER_OP)(rp, rx)
    _close(TS.mamba_mixer(tp, tx, tcfg)[0], want, 2.0 ** -8)


def test_silu_and_softplus_round_as_xla_per_op():
    """``layers.silu`` and ``ssm._softplus`` in bf16 equal
    ``jax.nn.silu`` and ``jax.nn.softplus`` compiled per op, bit for
    bit, on [-30, 30]; ``F.silu``, which rounds once, does not."""
    x = np.linspace(-30, 30, 4001).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    for rf, tf in ((jax.nn.silu, TL.silu), (jax.nn.softplus, TS._softplus)):
        want = jax.jit(rf).lower(xj).compile(compiler_options=PER_OP)(xj)
        want = torch.from_numpy(np.asarray(want).view(np.int16).copy())
        assert torch.equal(tf(xt).view(torch.int16), want), rf
    want = jax.jit(jax.nn.silu).lower(xj).compile(
        compiler_options=PER_OP)(xj)
    assert not torch.equal(
        torch.nn.functional.silu(xt).view(torch.int16),
        torch.from_numpy(np.asarray(want).view(np.int16).copy()))


def test_jamba_bf16_reference_is_fixed_only_per_op():
    """The hazard behind the bf16 cases' per-op reference: Jamba's smoke
    prefill in bf16, jitted with XLA's default excess precision, lies
    beyond the bf16 bound of the same reference rounded per op (MoE
    routing near-ties flip); the port lies within 1e-5 of the per-op
    run."""
    rc = RC.get_smoke("jamba_v0_1_52b").reduced(dtype="bfloat16")
    tc = TC.get_smoke("jamba_v0_1_52b").reduced(dtype="bfloat16")
    rp = jax.jit(RT.init_params, static_argnums=0)(rc, jax.random.PRNGKey(0))
    tp = TT.params_from_numpy(tc, jax.tree.map(np.asarray, rp), device="cpu")
    toks = np.random.RandomState(0).randint(0, rc.vocab, (2, 12)).astype(
        np.int32)
    jit = jax.jit(RT.prefill, static_argnums=0)
    fused = np.asarray(jit(rc, rp, jnp.asarray(toks)).astype(jnp.float32))
    per_op = jit.lower(rc, rp, jnp.asarray(toks)).compile(
        compiler_options=PER_OP)(rp, jnp.asarray(toks))
    per_op = np.asarray(per_op.astype(jnp.float32))
    scale = float(np.abs(per_op).max())
    assert float(np.abs(fused - per_op).max()) > BF16_BOUND * scale
    _close(TT.prefill(tc, tp, torch.as_tensor(toks)), per_op, 1e-5)


# ---------------------------------------------------------------------------
# init_params at MoE sizes
# ---------------------------------------------------------------------------

def _stacked_leaves(cfg):
    defs = TT.param_defs(cfg)
    for top in ("blocks", "encoder"):
        node = defs.get(top, {})
        leaves = node.values() if top == "encoder" else [
            pd for layer in node.values() for pd in layer.values()]
        for pd in leaves:
            yield pd


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_init_params_draws_at_most_draw_elems_at_once(arch):
    """At full size (meta tensors: shapes only), every stacked leaf is
    drawn a block at a time, and a block larger than ``DRAW_ELEMS`` (the
    MoE experts of Mixtral, Arctic and Jamba) in runs of its leading
    rows of at most that many elements; the slices tile the leaf in
    order. Every other config keeps one draw per block."""
    cfg = TC.get_config(arch)
    split = False
    for pd in _stacked_leaves(cfg):
        out = torch.empty(pd.shape, device="meta")
        slices = TT._draw_slices(out, True)
        assert sum(s.numel() for s in slices) == out.numel()
        if out[0].numel() <= TT.DRAW_ELEMS:
            assert len(slices) == out.shape[0]
        else:
            split = True
            assert all(s.numel() <= TT.DRAW_ELEMS for s in slices)
    assert split == (cfg.moe is not None)


def test_init_params_split_draws(monkeypatch):
    """With ``DRAW_ELEMS`` cut to one expert's worth, Mixtral's smoke
    experts are drawn one expert at a time, the slices are views of the
    leaf in order, and the weights are the seed's, call after call."""
    cfg = TC.get_smoke("mixtral_8x22b").reduced(dtype="float32")
    E, d, ff = 4, cfg.d_model, cfg.moe.d_ff_expert
    monkeypatch.setattr(TT, "DRAW_ELEMS", d * ff)
    leaf = torch.arange(cfg.n_blocks * E * d * ff, dtype=torch.float32)
    leaf = leaf.reshape(cfg.n_blocks, E, d, ff)
    slices = TT._draw_slices(leaf, True)
    assert [tuple(s.shape) for s in slices] == [(1, d, ff)] * (
        cfg.n_blocks * E)
    assert torch.equal(torch.cat(slices).reshape(leaf.shape), leaf)
    params = TT.init_params(cfg, 3, device="cpu")
    again = TT.init_params(cfg, 3, device="cpu")
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        assert torch.equal(a, b)
    w = params["blocks"]["0"]["moe_wi0"]
    assert abs(float(w.std()) * d ** 0.5 - 1.0) < 0.1
