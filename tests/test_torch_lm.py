"""The port's LM serving half against the reference on the CPU: configs,
parameter trees, ``prefill``, ``forward`` and ``decode_step`` logits of
the smoke configs from the reference's own weights (``params_from_numpy``
of ``T.init_params``), ``ServeEngine`` tokens, and one test per parity
hazard found by reading the code. Whisper's cases pass the encoder's
frame embeddings (``enc_embeds``) and its output (``enc_out``) as the
reference's own tests do; InternVL2's forward takes an image prefix."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as RServeEngine
from repro_torch import configs as TC
from repro_torch.kernels import ops as TK
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeEngine

PARITY = ["rwkv6_7b", "gemma2_27b", "gemma_7b", "deepseek_67b",
          "nemotron_4_15b", "whisper_base", "mixtral_8x22b", "arctic_480b",
          "jamba_v0_1_52b", "internvl2_1b"]
ENC_FRAMES = 24        # encoder frames of Whisper's cases (test_models.py)
F32_BOUND = 1e-4       # |port - reference| / max |reference| in float32
# In bf16 both packages round activations to bf16, but not always at the
# same places. Each rounding is at most 2^-9 relative; two smoke layers
# hold a few tens of them on the path to a logit, and the norms rescale.
# The two packages' logits then differ by a few bf16 ulps of the largest
# logit (0.4-2% measured on these inputs): the bound is 2^-4. The bf16
# cases compile the reference with XLA's excess precision off
# (``_per_op``), so that it rounds after every op as PyTorch does (and
# as it does op by op under jax.disable_jit()). By default XLA keeps f32
# between some fused ops, and there an ulp can flip a near-tie of a
# top-2 MoE router: Jamba's smoke logits then lie 31% of max |logit|
# from the reference's own per-op run's (test_torch_moe_ssm.py).
BF16_BOUND = 2.0 ** -4
PER_OP = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def models():
    """(arch, dtype) -> (reference cfg, port cfg, reference params, port
    params), built once per module."""
    return {}


def _model(models, arch, dtype="float32"):
    key = (arch, dtype)
    if key not in models:
        rc = RC.get_smoke(arch).reduced(dtype=dtype)
        tc = TC.get_smoke(arch).reduced(dtype=dtype)
        rp = jax.jit(RT.init_params, static_argnums=0)(
            rc, jax.random.PRNGKey(0))
        tp = TT.params_from_numpy(tc, jax.tree.map(np.asarray, rp),
                                  device="cpu")
        models[key] = (rc, tc, rp, tp)
    return models[key]


def _tokens(vocab, B=2, S=12, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def _per_op(fn):
    """The reference's ``fn(cfg, ...)`` jitted with XLA's excess
    precision off: every op's result rounded to its dtype. One
    executable per config."""
    compiled = {}

    def call(cfg, *args, **kw):
        if cfg not in compiled:
            compiled[cfg] = jax.jit(fn, static_argnums=0).lower(
                cfg, *args, **kw).compile(compiler_options=PER_OP)
        return compiled[cfg](*args, **kw)
    return call


def _enc(cfg, B=2, seed=9):
    """(reference kwargs, port kwargs) of the encoder's input: N(0, 1)
    frame embeddings (B, ENC_FRAMES, d) where the config has an
    encoder, else none."""
    if not cfg.enc_layers:
        return {}, {}
    e = np.random.RandomState(seed).randn(B, ENC_FRAMES, cfg.d_model)
    e = e.astype(np.float32)
    return ({"enc_embeds": jnp.asarray(e)},
            {"enc_embeds": torch.as_tensor(e)})


def _close(got, want, bound):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (got.shape, want.shape)
    assert err <= bound * scale, (err, scale, err / scale)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RC.ARCHS)
def test_config_equals_reference(arch):
    assert dataclasses.asdict(TC.get_config(arch)) == \
        dataclasses.asdict(RC.get_config(arch))
    assert dataclasses.asdict(TC.get_smoke(arch)) == \
        dataclasses.asdict(RC.get_smoke(arch))


def test_config_tables_equal_reference():
    assert TC.ARCHS == RC.ARCHS and TC.SHAPES == RC.SHAPES
    assert TC.cells() == RC.cells() and TC.LONG_OK == RC.LONG_OK
    for alias, name in RC.ALIASES.items():
        assert dataclasses.asdict(TC.get_config(alias)) == \
            dataclasses.asdict(RC.get_config(name))


@pytest.mark.parametrize("arch", PARITY)
def test_param_defs_equal_reference(arch):
    cfg = RC.get_config(arch)
    want = jax.tree.leaves(RT.param_defs(cfg),
                           is_leaf=lambda x: isinstance(x, RT.PD))
    got = jax.tree.leaves(TT.param_defs(TC.get_config(arch)),
                          is_leaf=lambda x: isinstance(x, TT.PD))
    assert [(p.shape, p.axes, p.init) for p in got] == \
        [(p.shape, p.axes, p.init) for p in want]


# ---------------------------------------------------------------------------
# logits against the reference, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PARITY)
def test_prefill_matches_reference(models, arch):
    rc, tc, rp, tp = _model(models, arch)
    toks = _tokens(rc.vocab)
    rkw, tkw = _enc(rc)
    want = jax.jit(RT.prefill, static_argnums=0)(rc, rp, jnp.asarray(toks),
                                                 **rkw)
    got = TT.prefill(tc, tp, torch.as_tensor(toks), **tkw)
    assert got.dtype == torch.float32
    _close(got, want, F32_BOUND)


@pytest.mark.parametrize("arch", PARITY)
def test_forward_matches_reference(models, arch):
    rc, tc, rp, tp = _model(models, arch)
    toks = _tokens(rc.vocab, seed=1)
    rkw, tkw = _enc(rc)
    if rc.n_image_tokens:
        prefix = np.random.RandomState(8).randn(
            2, rc.n_image_tokens, rc.d_model).astype(np.float32)
        rkw = {"embeds_prefix": jnp.asarray(prefix)}
        tkw = {"embeds_prefix": torch.as_tensor(prefix)}
    want = jax.jit(RT.forward, static_argnums=0)(rc, rp, jnp.asarray(toks),
                                                 **rkw)
    got = TT.forward(tc, tp, torch.as_tensor(toks), **tkw)
    assert got.shape == (2, 12 + rc.n_image_tokens, rc.d_model)
    _close(got, want, F32_BOUND)


def _decode_both(rc, tc, rp, tp, toks, max_len=16, bound=F32_BOUND,
                 step=None):
    """Decode ``toks`` (B, n) step by step through both packages; each
    step's logits within ``bound``; Whisper's steps cross-attend to each
    package's own encoder output. ``step``: the reference's decode step
    (jitted by default). Returns both caches."""
    step = step or jax.jit(RT.decode_step, static_argnums=0)
    rcache = RT.init_cache(rc, toks.shape[0], max_len)
    tcache = TT.init_cache(tc, toks.shape[0], max_len, device="cpu")
    rkw, tkw = _enc(rc, B=toks.shape[0])
    if rkw:
        rkw = {"enc_out": RT._encoder(rc, rp, rkw["enc_embeds"])}
        tkw = {"enc_out": TT._encoder(tc, tp, tkw["enc_embeds"])}
        _close(tkw["enc_out"], rkw["enc_out"], bound)
    for t in range(toks.shape[1]):
        want, rcache = step(rc, rp, rcache, jnp.asarray(toks[:, t]),
                            jnp.asarray(t, jnp.int32), **rkw)
        got, tcache = TT.decode_step(tc, tp, tcache,
                                     torch.as_tensor(toks[:, t]), t, **tkw)
        _close(got, want, bound)
    return rcache, tcache


@pytest.mark.parametrize("arch", PARITY)
def test_decode_steps_match_reference(models, arch):
    """Six steps of the cache decode path, and the caches themselves: the
    (n_blocks, B, Hkv, max_len, hd) KV layout written at each step's
    position (zero beyond it), the token shift and the f32 RWKV state,
    Mamba's conv inputs and f32 ssm state."""
    rc, tc, rp, tp = _model(models, arch)
    toks = _tokens(rc.vocab, S=6, seed=2)
    rcache, tcache = _decode_both(rc, tc, rp, tp, toks)
    assert sorted(tcache) == sorted(rcache)
    for pos, c in rcache.items():
        assert sorted(tcache[pos]) == sorted(c)
        for name, want in c.items():
            got = tcache[pos][name]
            assert tuple(got.shape) == want.shape, name
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
            _close(got, want, F32_BOUND)
            if name.startswith("kv_"):
                assert not bool(got[:, :, :, 6:].any())


@pytest.mark.parametrize("arch", PARITY)
def test_bf16_logits_within_the_stated_bound(models, arch):
    """bf16 weights and activations, against the reference rounded per
    op (BF16_BOUND says why the bound is what it is, and why per op):
    prefill and three decode steps."""
    rc, tc, rp, tp = _model(models, arch, "bfloat16")
    toks = _tokens(rc.vocab)
    rkw, tkw = _enc(rc)
    want = _per_op(RT.prefill)(rc, rp, jnp.asarray(toks), **rkw)
    _close(TT.prefill(tc, tp, torch.as_tensor(toks), **tkw), want,
           BF16_BOUND)
    _decode_both(rc, tc, rp, tp, toks[:, :3], bound=BF16_BOUND,
                 step=_per_op(RT.decode_step))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2_27b"])
def test_serve_generate_matches_reference(models, arch):
    """Greedy tokens equal to the reference engine's (jit=False), with
    prompts of different lengths: both pad the shorter prompt on the
    right with token 0 and step it through the padding."""
    rc, tc, rp, tp = _model(models, arch)
    prompts = [([3, 1, 4, 1, 5], 3), ([9, 2], 4)]
    want = RServeEngine(rc, rp, max_len=16, jit=False).generate(
        [RRequest(prompt=p, max_new_tokens=n) for p, n in prompts])
    got = ServeEngine(tc, tp, max_len=16, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in prompts])
    assert got == want
    assert [len(o) for o in got] == [3, 4]


def test_serve_first_token_is_the_prefill_argmax(models):
    """tests/test_serve.py's check on the port: the first generated token
    is the argmax of prefill's logits over the prompt as the engine feeds
    it, padded on the right with 0 to the longest prompt (the
    reference's padding, kept: ROADMAP.md queue 3)."""
    _, tc, _, tp = _model(models, "deepseek_67b")
    prompts = [[3, 1, 4, 1, 5], [2, 7]]
    outs = ServeEngine(tc, tp, max_len=16, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=1) for p in prompts])
    padded = torch.tensor([[3, 1, 4, 1, 5], [2, 7, 0, 0, 0]])
    first = torch.argmax(TT.prefill(tc, tp, padded), dim=-1).tolist()
    assert [o[0] for o in outs] == first


@pytest.mark.parametrize("arch", ["rwkv6_7b", "gemma2_27b"])
def test_serve_tokens_equal_greedy_decoding_by_prefill(models, arch):
    """The engine decodes step by step through the caches; greedy
    decoding by repeated prefill over the padded prompt and the tokens so
    far (the path that reaches the kernels) gives the same tokens."""
    _, tc, _, tp = _model(models, arch)
    prompts = [[3, 1, 4, 1, 5], [2, 7]]
    outs = ServeEngine(tc, tp, max_len=16, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=4) for p in prompts])
    seq = torch.tensor([[3, 1, 4, 1, 5], [2, 7, 0, 0, 0]])
    for _ in range(4):
        nxt = torch.argmax(TT.prefill(tc, tp, seq), dim=-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert seq[:, 5:].tolist() == outs


def test_serve_engine_serves_whisper_without_cross_attention(models):
    """The reference's engine never passes ``enc_out`` to its decode
    steps (serve/engine.py:58-83), so it serves Whisper's decoder
    without cross-attention; the port's engine matches it, token for
    token: its tokens equal those of decode steps without ``enc_out``,
    and differ from those of decode steps that cross-attend to an
    encoder output."""
    rc, tc, rp, tp = _model(models, "whisper_base")
    prompts = [([3, 1, 4, 1, 5], 5), ([9, 2], 5)]
    want = RServeEngine(rc, rp, max_len=16, jit=False).generate(
        [RRequest(prompt=p, max_new_tokens=n) for p, n in prompts])
    got = ServeEngine(tc, tp, max_len=16, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in prompts])
    assert got == want

    def greedy(enc_out):
        caches = TT.init_cache(tc, 2, 16, device="cpu")
        seq = torch.tensor([[3, 1, 4, 1, 5], [9, 2, 0, 0, 0]])
        out = []
        for t in range(9):
            tok = seq[:, t] if t < 5 else out[-1]
            logits, caches = TT.decode_step(tc, tp, caches, tok, t,
                                            enc_out=enc_out)
            if t >= 4:
                out.append(torch.argmax(logits, dim=-1))
        return torch.stack(out, 1).tolist()

    assert greedy(None) == got
    enc = TT._encoder(tc, tp, _enc(rc)[1]["enc_embeds"])
    assert greedy(enc) != got


def test_forward_without_enc_embeds_raises_naming_it(models):
    """The reference's forward for a config with an encoder and no
    ``enc_embeds`` fails on None inside the encoder (an AttributeError);
    the port raises a ValueError that names the missing argument (a
    deliberate difference, ROADMAP.md queue 3)."""
    rc, tc, rp, tp = _model(models, "whisper_base")
    toks = _tokens(rc.vocab, S=4)
    with pytest.raises(AttributeError):
        RT.forward(rc, rp, jnp.asarray(toks))
    for call in (TT.forward, TT.prefill):
        with pytest.raises(ValueError, match="enc_embeds"):
            call(tc, tp, torch.as_tensor(toks))


def test_serve_engine_refuses_params_on_another_device(models):
    _, tc, _, tp = _model(models, "gemma_7b")
    with pytest.raises(ValueError, match="params on cpu"):
        ServeEngine(tc, tp, device="meta")


# ---------------------------------------------------------------------------
# parity hazards, one test each
# ---------------------------------------------------------------------------

def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to approximate=True: the port's geglu and
    gelu MLPs use the tanh form, which differs from the erf form by up
    to about 4e-4 on [-3, 3]."""
    x = torch.linspace(-3, 3, 601)
    assert float((F.gelu(x) - F.gelu(x, approximate="tanh")).abs().max()) \
        > 1e-4
    rng = np.random.RandomState(3)
    p = {n: rng.randn(*s).astype(np.float32) * 0.5 for n, s in
         TL.mlp_param_shapes("geglu", 8, 16).items()}
    h = rng.randn(4, 8).astype(np.float32) * 2
    for kind in ("geglu", "gelu"):
        want = RL.mlp_apply(kind, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(h))
        got = TL.mlp_apply(kind, {k: torch.as_tensor(v) for k, v in
                                  p.items()}, torch.as_tensor(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_embed_scale_rounds_to_the_model_dtype_first():
    """Gemma's embedding scale is jnp.asarray(sqrt(d), x.dtype): in bf16
    at d = 4608 it is 68.0, not 67.88."""
    cfg = TC.get_config("gemma2_27b").reduced(vocab=5)
    rcfg = RC.get_config("gemma2_27b").reduced(vocab=5)
    emb = np.random.RandomState(4).randn(5, 4608).astype(np.float32)
    tok = np.array([[0, 3, 4]], np.int32)
    want = RT.embed_tokens(rcfg, {"embed": jnp.asarray(emb, jnp.bfloat16)},
                           jnp.asarray(tok))
    emb_t = torch.as_tensor(emb).to(torch.bfloat16)
    got = TT.embed_tokens(cfg, {"embed": emb_t}, torch.as_tensor(tok))
    assert torch.equal(got.view(torch.int16), torch.from_numpy(
        np.asarray(want).view(np.int16).copy()))
    assert torch.equal(got, emb_t[torch.as_tensor(tok).long()] * 68.0)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rms_norm_and_half_split_rope_match_reference(dtype):
    """rms_norm in f32 with (1 + gamma), cast back; rope's half-split
    rotation with f32 frequencies theta ** (-arange(half) / half)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 7, 16).astype(np.float32)
    gamma = rng.randn(16).astype(np.float32) * 0.1
    pos = np.arange(7, dtype=np.int32) * 37
    xj, gj = jnp.asarray(x, dtype), jnp.asarray(gamma, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.as_tensor(x).to(tdt)
    gt = torch.as_tensor(gamma).to(tdt)
    atol = 2e-2 if tdt == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(
        TL.rms_norm(xt, gt).float().numpy(),
        np.asarray(RL.rms_norm(xj, gj).astype(jnp.float32)), atol=atol)
    got = TL.rope(xt, torch.as_tensor(pos), 10000.0).float().numpy()
    want = np.asarray(RL.rope(xj, jnp.asarray(pos), 10000.0).astype(
        jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol)
    # the interleaved rotation would be another function
    x1, x2 = xt[..., 0::2], xt[..., 1::2]
    assert not np.allclose(torch.cat([x1, x2], -1).float().numpy(),
                           xt.float().numpy())


def test_rwkv_decay_is_rounded_to_the_model_dtype(monkeypatch):
    """ssm.py:119-120: w is computed in f32 and cast to the model dtype
    before the recurrence, so in bf16 a decay near 1 rounds (to 1.0 for
    w0 = -10). The port hands the recurrence the reference's bf16 decays,
    bit for bit; H is d // rwkv_head_dim even where n_heads differs."""
    cfg = TC.get_smoke("rwkv6_7b").reduced(n_heads=4)
    rcfg = RC.get_smoke("rwkv6_7b").reduced(n_heads=4)
    d, H, K = cfg.d_model, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    rng = np.random.RandomState(6)
    p = {n: rng.randn(*s).astype(np.float32) * 0.3 for n, s in
         RS.rwkv_mixer_params(d, H, K).items()}
    p["wb"] *= 1e-3
    p["w0"] = np.full((H, K), -10.0, np.float32)
    p["w0"][0, :4] = [-1.0, 0.0, 2.0, 4.0]
    x = rng.randn(2, 9, d).astype(np.float32)
    seen = []
    orig = TK.rwkv6_scan

    def spy(r, k, v, w, u, chunk=64):
        seen.append(w)
        return orig(r, k, v, w, u, chunk)

    monkeypatch.setattr(TK, "rwkv6_scan", spy)
    got, _ = TS.rwkv_mixer({k: torch.as_tensor(v).to(torch.bfloat16)
                            for k, v in p.items()},
                           torch.as_tensor(x).to(torch.bfloat16), cfg, None)
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    xj = jnp.asarray(x, jnp.bfloat16)
    xx = jnp.concatenate([jnp.zeros((2, 1, d), xj.dtype), xj[:, :-1]], 1)
    xw = xj * pj["mu"][3] + xx * (1.0 - pj["mu"][3])
    dlog = pj["w0"].reshape(1, 1, d) + jnp.tanh(xw @ pj["wa"]) @ pj["wb"]
    w = jnp.exp(-jnp.exp(jnp.clip(dlog.astype(jnp.float32), -10, 4)))
    w = w.reshape(2, 9, H, K).transpose(0, 2, 1, 3).astype(jnp.bfloat16)
    assert seen[0].dtype == torch.bfloat16 and seen[0].shape == (2, H, 9, K)
    assert float(seen[0][:, 1:].float().min()) == 1.0
    want_w = torch.from_numpy(np.asarray(w).view(np.int16).copy())
    assert torch.equal(seen[0].view(torch.int16), want_w)
    want, _ = RS.rwkv_mixer(pj, xj, rcfg, None)
    _close(got, want, BF16_BOUND)


def test_params_from_numpy_carries_bf16_bit_for_bit():
    """np.asarray of a JAX bf16 array is an ml_dtypes.bfloat16 array,
    which torch.from_numpy refuses; params_from_numpy views it as
    uint16, then as torch.bfloat16."""
    cfg = RC.get_smoke("gemma_7b")
    rp = RT.init_params(cfg, jax.random.PRNGKey(3))
    emb = np.asarray(rp["embed"]).copy()
    with pytest.raises(TypeError):
        torch.from_numpy(emb)
    tp = TT.params_from_numpy(TC.get_smoke("gemma_7b"),
                              jax.tree.map(np.asarray, rp), device="cpu")
    for got, want in zip(jax.tree.leaves(tp), jax.tree.leaves(rp)):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16))


def test_logits_use_the_untied_head_in_f32_with_the_final_softcap(models):
    """transformer.py:474-491: f32 h @ head.T, then final_softcap; RWKV-6
    has its own head (tie_embeddings=False), Gemma-2 the embedding and a
    final softcap of 30."""
    for arch in ("rwkv6_7b", "gemma2_27b"):
        _, tc, _, tp = _model(models, arch)
        toks = torch.as_tensor(_tokens(tc.vocab, S=5, seed=7))
        h = TT.forward(tc, tp, toks)[:, -1]
        head = tp["embed"] if tc.tie_embeddings else tp["head"]
        want = h.float() @ head.float().t()
        if tc.final_softcap:
            want = tc.final_softcap * torch.tanh(want / tc.final_softcap)
        assert torch.equal(TT.prefill(tc, tp, toks), want)
        assert ("head" in tp) == (arch == "rwkv6_7b")
