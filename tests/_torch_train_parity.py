"""The train-step parity check that ``test_torch_train.py`` (AdamW) and
``test_torch_lm_grad.py`` (Adafactor) share: one step of the port and of
the reference from the same weights and batch, in float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import transformer as RT
from repro.train import optim as RO
from repro.train.train_loop import make_train_step as r_make_train_step
from repro_torch import configs as TC
from repro_torch.models import transformer as TT
from repro_torch.train import optim as O
from repro_torch import tree as TR
from repro_torch.train import train_loop as TL

ARCHS = ["rwkv6_7b", "gemma2_27b", "gemma_7b", "deepseek_67b",
         "nemotron_4_15b", "whisper_base", "mixtral_8x22b", "arctic_480b",
         "jamba_v0_1_52b", "internvl2_1b"]
LOSS_REL = 1e-5        # |loss - reference loss| / |reference loss|
GRAD_BOUND = 1e-4      # |grad - reference grad| / max |reference grad|, a
#   leaf at a time: two f32 backward passes whose sums run in other orders
#   (1e-6 measured; Jamba's Mamba scans 5e-5, the most)
# The optimizer's moments hold the gradients: AdamW's new m is 0.1 x the
# clipped gradient, its v and Adafactor's second moments are (means of)
# its squares, whose error is at most 2 |g| |dg| a term: twice the bound
MOMENT_BOUND = 2 * GRAD_BOUND


def _batch(cfg, B=2, S=16, seed=0) -> dict:
    """numpy tokens and labels (the last three of row 0 padding, -1), an
    image prefix or encoder frames where the config takes them."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, -3:] = -1
    if cfg.n_image_tokens:
        batch["embeds_prefix"] = rng.randn(
            B, cfg.n_image_tokens, cfg.d_model).astype(np.float32)
    if cfg.enc_layers:
        batch["enc_embeds"] = rng.randn(B, 24, cfg.d_model).astype(
            np.float32)
    return batch


def _model(models, arch):
    if arch not in models:
        rc = RC.get_smoke(arch).reduced(dtype="float32")
        tc = TC.get_smoke(arch).reduced(dtype="float32")
        rp = jax.jit(RT.init_params, static_argnums=0)(
            rc, jax.random.PRNGKey(0))
        tp = TT.params_from_numpy(tc, jax.tree.map(np.asarray, rp),
                                  device="cpu")
        models[arch] = (rc, tc, rp, tp)
    return models[arch]


def _leaf_close(got: torch.Tensor, want, bound: float, what: str):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound * scale or err == 0.0, (what, err, scale)


KINDS = ("adamw", "adafactor")
_REFERENCE_STEPS = {}


def _opt(kind: str) -> dict:
    return dict(kind=kind, lr=1e-3, warmup=1, total_steps=10)


def reference_steps(models, arch, microbatches) -> dict:
    """The reference's train step with each optimizer, from the same
    weights and batch: {kind: (params, state, metrics)}. Both steps run
    in one jitted call (one compile a config and microbatch count; the
    two share the loss and its gradient)."""
    key = (arch, microbatches)
    if key not in _REFERENCE_STEPS:
        rc, _, rp, _ = _model(models, arch)
        cfgs = {kind: RO.OptConfig(**_opt(kind)) for kind in KINDS}
        steps = {kind: r_make_train_step(rc, c, microbatches=microbatches)
                 for kind, c in cfgs.items()}
        both = jax.jit(lambda p, states, b: {
            kind: steps[kind](p, states[kind], b) for kind in KINDS})
        _REFERENCE_STEPS[key] = both(
            rp, {kind: RO.init_state(c, rp) for kind, c in cfgs.items()},
            {k: jnp.asarray(v) for k, v in _batch(rc).items()})
    return _REFERENCE_STEPS[key]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while a module of these tests runs: the
    suite runs in several worker processes on the machine's cores, and
    these tests' products and XLA compiles would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def step_matches_reference(models, arch, kind, microbatches):
    """One train step of both packages from the same weights and batch:
    the loss, the gradient norm and the learning rate, and each leaf of
    the new optimizer state (the gradients, through the moments)."""
    rc, tc, rp, tp = _model(models, arch)
    tocfg = O.OptConfig(**_opt(kind))
    batch = _batch(rc)
    _, rstate, rm = reference_steps(models, arch, microbatches)[kind]
    params = TR.tree_map(lambda t: t.clone(), tp)
    _, tstate, tm = TL.make_train_step(tc, tocfg, microbatches)(
        params, O.init_state(tocfg, params),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    want = float(rm["loss"])
    assert abs(float(tm["loss"]) - want) <= LOSS_REL * abs(want), \
        (float(tm["loss"]), want)
    assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
        GRAD_BOUND * float(rm["grad_norm"])
    assert float(tm["lr"]) == float(rm["lr"])
    assert int(tstate["step"]) == int(rstate["step"]) == 1
    flat = TR.flatten({k: v for k, v in tstate.items() if k != "step"})
    ref = jax.tree.leaves({k: v for k, v in rstate.items() if k != "step"})
    assert len(flat) == len(ref)
    for (path, got), want in zip(flat, ref):
        _leaf_close(got, want, GRAD_BOUND if path.startswith("m/")
                    else MOMENT_BOUND, path)
    # params unchanged: the step is functional
    for a, b in zip(TR.leaves(params), TR.leaves(tp)):
        assert torch.equal(a, b)


