"""Training step construction: microbatched gradient accumulation and the
entry points of the three step kinds.

PyTorch twin of ``repro.train.train_loop``. ``make_train_step`` returns a
functional ``(params, opt_state, batch) -> (params, opt_state, metrics)``
step: the gradients come from ``torch.autograd.grad`` over detached
copies of the parameter leaves, so the caller's tensors never record a
graph. With ``microbatches`` the batch's leading dim is split as
``(microbatches, -1)``; the gradients are summed in f32 over the
microbatches in order and divided, and the loss averaged, as the
reference's scan does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import tree as TR
from ..models import transformer as T
from ..models.config import ModelConfig
from . import optim as O


def make_loss(cfg: ModelConfig) -> Callable:
    def loss(params, batch):
        return T.loss_fn(cfg, params, batch)
    return loss


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the gradient of every
    parameter leaf in its dtype (zeros where a leaf does not reach the
    loss), as ``jax.value_and_grad`` gives it."""
    flat = TR.leaves(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = loss_fn(TR.unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), TR.unflatten_like(params, grads)


def make_train_step(cfg: ModelConfig, ocfg: O.OptConfig,
                    microbatches: int = 1, donate: bool = False
                    ) -> Callable:
    """The train step. ``donate``: the optimizer writes the new parameters
    and state into the given tensors (``apply_updates``' donation, the
    reference's ``donate_argnums=(0, 1)``)."""
    loss_fn = make_loss(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = TR.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            tot = torch.zeros((), dtype=torch.float32,
                              device=TR.leaves(params)[0].device)
            split = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items() if v is not None}
            for i in range(microbatches):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in split.items()})
                grads = TR.tree_map(lambda a, x: a + x.float(), grads, g)
                tot = tot + l
                del g
            grads = TR.tree_map(lambda g: g / microbatches, grads)
            loss = tot / microbatches
        gnorm = O._global_norm(grads)
        new_params, new_state = O.apply_updates(ocfg, params, grads,
                                                opt_state, donate=donate)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": O.lr_at(ocfg, new_state["step"])}
        return new_params, new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# the step kinds' entry points
# ---------------------------------------------------------------------------

def train_step_fn(cfg: ModelConfig, ocfg: Optional[O.OptConfig] = None,
                  **kw):
    """(train step, its OptConfig): Adafactor for MoE configs and for
    those above 3e10 parameters, AdamW otherwise, unless given."""
    ocfg = ocfg or O.OptConfig(
        kind="adafactor" if (cfg.moe is not None
                             or cfg.param_count() > 3e10) else "adamw")
    return make_train_step(cfg, ocfg, **kw), ocfg


def prefill_step_fn(cfg: ModelConfig):
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch["tokens"],
                         enc_embeds=batch.get("enc_embeds"))
    return prefill_step


def decode_step_fn(cfg: ModelConfig):
    def serve_step(params, caches, batch):
        return T.decode_step(cfg, params, caches, batch["token"],
                             batch["cache_len"],
                             enc_out=batch.get("enc_out"))
    return serve_step
