"""Optimizers: AdamW and Adafactor (factored second moment).

PyTorch twin of ``repro.train.optim``. The state is a dict of tensors on
the parameters' devices: a step counter (int32) and f32 moments (AdamW's
m and v; Adafactor's row and column second moments for leaves of two
or more dims, a full one otherwise). ``apply_updates`` takes the
reference's arithmetic in f32, leaf by leaf in sorted-key order; with
``donate`` it writes the new parameters and moments into the given
tensors (the reference's buffer donation), which holds one leaf's
temporaries at a time instead of a second copy of everything.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from .. import tree as TR


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Warmup, then cosine decay to a tenth, in f32 (step: an int or an
    integer tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _factored(p: torch.Tensor, make=_zeros) -> dict:
    if p.dim() >= 2:
        return {"vr": make(p.shape[:-1], p),
                "vc": make(p.shape[:-2] + p.shape[-1:], p)}
    return {"v": make(p.shape, p)}


def init_state(cfg: OptConfig, params) -> dict:
    dev = TR.leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.kind == "adamw":
        return {"step": step,
                "m": TR.tree_map(lambda p: _zeros(p.shape, p), params),
                "v": TR.tree_map(lambda p: _zeros(p.shape, p), params)}
    assert cfg.kind == "adafactor", cfg.kind
    return {"step": step, "f": TR.tree_map(_factored, params)}


def abstract_state(cfg: OptConfig, abstract_params) -> dict:
    """``init_state``'s shapes and dtypes as tensors on the ``meta``
    device (no memory), from parameters that may themselves be on
    ``meta``."""
    def z(shape, _p=None):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    step = torch.empty((), dtype=torch.int32, device="meta")
    if cfg.kind == "adamw":
        return {"step": step,
                "m": TR.tree_map(lambda p: z(p.shape), abstract_params),
                "v": TR.tree_map(lambda p: z(p.shape), abstract_params)}
    return {"step": step,
            "f": TR.tree_map(lambda p: _factored(p, z), abstract_params)}


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves added
    one at a time in sorted-key order."""
    tot = 0
    for g in TR.leaves(grads):
        tot = tot + torch.sum(torch.square(g.float()))
    return torch.sqrt(tot)


def _put(dst: torch.Tensor, src: torch.Tensor, donate: bool):
    return dst.copy_(src) if donate else src


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state,
                  donate: bool = False) -> Tuple[Any, dict]:
    """One optimizer step: (new params, new state). Gradients are clipped
    to ``clip_norm`` by their global norm first. ``donate``: the new
    values go into ``params``' and ``state``'s own tensors."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    flat_p = TR.leaves(params)
    flat_g = TR.leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"apply_updates: {len(flat_g)} gradient leaves for "
                         f"{len(flat_p)} parameters")

    if cfg.kind == "adamw":
        stepf = step.to(torch.float32)
        b1c = 1 - cfg.b1 ** stepf
        b2c = 1 - cfg.b2 ** stepf
        out_p, out_m, out_v = [], [], []
        for p, g, m, v in zip(flat_p, flat_g, TR.leaves(state["m"]),
                              TR.leaves(state["v"])):
            g = g.float() * scale
            m2 = cfg.b1 * m + (1 - cfg.b1) * g
            v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
            mh = m2 / b1c
            vh = v2 / b2c
            step_dir = mh / (torch.sqrt(vh) + cfg.eps)
            pf = p.float()
            new_p = (pf - lr * (step_dir + cfg.weight_decay * pf)).to(p.dtype)
            out_p.append(_put(p, new_p, donate))
            out_m.append(_put(m, m2, donate))
            out_v.append(_put(v, v2, donate))
        new_state = {"step": _put(state["step"], step, donate),
                     "m": TR.unflatten_like(params, out_m),
                     "v": TR.unflatten_like(params, out_v)}
        return TR.unflatten_like(params, out_p), new_state

    assert cfg.kind == "adafactor", cfg.kind
    decay = 1.0 - (step.to(torch.float32) + 1) ** -0.8
    out_p, out_f = [], []
    for p, g, f in zip(flat_p, flat_g,
                       TR.leaves_up_to(params, state["f"])):
        g = g.float() * scale
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            vr = decay * f["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * f["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=1e-30)
            vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            upd = g / (torch.sqrt(vhat) + cfg.eps)
            nf = {"vr": _put(f["vr"], vr, donate),
                  "vc": _put(f["vc"], vc, donate)}
        else:
            v = decay * f["v"] + (1 - decay) * g2
            upd = g / (torch.sqrt(v) + cfg.eps)
            nf = {"v": _put(f["v"], v, donate)}
        # relative step-size trust ratio
        pf = p.float()
        pn = torch.sqrt(torch.mean(torch.square(pf))) + 1e-3
        un = torch.sqrt(torch.mean(torch.square(upd))) + 1e-9
        new_p = (pf - lr * torch.clamp(pn / un, max=1.0) * (
            upd + cfg.weight_decay * pf)).to(p.dtype)
        out_p.append(_put(p, new_p, donate))
        out_f.append(nf)
    new_state = {"step": _put(state["step"], step, donate),
                 "f": TR.unflatten_like(params, out_f)}
    return TR.unflatten_like(params, out_p), new_state
