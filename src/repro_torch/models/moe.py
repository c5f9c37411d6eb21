"""Mixture-of-Experts with capacity-bounded dispatch and the optional
skew-aware heavy-expert path (DESIGN.md §2).

PyTorch twin of ``repro.models.moe``. The dispatch stays group-local:
each sequence ranks its own (token, k) slots against a capacity of
``C = max(int(capacity_factor * S * K / E), 1)`` slots per expert, as
the reference does per ``vmap`` group; here one vectorised pass covers
the whole batch. The expert products are plain ``torch.einsum`` /
``bmm``, as the reference computes them outside any kernel.

Three parity hazards shape the code:

- ``jax.lax.top_k`` keeps the lowest index among equal values and
  ``torch.topk`` does not, so the top k come from a stable descending
  sort (a uniform row of probabilities picks experts 0 .. K-1).
- The capacity rank is a cumulative count over the flattened (S*K)
  slots, token-major then k, so the dropped slots are the reference's.
- The reference scatters dropped slots out of bounds with
  ``mode="drop"``; here every slot is scattered, a kept one to its own
  (expert, rank) row of the flattened expert buffers and a dropped one
  to a dump row past them, which is cut off. The kept rows are unique,
  so what stays is deterministic, and no shape depends on the data (the
  dispatch runs on the meta device, for the dry-run).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import _gelu, silu


def moe_param_shapes(d: int, ff: int, E: int, mlp: str) -> dict:
    shapes = {"router": (d, E)}
    if mlp in ("swiglu", "geglu"):
        shapes["wi0"] = (E, d, ff)
        shapes["wi1"] = (E, d, ff)
    else:
        shapes["wi0"] = (E, d, ff)
    shapes["wo"] = (E, ff, d)
    return shapes


def _act(mlp: str):
    return silu if mlp == "swiglu" else _gelu


def _expert_mlp(mlp: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d) against stacked expert weights."""
    if mlp in ("swiglu", "geglu"):
        h = _act(mlp)(torch.einsum("ecd,edf->ecf", x, p["wi0"])) \
            * torch.einsum("ecd,edf->ecf", x, p["wi1"])
    elif mlp == "sq_relu":
        h = torch.relu(torch.einsum("ecd,edf->ecf", x, p["wi0"]))
        h = h * h
    else:
        h = _gelu(torch.einsum("ecd,edf->ecf", x, p["wi0"]))
    return torch.einsum("ecf,efd->ecd", h, p["wo"])


def _dense_single_expert(mlp: str, p: dict, x: torch.Tensor,
                         e_idx: torch.Tensor) -> torch.Tensor:
    """Apply one expert per sequence densely: x (B, S, d), e_idx (B,)
    -> (B, S, d), sequence b through expert e_idx[b]."""
    wi0, wo = p["wi0"][e_idx], p["wo"][e_idx]
    if mlp in ("swiglu", "geglu"):
        h = _act(mlp)(torch.bmm(x, wi0)) * torch.bmm(x, p["wi1"][e_idx])
    elif mlp == "sq_relu":
        h = torch.relu(torch.bmm(x, wi0))
        h = h * h
    else:
        h = _gelu(torch.bmm(x, wi0))
    return torch.bmm(h, wo)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, the lowest
    index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _heaviest(mass: torch.Tensor) -> torch.Tensor:
    """Each sequence's heaviest expert: the first maximum of its router
    mass (B, E), as ``jnp.argmax``."""
    return torch.argmax(mass, dim=-1)


def moe_apply(p: dict, x: torch.Tensor, *, mlp: str, num_experts: int,
              top_k: int, capacity_factor: float = 1.25,
              skew_aware: bool = True) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out, {"dropped_frac", "heavy_mass"}).

    With ``skew_aware``, each sequence's heaviest expert (the largest
    router mass) is applied densely to every token, weighted by its gate
    where it was picked, and takes no capacity slot. ``dropped_frac``
    is float64 (the reference's, whose int counts divide in float64),
    ``heavy_mass`` float32."""
    B, S, d = x.shape
    E, K = num_experts, top_k
    C = max(int(capacity_factor * S * K / E), 1)
    dev = x.device
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                 # (B, S, E)
    gate_vals, gate_idx = _top_k(probs, K)                # (B, S, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    heavy_out = torch.zeros_like(x)
    heavy_mass = torch.zeros((B,), dtype=torch.float32, device=dev)
    if skew_aware:
        mass = probs.sum(dim=1)                           # (B, E)
        heavy = _heaviest(mass)                           # (B,)
        dense = _dense_single_expert(mlp, p, x, heavy)
        is_heavy = gate_idx == heavy[:, None, None]
        w_heavy = torch.where(is_heavy, gate_vals, 0.0).sum(-1)
        heavy_out = dense * w_heavy[..., None].to(dense.dtype)
        gate_vals = torch.where(is_heavy, 0.0, gate_vals)
        heavy_mass = mass.gather(1, heavy[:, None])[:, 0] \
            / torch.clamp(mass.sum(-1), min=1e-9)

    flat_e = gate_idx.reshape(B, S * K)
    flat_w = gate_vals.reshape(B, S * K)
    active = flat_w > 0
    # the rank of each slot among its expert's slots, counted over the
    # (S*K) slots token-major; laid out (B, E, S*K), so that the count
    # runs along the inner dim
    onehot = (flat_e[:, None, :] == torch.arange(E, device=dev)[:, None]) \
        & active[:, None, :]                              # (B, E, S*K)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    rank = pos.gather(1, flat_e[:, None, :])[:, 0]
    keep = active & (rank < C)
    dropped = 1.0 - keep.sum(1).double() \
        / torch.clamp(active.sum(1), min=1).double()

    # each slot (b, token * K + k) to row expert * C + rank of the
    # flattened (E * C) buffers where it is kept, else to dump row E * C
    dest = torch.where(keep, flat_e * C + rank, E * C)
    idx = dest[..., None].expand(B, S * K, d)
    slots = x[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d)
    bufs = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=dev)
    bufs.scatter_(1, idx, slots)
    out_bufs = _expert_mlp_grouped(
        mlp, p, bufs[:, :E * C].reshape(B, E, C, d))       # (B, E, C, d)
    # back to the slots; the dump row, now zeros, gives the dropped ones 0
    gathered = F.pad(out_bufs.reshape(B, E * C, d), (0, 0, 0, 1)).gather(
        1, idx)
    weighted = gathered * flat_w[..., None].to(x.dtype)
    out = weighted.reshape(B, S, K, d).sum(2) + heavy_out
    # means as XLA computes the reference's: the sum times 1 / B
    metrics = {"dropped_frac": dropped.sum() * (1.0 / B),
               "heavy_mass": heavy_mass.sum() * (1.0 / B)}
    return out.to(x.dtype), metrics


def _expert_mlp_grouped(mlp: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, E, C, d) against stacked expert weights (E, d, f)."""
    B, E, C, d = x.shape
    out = _expert_mlp(mlp, p, x.transpose(0, 1).reshape(E, B * C, d))
    return out.reshape(E, B, C, d).transpose(0, 1)
