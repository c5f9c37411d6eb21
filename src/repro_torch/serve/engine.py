"""Batched serving engine: prefill + KV-cache decode loop.

PyTorch twin of ``repro.serve.engine``, with its loop unchanged:
prompts are padded on the right with token 0 to the longest prompt, the
caches are populated by stepping every request through all
``max_prompt`` positions with the decode step (teacher-forced), then
the decode loop picks greedily until each request's ``max_new_tokens``
or its EOS. A shorter prompt's cache therefore also holds the padding
tokens, and its first new token is predicted after them: the
reference's behaviour, kept (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..columnar.table import resolve_device
from ..models import transformer as T
from ..models.config import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    eos: Optional[int] = None


class ServeEngine:
    """``params`` must lie on ``device`` (None means the GPU)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 greedy: bool = True, device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.greedy = greedy
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"ServeEngine: params on "
                             f"{params['embed'].device}, engine on "
                             f"{self.device}")

    def _step(self, caches, tokens: np.ndarray, pos: int):
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=self.device)
        return T.decode_step(self.cfg, self.params, caches, tok, pos)

    def generate(self, requests: List[Request]) -> List[List[int]]:
        cfg = self.cfg
        B = len(requests)
        caches = T.init_cache(cfg, B, self.max_len, device=self.device)
        max_prompt = max(len(r.prompt) for r in requests)
        toks = np.zeros((B, max_prompt), np.int32)
        for i, r in enumerate(requests):
            toks[i, :len(r.prompt)] = r.prompt
        # prefill by stepping the decode path (cache population)
        logits = None
        for t in range(max_prompt):
            logits, caches = self._step(caches, toks[:, t], t)
        outs: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        cur = self._pick(logits)
        max_new = max(r.max_new_tokens for r in requests)
        for k in range(max_new):
            pos = max_prompt + k
            if pos >= self.max_len:
                break
            for i, r in enumerate(requests):
                if done[i] or k >= r.max_new_tokens:
                    done[i] = True
                    continue
                tok = int(cur[i])
                if r.eos is not None and tok == r.eos:
                    done[i] = True
                    continue
                outs[i].append(tok)
            if done.all():
                break
            logits, caches = self._step(caches, cur, pos)
            cur = self._pick(logits)
        return outs

    def _pick(self, logits) -> np.ndarray:
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        raise NotImplementedError("sampling: plug in your policy")
