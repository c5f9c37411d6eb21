"""Elasticity and failure handling.

PyTorch twin of ``repro.train.elastic``:

  * ``Watchdog``      — EWMA step-time anomaly detector (straggler
                        alarm and hook);
  * ``run_resumable`` — crash-safe step loop: periodic async checkpoints,
                        a final save on SIGTERM, exact resume of the step
                        counter and the data cursor;
  * ``reshard_restore`` — restore a checkpoint onto other devices.

The run's random state is a ``torch.Generator`` where the reference
folds a ``jax.random`` key: on resume it is seeded from the saved seed
and the step. Batches are addressed by the data cursor, so a resumed run
sees the same data either way.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from . import checkpoint as CKPT


@dataclass
class Watchdog:
    """Flags steps slower than ``threshold`` x EWMA (stragglers)."""
    alpha: float = 0.1
    threshold: float = 2.0
    ewma: Optional[float] = None
    slow_steps: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.slow_steps += 1
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        # EWMA excludes anomalies so one straggler doesn't mask the next
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    rng_key: Any            # a torch.Generator
    data_cursor: int


RNG_SEED = 0


def _generator(seed: int, step: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed((seed * 1_000_003 + step) % 2 ** 63)
    return gen


def run_resumable(train_step: Callable, state: TrainState,
                  batch_fn: Callable[[int, Any], Any],
                  n_steps: int, ckpt_dir: str,
                  ckpt_every: int = 50,
                  watchdog: Optional[Watchdog] = None,
                  log: Optional[Callable[[int, dict], None]] = None
                  ) -> TrainState:
    """Crash-safe training loop. ``batch_fn(cursor, generator) -> batch``.
    Resumes from the latest complete checkpoint in ``ckpt_dir`` if any
    (overriding the passed-in state)."""
    ck = CKPT.AsyncCheckpointer(ckpt_dir)
    last = CKPT.latest_step(ckpt_dir)
    if last is not None:
        tree = {"params": state.params, "opt": state.opt_state}
        restored, manifest = CKPT.restore(ckpt_dir, last, template=tree)
        state.params = restored["params"]
        state.opt_state = restored["opt"]
        state.step = manifest["extra"]["step"]
        state.data_cursor = manifest["extra"]["data_cursor"]
        state.rng_key = _generator(manifest["extra"]["rng_seed"],
                                   state.step)
    if state.rng_key is None:
        state.rng_key = _generator(RNG_SEED, state.step)

    def checkpoint():
        ck.save(state.step, {"params": state.params,
                             "opt": state.opt_state},
                extra={"step": state.step,
                       "data_cursor": state.data_cursor,
                       "rng_seed": RNG_SEED})

    interrupted = {"flag": False}

    def on_sigterm(signum, frame):
        interrupted["flag"] = True

    old = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        while state.step < n_steps and not interrupted["flag"]:
            t0 = time.perf_counter()
            sub = _generator(int(torch.randint(
                0, 2 ** 31, (1,), generator=state.rng_key)), 0)
            batch = batch_fn(state.data_cursor, sub)
            state.params, state.opt_state, metrics = train_step(
                state.params, state.opt_state, batch)
            state.step += 1
            state.data_cursor += 1
            dt = time.perf_counter() - t0
            if watchdog is not None:
                watchdog.observe(state.step, dt)
            if log:
                log(state.step, {**{k: float(v)
                                    for k, v in metrics.items()},
                                 "dt": dt})
            if state.step % ckpt_every == 0:
                checkpoint()
    finally:
        signal.signal(signal.SIGTERM, old)
        # final (preemption-safe) checkpoint
        checkpoint()
        ck.wait()
    return state


def reshard_restore(ckpt_dir: str, template, new_shardings,
                    step: Optional[int] = None):
    """Restore onto other devices: ``new_shardings`` is a tree of devices
    (None: the template leaf's)."""
    return CKPT.restore(ckpt_dir, step, template=template,
                        shardings=new_shardings)
