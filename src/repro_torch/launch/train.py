"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_7b \\
        --smoke --steps 20 --batch 4 --seq 128 --ckpt /tmp/run1

PyTorch twin of ``repro.launch.train``, with the reference's flags and
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels). The data comes from the nested corpus through the shredded
token query on the device (``data.pipeline.TokenPipeline``); the step is
``make_train_step`` with its parameters and optimizer state donated;
checkpoints are atomic and asynchronous, SIGTERM triggers a final save,
and rerunning the same command resumes from the latest one.
``--compress`` is parsed and not read, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.generators import gen_corpus
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer as T
from repro_torch.train import optim as O
from repro_torch.train.elastic import TrainState, Watchdog, run_resumable
from repro_torch.train.train_loop import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"),
                    help="checkpoint folder (default: repro_ckpt under TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--docs", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Runs the launcher; returns the logged losses, in step order."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params~{cfg.param_count():,}")

    # data: nested corpus -> shredded query engine -> token batches
    corpus = gen_corpus(n_docs=args.docs, vocab=cfg.vocab, seed=0)
    pipe = TokenPipeline(batch=args.batch, seq_len=args.seq,
                         device=dev).build(corpus)
    print(f"pipeline: {len(pipe.stream):,} tokens from "
          f"{args.docs} nested docs (query-engine ingest)")

    ocfg = O.OptConfig(kind=args.optimizer, lr=args.lr, warmup=20,
                       total_steps=args.steps)
    step_fn = make_train_step(cfg, ocfg, microbatches=args.microbatches,
                              donate=True)
    params = T.init_params(cfg, 0, device=dev)
    opt_state = O.init_state(ocfg, params)

    wd = Watchdog()
    wd.on_straggler = lambda s, dt, ew: print(
        f"  [watchdog] step {s}: {dt:.2f}s vs EWMA {ew:.2f}s")

    losses = []

    def log(step, metrics):
        losses.append(metrics["loss"])
        if step % 10 == 0 or step <= 3:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} dt {metrics['dt']:.2f}s")

    state = TrainState(params, opt_state, 0, None, 0)
    state = run_resumable(step_fn, state,
                          lambda cursor, _rng: pipe.batch_at(cursor),
                          n_steps=args.steps, ckpt_dir=args.ckpt,
                          ckpt_every=args.ckpt_every, watchdog=wd, log=log)
    if losses:
        print(f"done: step={state.step} first_loss={losses[0]:.4f} "
              f"last_loss={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
