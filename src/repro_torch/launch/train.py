"""Training entry point: port of ``repro.launch.train``, with ``--device``
(default ``cuda``; without a card that raises, it never falls back to the
host). Params from the port's seeded init, batches from the seeded
synthetic stream (``train.data``), async checkpoints with an atomic LATEST,
``--resume`` from it.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --tiny 1 \\
      --steps 20 --ckpt-dir <dir>
  python -m repro_torch.launch.train --tiny 0 --batch 8 --seq 1024  # a card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch.serve import tiny_config
from repro_torch.models import ParamTree, get_model
from repro_torch.models.base import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.data import synthetic_batch, to_device
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainRun:
    losses: List[float]           # one a step run
    step_s: List[float]           # each step's seconds, device synchronised
    start: int                    # the first step run (the restored one)
    params: ParamTree
    opt_state: dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--tiny", type=int, default=1,
                    help="reduced config (CPU scale); 0 = full config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def opt_config(cfg, args) -> opt_mod.OptConfig:
    """The run's optimizer: the config's, the schedule over ``--steps``."""
    return opt_mod.OptConfig(name=cfg.optimizer, lr=args.lr, warmup_steps=5,
                             total_steps=args.steps)


def run(argv=None) -> TrainRun:
    """``main`` with what a caller measures: each step's seconds, and the
    params and optimizer state at the end."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    model = get_model(cfg)
    opt_cfg = opt_config(cfg, args)
    params = model.init(0, dev)
    opt_state = opt_mod.init_fn(cfg.optimizer)(params)

    start = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
            _, start = ckpt.restore((params, opt_state), args.ckpt_dir)
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(
        model, opt_cfg, microbatches=args.microbatches,
        compress_grads=bool(args.compress_grads))
    error_fb = None

    losses, step_s = [], []
    saved = None
    t0 = time.time()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = to_device(synthetic_batch(cfg, shape, step), dev)
        if args.compress_grads:
            params, opt_state, metrics, error_fb = step_fn(
                params, opt_state, batch, error_fb)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))       # waits for the step
        step_s.append(time.perf_counter() - ts)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if writer and (step + 1) % args.ckpt_every == 0:
            writer.save((params, opt_state), step + 1)
            saved = step + 1
    if writer:
        if saved != args.steps:     # the last step's state, once
            writer.save((params, opt_state), args.steps)
        writer.wait()
    dt = time.time() - t0
    print(f"[train] done: {args.steps - start} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return TrainRun(losses=losses, step_s=step_s, start=start, params=params,
                    opt_state=opt_state)


def main(argv=None) -> List[float]:
    return run(argv).losses


if __name__ == "__main__":
    main()
