"""Training launcher: AdamW, the prefetching loader, periodic
checkpoints, restart and the straggler monitor, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        [--reduced] [--steps 50] [--batch 8] [--seq 128] [--device cuda]

The flags of the JAX package's ``launch/train.py``, plus ``--device``
(``--ckpt-dir`` defaults to ``checkpoints`` under the working
directory).  Parameters are float32 from ``--seed`` (random init), as
the reference trains; the stub-front-end archs (qwen2-vl-7b,
musicgen-large) are refused, as there.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import REDUCED, get_arch
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.models.layers import init_params
from repro_torch.models.transformer import Transformer, model_spec
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def build(args):
    """(cfg, model, opt_cfg, opt_state, train_step, loader, trainer) for
    parsed ``args``: float32 parameters from ``--seed`` on ``--device``,
    warm-up 20 steps, a checkpoint every max(steps // 2, 10) steps."""
    dev = resolve_device(args.device)
    cfg = REDUCED[args.arch] if args.reduced else get_arch(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} has a stub frontend; use a token arch "
                         "for training")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Transformer(cfg, init_params(model_spec(cfg), torch.float32,
                                         generator=gen, device=dev),
                        trainable=True)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    opt_state = init_opt_state(model.tree(), opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg,
                              num_microbatches=args.microbatches,
                              remat=False, seed=args.seed)
    stream = SyntheticTokenStream(cfg.vocab_size, seed=args.seed)
    loader = ShardedLoader(stream, args.batch, args.seq, device=dev)
    trainer = Trainer(step_fn, model, opt_state, loader,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=max(args.steps // 2, 10),
                                    ckpt_dir=args.ckpt_dir))
    return cfg, model, opt_cfg, opt_state, step_fn, loader, trainer


def main(argv=None):
    args = parser().parse_args(argv)
    cfg, _, _, _, _, loader, trainer = build(args)
    try:
        if args.resume and trainer.maybe_restore():
            print(f"[train] restored step {trainer.step}")
        hist = trainer.run()
    finally:
        loader.close()
    losses = [h["loss"] for h in hist]
    print(f"[train] {cfg.name}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps; stragglers={trainer.monitor.flagged}")
    return trainer


if __name__ == "__main__":
    main()
