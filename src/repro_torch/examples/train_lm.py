"""End-to-end training driver: train a reduced-config zoo model with the
full substrate (loader, AdamW, checkpointing, straggler monitor), then
prove that checkpoint / restart works, on the port.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--arch qwen3-1.7b] [--steps 200] [--device cuda]

The flags of the JAX package's ``examples/train_lm.py``, plus ``--device``
(default ``cuda``) and ``--seed``.  The checkpoints go to a temporary
directory removed at exit.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs.registry import REDUCED
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.models.layers import init_params, tree_map
from repro_torch.models.transformer import Transformer, model_spec
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = REDUCED[args.arch]
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} has a stub frontend; pick a token arch")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tree = init_params(model_spec(cfg), torch.float32, generator=gen,
                       device=dev)
    model = Transformer(cfg, tree, trainable=True)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                          moment_dtype=args.moment_dtype)
    opt_state = init_opt_state(model.tree(), opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, remat=False, seed=args.seed)

    stream = SyntheticTokenStream(cfg.vocab_size, seed=args.seed)
    loader = ShardedLoader(stream, args.batch, args.seq, device=dev)
    with tempfile.TemporaryDirectory(prefix="train_lm_ckpt_") as ckpt_dir:
        tcfg = TrainerConfig(total_steps=args.steps,
                             ckpt_every=args.steps // 2, ckpt_dir=ckpt_dir)
        try:
            trainer = Trainer(step_fn, model, opt_state, loader, tcfg)
            hist = trainer.run(args.steps // 2)          # first half
            print(f"[phase 1] loss {hist[0]['loss']:.3f} -> "
                  f"{hist[-1]['loss']:.3f}")

            # a failure and a restart from the checkpoint: a new model of
            # zeros and a fresh optimizer state take the checkpoint's
            fresh = Transformer(cfg, tree_map(torch.zeros_like, tree),
                                trainable=True)
            trainer2 = Trainer(step_fn, fresh,
                               init_opt_state(fresh.tree(), opt_cfg), loader,
                               tcfg)
            if not trainer2.maybe_restore():
                raise SystemExit("no checkpoint found")
            print(f"[restart] restored at step {trainer2.step}")
            hist2 = trainer2.run(args.steps - trainer2.step)
        finally:
            loader.close()
    print(f"[phase 2] loss {hist2[0]['loss']:.3f} -> {hist2[-1]['loss']:.3f} "
          f"(stragglers flagged: {trainer2.monitor.flagged})")
    if not hist2[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit("training did not improve")
    print("OK: loss improved across a checkpoint/restart boundary")


if __name__ == "__main__":
    main()
