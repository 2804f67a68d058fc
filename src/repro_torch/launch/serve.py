"""Serving launcher: batched greedy decoding with the Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen3-1.7b]
        [--no-reduced] [--device cuda]

Reduced configs by default; ``--no-reduced`` runs the full architecture
(float32 weights from ``--seed``, random init).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import REDUCED, get_arch
from repro_torch.models.layers import init_params
from repro_torch.models.transformer import Transformer, model_spec
from repro_torch.serve.engine import Engine
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = REDUCED[args.arch] if args.reduced else get_arch(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} has a stub frontend")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Transformer(cfg, init_params(model_spec(cfg), torch.float32,
                                         generator=gen, device=dev))
    engine = Engine(cfg, model, max_len=args.prompt_len + args.gen,
                    device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen).cpu()
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"[serve] {cfg.name}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. first-call set-up) on {dev}")
    print("first row:", out[0, :16].tolist())


if __name__ == "__main__":
    main()
