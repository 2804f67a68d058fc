"""Batched serving example: prefill + greedy decode with KV caches on a
reduced-config zoo model, on the port.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        [--arch qwen2.5-3b] [--device cuda]

The flags of the JAX package's ``examples/serve_lm.py``, plus ``--device``
(default ``cuda``) and ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import REDUCED
from repro_torch.models.layers import init_params
from repro_torch.models.transformer import Transformer, model_spec
from repro_torch.serve.engine import Engine
from repro_torch.utils.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = REDUCED[args.arch]
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} has a stub frontend; pick a token arch")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Transformer(cfg, init_params(model_spec(cfg), torch.float32,
                                         generator=gen, device=dev))
    engine = Engine(cfg, model, max_len=args.prompt_len + args.gen,
                    device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    t0 = time.perf_counter()
    engine.generate(prompts, args.gen)
    _sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"{cfg.name}: batch={args.batch} gen={args.gen}")
    print(f"first call: {t_first:.2f}s; steady: {dt:.2f}s "
          f"= {toks / dt:.0f} tok/s on {dev}")
    print("sample:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
