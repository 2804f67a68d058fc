#!/usr/bin/env python3
"""The fp32 decode-vs-forward gate of ``chip_smoke.py`` at several depths
of one arch at full width, beside the model's own sensitivity, on one
card.

    python3 tools/decode_gate_depth.py [--arch musicgen-large]
        [--depths 2,8,24,48] [--seed 0]

For each depth (the first layers of the full-depth init from ``--seed``,
``chip_smoke.cut_tree``) and for float32 and float64 weights, on the
gate's inputs (``chip_smoke.lm_inputs``, B 2 x 128, prefilled half way):
the decode step against the teacher-forced logits
(``chip_smoke.decode_gate``), how far those logits move when the inputs
move by one float32 rounding (x (1 + 2^-23)), and the largest |hidden|.
A float64 model still computes its norms, rotary angles and attention
scores in float32, as the reference does.  Prints one line per depth and
dtype, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--depths", default="2,8,24,48")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_gate_depth: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import (Transformer, forward, init_params,
                                    model_spec)
    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    tree = init_params(model_spec(cfg), torch.float32, generator=g,
                       device=dev)
    batch = cs.lm_inputs(cfg, g, dev, 2, cs.GATE_S, gate=True)
    half = cs.GATE_S // 2
    for depth in (int(v) for v in args.depths.split(",")):
        cut, cut_tree = cs.cut_tree(cfg, tree, depth)
        for dt in (torch.float32, torch.float64):
            model = Transformer(cut, cut_tree, dtype=dt)
            b = {k: (v.to(dt) if v.is_floating_point() else v)
                 for k, v in batch.items()}
            err, _ = cs.decode_gate(cut, model, b, dev)
            key = "tokens" if "tokens" in b else "embeds"
            with strict_fp32(), torch.inference_mode():
                full, _, aux = forward(cut, model, b)
                if key == "embeds":
                    moved_in = dict(b, embeds=b["embeds"] * (1 + 2**-23))
                    moved = forward(cut, model, moved_in)[0]
                    move = cs.rel_err(moved[:, half], full[:, half])
                else:
                    move = float("nan")
            print(f"{args.arch} depth {depth} {str(dt).split('.')[-1]}: "
                  f"decode vs forward {err}; one-rounding move of the "
                  f"inputs {move}; max |hidden| "
                  f"{float(aux['hidden'].abs().max())}", flush=True)
            del model
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
