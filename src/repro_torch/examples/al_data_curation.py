"""The paper's technique as a framework feature: hash-indexed activation
store over an LM backbone, used for margin-based training-data curation
(active selection of the most informative examples for fine-tuning), on
the port.

    PYTHONPATH=src python -m repro_torch.examples.al_data_curation \
        [--device cuda]

The JAX package's ``examples/al_data_curation.py`` with its sizes as
defaults (the reduced qwen3-1.7b, 512 sequences of 24 tokens, one LBH
table of 16 bits).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import REDUCED
from repro_torch.core.indexer import ActivationIndexer, IndexConfig
from repro_torch.models import Transformer, forward, init_params, model_spec
from repro_torch.svm.linear_svm import train_svm
from repro_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--seq", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = REDUCED["qwen3-1.7b"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Transformer(cfg, init_params(model_spec(cfg), torch.float32,
                                         generator=gen, device=dev))

    @torch.inference_mode()
    def embed(tokens):
        _, _, aux = forward(cfg, model, {"tokens": tokens}, mode="train",
                            return_logits=False)
        return aux["normed"].mean(dim=1)         # pooled last hidden state

    # an unlabelled corpus of sequences; two latent "domains" (token ranges)
    rng = np.random.default_rng(args.seed)
    n, s = args.n, args.seq
    domain = rng.integers(0, 2, n)
    lo = np.where(domain == 0, 0, cfg.vocab_size // 2)
    corpus = rng.integers(0, cfg.vocab_size // 2, (n, s)) + lo[:, None]

    # 1) embed + index the pool with learned bilinear hashing (ONE table)
    indexer = ActivationIndexer(embed, IndexConfig(
        method="lbh", bits=16, radius=3, lbh_sample=256, lbh_steps=60),
        device=dev)
    index = indexer.build(torch.from_numpy(corpus).to(dev))
    print(f"indexed {n} sequences on {dev}; table: {index.table.stats()}")

    # 2) train a linear probe on a few labelled examples
    emb = indexer.embeddings.clone()
    labelled = rng.choice(n, 24, replace=False)
    y = torch.from_numpy(np.where(domain == 0, -1.0, 1.0).astype(
        np.float32)).to(dev)
    mask = torch.zeros(n, device=dev)
    mask[torch.from_numpy(labelled).to(dev)] = 1
    w = train_svm(torch.zeros(emb.shape[1], device=dev), emb, y, mask,
                  steps=200, lr=0.5)

    # 3) the probe's hyperplane IS the query: fetch the most informative
    #    (minimum-margin) unlabelled sequences via the hash index
    margins = ((emb @ w).abs() / torch.linalg.vector_norm(w)).cpu().numpy()
    picks = []
    for _ in range(8):
        i, m = index.query_scan(w, l=32)
        picks.append((i, m))
        emb[i] = 1e3                 # crude de-dup for the demo
        index.x = emb
    print("selected (idx, margin):", [(i, round(m, 4)) for i, m in picks])
    print(f"selected margin mean {np.mean([m for _, m in picks]):.4f} vs "
          f"pool mean {margins.mean():.4f} — curation picks boundary "
          f"examples")


if __name__ == "__main__":
    main()
