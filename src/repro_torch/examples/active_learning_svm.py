"""End-to-end driver: SVM active learning with hash-accelerated min-margin
selection (the paper's experiment, Figs. 3/4 structure), on the port.

    PYTHONPATH=src python -m repro_torch.examples.active_learning_svm \
        [--iters 40] [--device cuda]

The flags of the JAX package's ``examples/active_learning_svm.py``, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  One report line per selection method.
"""
from __future__ import annotations

import argparse

from repro_torch.data.synthetic import newsgroups_like
from repro_torch.svm.active import (ALConfig, make_selector,
                                    run_active_learning)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--d", type=int, default=600)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--methods", default="random,exhaustive,bh,lbh")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    corpus = newsgroups_like(n=args.n, d=args.d, classes=args.classes)
    cfg = ALConfig(iterations=args.iters, init_per_class=5, svm_steps=15,
                   eval_every=max(args.iters // 5, 1))
    print(f"corpus {corpus.x.shape}, {args.iters} AL iterations, "
          f"{corpus.num_classes} one-vs-all SVMs, device {args.device}\n")
    for m in args.methods.split(","):
        sel = make_selector(m, bits=16, radius=3, lbh_sample=400,
                            lbh_steps=80, eh_sample_dims=128,
                            device=args.device)
        res = run_active_learning(corpus, sel, cfg, device=args.device)
        total_q = args.iters * corpus.num_classes
        print(f"{m:11s} MAP {res.map_curve[0]:.3f} -> {res.map_curve[-1]:.3f}"
              f" | margin {res.min_margins.mean():.5f}"
              f" (optimal {res.exhaustive_margins.mean():.5f})"
              f" | nonempty lookups {int(res.nonempty.sum())}/{total_q}"
              f" | select {res.select_seconds:.1f}s")


if __name__ == "__main__":
    main()
