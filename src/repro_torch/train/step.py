"""Train-step factory: gradient accumulation over microbatches, remat,
AdamW.

The step runs eagerly on the model's device in strict float32 matmuls
(no TF32) and updates the model in place.  Gradients are taken of each
block's parameters (views of the stacked body, see
``models.transformer``) and stacked once into the JAX package's tree
layout (``Transformer.grad_tree``), the layout ``optim.adamw`` and the
checkpoints use.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.functions import strict_fp32
from repro_torch.models.transformer import Transformer, lm_loss
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     tree_leaves, tree_unflatten)


def split_microbatches(batch, n: int) -> list:
    """n microbatches of a batch: every leaf cut on its batch axis, the
    (3, B, S) M-RoPE streams on their second."""
    def cut(k, x):
        axis = 1 if k == "mrope_positions" else 0
        if x.shape[axis] % n:
            raise ValueError(f"{k}: batch of {x.shape[axis]} does not split "
                             f"into {n} microbatches")
        return torch.chunk(x, n, dim=axis)
    parts = {k: cut(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_grad_fn(cfg: ArchConfig, *, num_microbatches: int = 1,
                 remat: bool = True, accum_dtype=torch.float32):
    """grad_fn(model, batch) -> (loss, grads): the mean loss over the
    microbatches and its gradient in the JAX tree layout, each
    microbatch's gradient accumulated in accum_dtype and divided by their
    count, as the reference's ``jax.value_and_grad`` under its scan."""

    def grad_fn(model: Transformer, batch):
        params = list(model.parameters())
        loss_sum, acc = None, None
        parts = ([batch] if num_microbatches == 1 else
                 split_microbatches(batch, num_microbatches))
        for mb in parts:
            with torch.enable_grad():
                loss = lm_loss(cfg, model, mb, remat=remat)
                gs = torch.autograd.grad(loss, params, allow_unused=True,
                                         materialize_grads=True)
            by_param = {id(p): gp for p, gp in zip(params, gs)}
            del gs
            g = tree_leaves(model.grad_tree(by_param))
            loss = loss.detach()
            if num_microbatches == 1:
                return loss, tree_unflatten(model.spec, g)
            g = [x.to(accum_dtype) for x in g]
            acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = [a / num_microbatches for a in acc]
        return loss_sum / num_microbatches, tree_unflatten(model.spec, grads)

    return grad_fn


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    num_microbatches: int = 1, remat: bool = True,
                    accum_dtype=torch.float32, seed: int = 0):
    """train_step(model, opt_state, batch) -> (model, opt_state, metrics),
    the model and the state updated in place; metrics {"loss",
    "grad_norm", "lr"} as device tensors.  batch leaves have a leading
    global-batch dim (the M-RoPE streams their second); seed feeds int8
    moments' rounding draws (``adamw.apply_updates``)."""
    grad_fn = make_grad_fn(cfg, num_microbatches=num_microbatches,
                           remat=remat, accum_dtype=accum_dtype)

    def train_step(model: Transformer, opt_state, batch):
        with strict_fp32():
            loss, grads = grad_fn(model, batch)
            _, opt_state, metrics = apply_updates(
                model.tree(), grads, opt_state, opt_cfg, seed=seed)
        return model, opt_state, dict(metrics, loss=loss)

    return train_step
