"""Batched serving: prefill + single-token decode steps and a host-side
generation loop (used by ``launch.serve`` and ``examples.serve_lm``).

The steps run eagerly under ``torch.inference_mode``; the KV caches are
updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (Transformer, check_model,
                                            decode_step, forward)
from repro_torch.utils.device import resolve_device


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    """prefill(model, batch) -> (last-position logits (B, V), caches);
    batch as ``forward`` takes it (tokens, or embeds and M-RoPE
    streams)."""
    @torch.inference_mode()
    def prefill(model, batch):
        logits, caches, _ = forward(cfg, model, batch, mode="prefill",
                                    cache_len=cache_len)
        return logits[:, -1, :], caches
    return prefill


def make_serve_step(cfg: ArchConfig, *, sample: bool = False):
    """serve_step(model, caches, inputs, pos[, generator]) -> (next, caches).

    inputs: tokens (B,), or embeds (B, D) for the stub-front-end archs;
    pos: the position written this step (a Python int).  Greedy takes the argmax; sample=True draws each next token from
    the softmax of the float32 logits with ``torch.multinomial`` and the
    caller's ``torch.Generator`` (its draws cannot match
    ``jax.random.categorical``'s).
    """
    if sample:
        @torch.inference_mode()
        def serve_step(model, caches, inputs, pos, generator):
            logits, caches = decode_step(cfg, model, inputs, caches, pos)
            probs = torch.softmax(logits.to(torch.float32), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            return nxt, caches
        return serve_step

    @torch.inference_mode()
    def serve_step(model, caches, inputs, pos):
        logits, caches = decode_step(cfg, model, inputs, caches, pos)
        return torch.argmax(logits, dim=-1), caches
    return serve_step


class Engine:
    """Minimal batched-request engine for the runnable examples.

    The model moves to ``device`` (default the card; a missing card
    raises); prompts follow it.
    """

    def __init__(self, cfg: ArchConfig, model: Transformer,
                 max_len: int = 256, device="cuda"):
        check_model(cfg, model)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.max_len = max_len
        self.prefill_step = make_prefill_step(cfg, max_len)
        self.serve_step = make_serve_step(cfg)

    def generate(self, prompts, steps: int):
        """prompts: (B, S0) int tokens.  Greedy-decodes ``steps`` tokens;
        returns (B, steps) int64 on the engine's device."""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s0 = prompts.shape
        if s0 + steps - 1 > self.max_len:
            raise ValueError(f"{s0} prompt + {steps} generated tokens "
                             f"exceed max_len {self.max_len}")
        last_logits, caches = self.prefill_step(self.model,
                                                {"tokens": prompts})
        nxt = torch.argmax(last_logits, dim=-1)
        out = [nxt]
        for i in range(steps - 1):
            nxt, caches = self.serve_step(self.model, caches, nxt, s0 + i)
            out.append(nxt)
        return torch.stack(out, dim=1)
