"""Autoregressive generation driver over ``decode_step``.

The port's counterpart of ``repro/models/generate.py``: prefill the
prompt, then sample tokens with temperature / top-k, one
``decode_step`` per token. Sampling draws from an explicit
``torch.Generator`` (the reference splits a ``jax.random`` key: the
numbers differ; greedy decoding, temperature 0, is the same). It serves
every family the port runs: the attention families' KV caches (and the
window ring buffer) and the ssm family's conv and ssm states, which
prefill hands over at their decode shapes, so the copy below is a plain
copy for them.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import (
    Transformer,
    decode_step,
    init_caches,
    prefill,
)


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None = None,
                  temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32: the argmax at temperature <= 0,
    else a draw from softmax(logits / temperature) restricted to the
    ``top_k`` largest logits (all of them at 0)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(model: Transformer, prompt, max_new_tokens: int,
             generator: torch.Generator | None = None,
             temperature: float = 1.0, top_k: int = 0,
             window: bool = False) -> torch.Tensor:
    """prompt (B, S_prompt) token ids -> (B, max_new_tokens) int32
    continuations. ``window`` decodes into a ring buffer of
    ``cfg.sliding_window`` slots; a prompt longer than that keeps its
    prompt-length cache (as the reference does). ``generator`` (on the
    model's device) is needed unless temperature <= 0."""
    cfg = model.cfg
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "generate fills the decode caches from prefill's bf16 caches; "
            "an int8 cache is filled token by token with decode_step (the "
            "reference's generate has no int8 path either)")
    prompt = torch.as_tensor(prompt, device=model.device)
    B, S_p = prompt.shape
    cache_len = (min(cfg.sliding_window, S_p + max_new_tokens)
                 if window else S_p + max_new_tokens)

    logits, caches0 = prefill(model, tokens=prompt)
    caches = init_caches(cfg, B, cache_len, device=model.device)
    # copy the prefill caches into the (larger) decode buffers
    for name, small in caches0.items():
        big = caches[name]
        if big.shape[2] >= small.shape[2]:
            big[:, :, :small.shape[2]] = small.to(big.dtype)
        else:
            caches[name] = small.to(big.dtype)

    tok = sample_logits(logits, generator, temperature, top_k)
    outs = [tok]
    for i in range(max_new_tokens - 1):
        logits, caches = decode_step(model, caches, token=tok, pos=S_p + i,
                                     window=window)
        tok = sample_logits(logits, generator, temperature, top_k)
        outs.append(tok)
    return torch.stack(outs, dim=1)
