"""Autoregressive generation driver over ``decode_step``.

The port's counterpart of ``repro/models/generate.py``: prefill the
prompt, then sample tokens with temperature / top-k, one
``decode_step`` per token. Sampling draws from an explicit
``torch.Generator`` (the reference splits a ``jax.random`` key: the
numbers differ; greedy decoding, temperature 0, is the same). It serves
every family: the KV caches (L, B, S, ...) of the attention and MoE
families and the hybrid's (J, B, S, ...) by group, all with the window
ring buffer, are copied into the first S positions of the decode
buffers (axis 2); the conv and ssm states of the ssm and hybrid
families, which prefill hands over at their decode shapes, are plain
copies.

On a mesh every rank runs ``generate`` on the same global prompt: it
prefills and decodes its own rows (its data shard's with
``batch_sharded``) against its blocks, and the tokens are gathered over
``data`` at the end, so every rank returns the same (B, T) tokens. The
logits a rank samples from are the same bits on every rank of its data
shard, so greedy decoding, or one generator per rank seeded alike,
decodes the same tokens there.
"""
from __future__ import annotations

import torch

from repro_torch.models import sharding as SH
from repro_torch.models.transformer import (
    Transformer,
    placement,
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
def fill_caches(caches: dict, prefilled: dict) -> dict:
    """Copy prefill's caches into :func:`init_caches`' decode buffers, in
    their dtype: the KV caches into their first S positions (axis 2), the
    conv and ssm states (and a prompt longer than a window's buffer)
    whole. Returns ``caches``."""
    for name, small in prefilled.items():
        big = caches[name]
        if big.shape[2] >= small.shape[2]:
            big[:, :, :small.shape[2]] = small.to(big.dtype)
        else:
            caches[name] = small.to(big.dtype)
    return caches


@torch.no_grad()
def generate(model: Transformer, prompt, max_new_tokens: int,
             generator: torch.Generator | None = None,
             temperature: float = 1.0, top_k: int = 0,
             window: bool = False, mesh=None, batch_sharded: bool = True,
             moe_serving_mode: str = "weight_gather") -> torch.Tensor:
    """prompt (B, S_prompt) token ids -> (B, max_new_tokens) int32
    continuations. ``window`` decodes into a ring buffer of
    ``cfg.sliding_window`` slots; a prompt longer than that keeps its
    prompt-length cache (as the reference does). ``generator`` (on the
    model's device) is needed unless temperature <= 0. On a mesh
    (the model's own; ``mesh=`` may only restate it,
    ``transformer.placement``) the prompt is the global batch on every
    rank and so are the tokens returned (the module docstring);
    ``moe_serving_mode`` picks the MoE's plan for prefill and decode."""
    cfg = model.cfg
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "generate fills the decode caches from prefill's bf16 caches; "
            "an int8 cache is filled token by token with decode_step (the "
            "reference's generate has no int8 path either)")
    at = placement(model, mesh, batch_sharded, moe_serving_mode)
    prompt = torch.as_tensor(prompt, device=model.device)
    B, S_p = prompt.shape
    cache_len = (min(cfg.sliding_window, S_p + max_new_tokens)
                 if window else S_p + max_new_tokens)

    logits, caches0 = prefill(model, tokens=SH.batch_rows(
        prompt, at.mesh, batch_sharded), **at._asdict())
    caches = fill_caches(init_caches(cfg, B, cache_len, device=model.device,
                                     mesh=at.mesh,
                                     batch_sharded=batch_sharded), caches0)

    tok = sample_logits(logits, generator, temperature, top_k)
    outs = [tok]
    for i in range(max_new_tokens - 1):
        logits, caches = decode_step(model, caches, token=tok, pos=S_p + i,
                                     window=window, **at._asdict())
        tok = sample_logits(logits, generator, temperature, top_k)
        outs.append(tok)
    out = torch.stack(outs, dim=1)
    if at.mesh is not None and batch_sharded:
        out = at.mesh.gather(out, "data", 0)
    return out
