"""LS-PLM as a prediction head on a backbone's embedding.

The port's counterpart of ``repro/core/head.py``: the paper's
piecewise-linear mixture (Eq. 2) as a classification / CTR head on any
backbone embedding, e.g. a pooled hidden state of one of the zoo's LMs.
:func:`head_proba` runs on :func:`~repro_torch.core.lsplm.predict_proba`
(B5, the dense fused forward, on a CUDA input; it has no backward, so
the head is trained through :func:`head_nll`, which runs on the
differentiable :func:`~repro_torch.core.lsplm.predict_logits_stable`).
"""
from __future__ import annotations

import torch

from repro_torch.core.lsplm import (
    LSPLMParams,
    predict_logits_stable,
    predict_proba,
)


def init_head(generator: torch.Generator, embed_dim: int,
              num_regions: int = 12, scale: float = 2e-2,
              device=None) -> LSPLMParams:
    """u, w = scale * N(0, 1) of shape (embed_dim, num_regions), fp32,
    drawn from ``generator`` (u first) on its device and moved to
    ``device`` (the generator's when None). The reference draws from
    ``jax.random``; the numbers differ, the distribution is the same."""
    shape = (embed_dim, num_regions)

    def draw():
        return scale * torch.randn(shape, generator=generator,
                                   device=generator.device)

    u, w = draw(), draw()
    return LSPLMParams(u=u.to(device or generator.device),
                       w=w.to(device or generator.device))


def head_proba(params: LSPLMParams, h: torch.Tensor) -> torch.Tensor:
    """p(y=1 | h) for backbone features h (..., embed_dim)."""
    return predict_proba(params, h)


def head_nll(params: LSPLMParams, h: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """The mean NLL of labels y (...) under the head, in log space."""
    log_p1, log_p0 = predict_logits_stable(params, h)
    y = torch.as_tensor(y, device=log_p1.device).to(log_p1.dtype)
    return -torch.mean(y * log_p1 + (1.0 - y) * log_p0)
