"""LS-PLM model (Gai et al. 2017, Eq. 1/2).

The port's counterpart of ``repro/core/lsplm.py``:

    p(y=1|x) = g( sum_j  sigma(u_j^T x) * eta(w_j^T x) )

with softmax dividing, sigmoid fitting and g = identity as the default
(Eq. 2, the production form). Parameters are ``LSPLMParams(u, w)``, each
(d, m): Theta = [u | w] in R^{d x 2m}, each feature row owning the 2m
parameters of one L2,1 group. :func:`params_from_theta` gives views of
one Theta, no copies.

:func:`predict_proba` in the Eq. 2 form runs on the dense fused forward
(``kernels/lsplm_fused``: B5 on a CUDA x, its plain version on a CPU x);
the generalised Eq. 1 forms (a ``cfg`` with identity functions) and the
NLL's log-space pieces stay plain PyTorch. The sparse forms go through
the serving layer (``repro_torch.serve.score``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.lsplm_fused.ops import lsplm_forward


class LSPLMParams(NamedTuple):
    """Model parameters. Both leaves have shape (d, m)."""

    u: torch.Tensor
    w: torch.Tensor

    @property
    def theta(self) -> torch.Tensor:
        """The paper's Theta in R^{d x 2m} (feature-row major)."""
        return torch.cat([self.u, self.w], dim=-1)


def params_from_theta(theta: torch.Tensor) -> LSPLMParams:
    m2 = theta.shape[-1]
    if m2 % 2:
        raise ValueError(f"Theta's last dim must be 2m, got {m2}")
    m = m2 // 2
    return LSPLMParams(u=theta[..., :m], w=theta[..., m:])


@dataclasses.dataclass(frozen=True)
class LSPLMConfig:
    num_features: int  # d
    num_regions: int = 12  # m, the paper's division number (Fig. 4: best 12)
    # generalised form hooks (Eq. 1): "softmax"/"sigmoid"/"identity"
    dividing: str = "softmax"
    fitting: str = "sigmoid"
    link: str = "identity"
    dtype: torch.dtype = torch.float32


def init_params(cfg: LSPLMConfig, generator: torch.Generator,
                scale: float = 1e-2, device=None) -> LSPLMParams:
    """u, w = scale * N(0, 1) of shape (d, m), drawn from ``generator``
    (u first). The reference draws from ``jax.random``; the numbers
    differ, the distribution is the same."""
    shape = (cfg.num_features, cfg.num_regions)
    u = scale * torch.randn(shape, generator=generator)
    w = scale * torch.randn(shape, generator=generator)
    return LSPLMParams(u=u.to(device=device, dtype=cfg.dtype),
                       w=w.to(device=device, dtype=cfg.dtype))


def _dividing_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "softmax":
        return lambda z: torch.softmax(z, dim=-1)
    if name == "identity":
        return lambda z: z
    raise ValueError(f"unknown dividing fn {name!r}")


def _fitting_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "sigmoid":
        return torch.sigmoid
    if name == "identity":
        return lambda z: z
    raise ValueError(f"unknown fitting fn {name!r}")


def region_logits(params: LSPLMParams, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x @ u, x @ w), each (..., m). The §3.2 hot spot."""
    return x @ params.u, x @ params.w


def _is_eq2(cfg: LSPLMConfig | None) -> bool:
    return cfg is None or (cfg.dividing, cfg.fitting, cfg.link) == (
        "softmax", "sigmoid", "identity")


def predict_proba(params: LSPLMParams, x: torch.Tensor,
                  cfg: LSPLMConfig | None = None) -> torch.Tensor:
    """p(y=1|x) per Eq. 2 (or the generalised Eq. 1 via cfg). x: (..., d).

    The Eq. 2 form runs on the dense fused forward (B5 on the card)."""
    if _is_eq2(cfg):
        lead, d = x.shape[:-1], x.shape[-1]
        p = lsplm_forward(x.reshape(-1, d), params.u, params.w)
        return p.reshape(lead)
    if cfg.link != "identity":
        raise ValueError(f"unknown link {cfg.link!r}")
    zu, zw = region_logits(params, x)
    gate = _dividing_fn(cfg.dividing)(zu)
    fit = _fitting_fn(cfg.fitting)(zw)
    return (gate * fit).sum(dim=-1)


def predict_logits_stable(params: LSPLMParams, x: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Numerically stable pieces for the NLL (Eq. 5), in log space:
        log p1 = logsumexp_i( log_softmax_i(zu) + log_sigmoid(zw_i) )
        log p0 = logsumexp_i( log_softmax_i(zu) + log_sigmoid(-zw_i) )
    """
    zu, zw = region_logits(params, x)
    log_gate = torch.log_softmax(zu, dim=-1)
    log_p1 = torch.logsumexp(log_gate + F.logsigmoid(zw), dim=-1)
    log_p0 = torch.logsumexp(log_gate + F.logsigmoid(-zw), dim=-1)
    return log_p1, log_p0


def predict_proba_sparse(params: LSPLMParams, ids, vals, *,
                         plan=None) -> torch.Tensor:
    """p(y=1|x) per Eq. 2 from padded-COO (ids, vals), pad id == d,
    through the serving layer (the fused sparse kernel). Pass ``plan``
    (``data.sparse``'s transpose plan of ``ids``) when the call will be
    differentiated, to keep the backward sort-free. Returns (N,)."""
    from repro_torch.serve.score import score_sparse

    return score_sparse(params, ids, vals, plan=plan)


def predict_logits_stable_sparse(params: LSPLMParams, ids, vals, *,
                                 plan=None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse analogue of :func:`predict_logits_stable`: (log_p1, log_p0)
    from the serving layer's region logits."""
    from repro_torch.serve.score import score_sparse_logps

    return score_sparse_logps(params, ids, vals, plan=plan)


def foe_mixture_proba(params: LSPLMParams, x: torch.Tensor) -> torch.Tensor:
    """Eq. 3 (FOE / mixed-LR view): sum_i p(z=i|x) p(y=1|z=i,x). Equal
    to :func:`predict_proba` by construction; an equivalence witness."""
    zu, zw = region_logits(params, x)
    return torch.einsum("...m,...m->...", torch.softmax(zu, dim=-1),
                        torch.sigmoid(zw))
