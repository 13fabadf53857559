"""The inference layer: every LS-PLM prediction of the port goes through here.

The port's counterpart of ``repro/serve/score.py`` (its sparse forms;
dense scoring arrives with the dense path). The model argument is
polymorphic:

  * a raw UNPADDED Theta ``(d, 2m)`` tensor or numpy array,
  * a pruned :class:`~repro_torch.serve.compress.ServingArtifact`,
  * an int8 :class:`~repro_torch.serve.compress.QuantizedArtifact` —
    served INT8-NATIVE: the codes/scales are kept as they are and the
    sparse paths run the int8 gather ops, so fp32 rows are never
    materialised and the scores equal the dequantise-then-score numbers.

Request formats:

  * :func:`score_sparse`   — flat padded-COO ``(ids, vals)`` rows;
  * :func:`score_bundles`  — SESSION-SHARED scoring (Eq. 13, §3.2): each
    page view is one user id list + N ad candidates; the user half of
    Theta^T x is gathered ONCE per bundle and broadcast over its
    candidates (:func:`score_bundles_naive` is the per-ad baseline).

Requests stay in the ORIGINAL id space: ids are remapped to compact rows
by one gather through ``artifact.remap``, so pruned scoring is
bit-identical to full-Theta scoring. Scoring runs on the device the model
lies on; request tensors are moved there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.lsplm_sparse_fused.ops import (
    finalize_p,
    lsplm_sparse_forward,
    lsplm_sparse_forward_int8,
    pad_theta,
    sparse_gather_matmul,
    sparse_gather_matmul_int8,
)
from repro_torch.serve.compress import QuantizedArtifact, ServingArtifact


class ScoreBundle(NamedTuple):
    """A batch of page-view bundles: G user rows, B = sum of candidates.
    Ids address the ORIGINAL feature space (pad id == d)."""

    user_ids: torch.Tensor  # (G, Ku) int32
    user_vals: torch.Tensor  # (G, Ku) float32
    ad_ids: torch.Tensor  # (B, Ka) int32
    ad_vals: torch.Tensor  # (B, Ka) float32
    session_id: torch.Tensor  # (B,) int64 in [0, G)


class ServingModel(NamedTuple):
    """Normalised model: kernel-ready rows + optional id remap. Exactly
    one of ``theta`` (fp32) or ``codes``/``scales`` (int8) is set."""

    theta: torch.Tensor | None  # (D, 2m) with the trailing zero pad row
    remap: torch.Tensor | None  # (d+1,) int32, None for full models
    alive_ids: torch.Tensor | None  # (R,) int32, None for full models
    num_features: int  # original d
    codes: torch.Tensor | None = None  # (D, 2m) int8, int8 models only
    scales: torch.Tensor | None = None  # (D,) fp32 row scales (pad row 0)

    @property
    def is_int8(self) -> bool:
        return self.codes is not None

    @property
    def device(self) -> torch.device:
        return (self.codes if self.is_int8 else self.theta).device


def _to(t, device):
    return None if t is None else t.to(device)


def as_model(model, device=None) -> ServingModel:
    """Coerce any accepted model form (see module docstring), moved to
    ``device`` when one is given; idempotent."""
    if isinstance(model, ServingModel):
        out = model
    elif isinstance(model, QuantizedArtifact):
        out = ServingModel(theta=None, remap=model.remap,
                           alive_ids=model.alive_ids,
                           num_features=model.num_features,
                           codes=model.codes, scales=model.scales)
    elif isinstance(model, ServingArtifact):
        out = ServingModel(theta=model.theta, remap=model.remap,
                           alive_ids=model.alive_ids,
                           num_features=model.num_features)
    else:
        theta = model if isinstance(model, torch.Tensor) else \
            torch.from_numpy(np.asarray(model))
        if theta.ndim != 2 or theta.shape[1] % 2:
            raise ValueError(f"expected an unpadded (d, 2m) Theta, got "
                             f"{tuple(theta.shape)}")
        if theta.dtype != torch.float32:
            raise ValueError(f"expected a float32 Theta, got {theta.dtype}")
        out = ServingModel(theta=pad_theta(theta), remap=None,
                           alive_ids=None, num_features=theta.shape[0])
    if device is None:
        return out
    return out._replace(theta=_to(out.theta, device),
                        remap=_to(out.remap, device),
                        alive_ids=_to(out.alive_ids, device),
                        codes=_to(out.codes, device),
                        scales=_to(out.scales, device))


def _request_ids(model: ServingModel, ids) -> torch.Tensor:
    """Original-space ids -> kernel ids (compact for pruned models), on
    the model's device."""
    ids = torch.as_tensor(ids, device=model.device)
    if model.remap is None:
        return ids.to(torch.int32)
    return model.remap.index_select(0, ids.reshape(-1).long()).view(ids.shape)


def _vals(model: ServingModel, vals) -> torch.Tensor:
    return torch.as_tensor(vals, dtype=torch.float32, device=model.device)


def _z_sparse(model: ServingModel, ids, vals, *, dedup: bool):
    """Region logits for flat padded-COO rows, routed by model dtype."""
    if model.is_int8:
        return sparse_gather_matmul_int8(ids, vals, model.codes,
                                         model.scales, dedup=dedup)
    return sparse_gather_matmul(ids, vals, model.theta, dedup=dedup)


def score_sparse(model, ids, vals, *, dedup: bool = True) -> torch.Tensor:
    """p(y=1|x) for flat padded-COO rows (N, K) on the fused kernel."""
    model = as_model(model)
    ids, vals = _request_ids(model, ids), _vals(model, vals)
    if model.is_int8:
        return lsplm_sparse_forward_int8(ids, vals, model.codes,
                                         model.scales, dedup=dedup)
    return lsplm_sparse_forward(ids, vals, model.theta, dedup=dedup)


def bundle_logits(model, bundle: ScoreBundle, *,
                  dedup: bool = True) -> torch.Tensor:
    """Session-shared region logits z (B, 2m): the user contraction runs
    once per bundle (G rows), then broadcasts over candidates (Eq. 13)."""
    model = as_model(model)
    z_user = _z_sparse(model, _request_ids(model, bundle.user_ids),
                       _vals(model, bundle.user_vals), dedup=dedup)
    z_ad = _z_sparse(model, _request_ids(model, bundle.ad_ids),
                     _vals(model, bundle.ad_vals), dedup=dedup)
    session = torch.as_tensor(bundle.session_id, device=model.device).long()
    return z_user.index_select(0, session) + z_ad


def score_bundles(model, bundle: ScoreBundle, *,
                  dedup: bool = True) -> torch.Tensor:
    """p(y=1|x) (B,) for session-grouped bundles — the serving hot path."""
    return finalize_p(bundle_logits(model, bundle, dedup=dedup))


def score_bundles_naive(model, bundle: ScoreBundle, *,
                        dedup: bool = True) -> torch.Tensor:
    """The un-shared baseline: every candidate re-carries its bundle's
    user ids, so the user gathers run N times per page view. Identical
    scores up to fp reassociation of the longer per-row sum."""
    session = torch.as_tensor(bundle.session_id).long()
    user_ids = torch.as_tensor(bundle.user_ids)
    user_vals = torch.as_tensor(bundle.user_vals)
    session = session.to(user_ids.device)
    ids = torch.cat([user_ids.index_select(0, session),
                     torch.as_tensor(bundle.ad_ids).to(user_ids.device)], -1)
    vals = torch.cat([user_vals.index_select(0, session),
                      torch.as_tensor(bundle.ad_vals).to(user_ids.device)],
                     -1)
    return score_sparse(model, ids, vals, dedup=dedup)


def predict(model, request, *, dedup: bool = True) -> torch.Tensor:
    """Unified entry, dispatching on the request's structure: a
    session-grouped bundle (has ``user_ids``/``ad_ids``/``session_id``)
    takes the shared path, an ``(ids, vals)`` pair the flat sparse one.
    Dense rows are not served by the port yet."""
    if hasattr(request, "user_ids") and hasattr(request, "session_id"):
        return score_bundles(model, ScoreBundle(
            user_ids=request.user_ids, user_vals=request.user_vals,
            ad_ids=request.ad_ids, ad_vals=request.ad_vals,
            session_id=request.session_id), dedup=dedup)
    if isinstance(request, (tuple, list)) and len(request) == 2:
        ids, vals = request
        return score_sparse(model, ids, vals, dedup=dedup)
    raise TypeError("predict takes a session bundle or an (ids, vals) pair; "
                    "dense scoring arrives with the port's dense path")
