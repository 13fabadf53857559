"""The inference layer: every LS-PLM prediction of the port goes through here.

The port's counterpart of ``repro/serve/score.py``. The model argument
is polymorphic:

  * a raw UNPADDED Theta ``(d, 2m)`` tensor or numpy array, or
    ``repro_torch.core.lsplm.LSPLMParams`` (a numpy array has no device:
    it goes to the card, as every entry point of the port does, unless
    the caller passes ``device="cpu"`` to :func:`as_model`),
  * a pruned :class:`~repro_torch.serve.compress.ServingArtifact`,
  * an int8 :class:`~repro_torch.serve.compress.QuantizedArtifact` —
    served INT8-NATIVE: the codes/scales are kept as they are and the
    sparse paths run the int8 gather ops, so fp32 rows are never
    materialised and the scores equal the dequantise-then-score numbers.
    The one exception is the DENSE path, which has no gather to fuse the
    scale into: it dequantises the rows per call (the reference's
    carve-out).

Request formats:

  * :func:`score_dense`    — dense ``x (..., d)`` rows, on the dense fused
    forward (B5 on the card): x against Theta without its pad row, or,
    for a pruned model, x restricted to the alive columns against the
    packed rows (a shorter reduction, so <= 1e-6 from full, not bitwise);
  * :func:`score_sparse`   — flat padded-COO ``(ids, vals)`` rows;
  * :func:`score_bundles`  — SESSION-SHARED scoring (Eq. 13, §3.2): each
    page view is one user id list + N ad candidates; the user half of
    Theta^T x is gathered ONCE per bundle and broadcast over its
    candidates (:func:`score_bundles_naive` is the per-ad baseline).

Requests stay in the ORIGINAL id space: ids are remapped to compact rows
by one gather through ``artifact.remap``, so pruned scoring is
bit-identical to full-Theta scoring. Scoring runs on the device the model
lies on (a tensor's own, the card for a numpy Theta); request tensors
are moved there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.lsplm import (
    LSPLMParams,
    params_from_theta,
    predict_proba,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.lsplm_sparse_fused.ops import (
    bundle_forward,
    finalize_p,
    logps_from_z,
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

    def dense_theta(self) -> torch.Tensor:
        """The padded fp32 rows: int8 models dequantise here (the dense
        path's carve-out; the sparse paths never call this)."""
        if self.is_int8:
            return self.codes.to(torch.float32) * self.scales[:, None]
        return self.theta


def _to(t, device):
    return None if t is None else t.to(device)


def as_model(model, device=None) -> ServingModel:
    """Coerce any accepted model form (see module docstring), moved to
    ``device`` when one is given; idempotent. Without ``device``, tensors
    stay where they are (the caller chose) and a numpy Theta goes to
    ``resolve_device(None)``: the card, raising without one."""
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
        if isinstance(model, LSPLMParams):
            model = model.theta
        if isinstance(model, torch.Tensor):
            theta = model
        else:
            theta = torch.from_numpy(np.asarray(model))
            device = resolve_device(device)
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
    return model.remap.index_select(0, ids.reshape(-1)).view(ids.shape)


def _vals(model: ServingModel, vals) -> torch.Tensor:
    return torch.as_tensor(vals, dtype=torch.float32, device=model.device)


def _check_plans(model: ServingModel, *plans) -> None:
    """Transpose plans address the full padded Theta: refuse them on a
    pruned (remapped) model, as the reference does."""
    if model.remap is not None and any(p is not None for p in plans):
        raise ValueError("transpose plans address the full Theta layout; "
                         "they cannot be combined with a pruned artifact")


def _z_sparse(model: ServingModel, ids, vals, *, dedup: bool, plan=None):
    """Region logits for flat padded-COO rows, routed by model dtype.
    int8 models are always remapped artifacts, so a plan never reaches
    their gather (``_check_plans`` refuses it first)."""
    if model.is_int8:
        return sparse_gather_matmul_int8(ids, vals, model.codes,
                                         model.scales, dedup=dedup)
    return sparse_gather_matmul(ids, vals, model.theta, dedup=dedup,
                                plan=plan)


def score_dense(model, x) -> torch.Tensor:
    """p(y=1|x) for dense rows x (..., d) through ``core.lsplm.
    predict_proba`` (the dense fused forward, B5 on the card), U and W
    the two halves of the model's rows, as views. Pruned models contract
    over the alive columns only (<= 1e-6 vs full); int8 models dequantise
    per call."""
    model = as_model(model)
    x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
    if x.shape[-1] != model.num_features:
        raise ValueError(f"x must have {model.num_features} columns, got "
                         f"{tuple(x.shape)}")
    if model.alive_ids is not None:
        x = x.index_select(-1, model.alive_ids.long())
    return predict_proba(params_from_theta(model.dense_theta()[:-1]), x)


def score_sparse(model, ids, vals, *, dedup: bool = True,
                 plan=None) -> torch.Tensor:
    """p(y=1|x) for flat padded-COO rows (N, K) on the fused kernel.

    ``plan`` (the full model's transpose plan of ``ids``) keeps a
    differentiated call's backward sort-free; p is the fused kernel's
    either way, so a planned call is bitwise the unplanned one. Plans
    cannot be combined with a pruned model."""
    model = as_model(model)
    _check_plans(model, plan)
    ids, vals = _request_ids(model, ids), _vals(model, vals)
    if model.is_int8:
        return lsplm_sparse_forward_int8(ids, vals, model.codes,
                                         model.scales, dedup=dedup)
    return lsplm_sparse_forward(ids, vals, model.theta, dedup=dedup,
                                plan=plan)


def score_sparse_logps(model, ids, vals, *, dedup: bool = True,
                       plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable (log_p1, log_p0) for flat padded-COO rows (the Eq. 5 head
    on the serving layer's region logits)."""
    model = as_model(model)
    _check_plans(model, plan)
    z = _z_sparse(model, _request_ids(model, ids), _vals(model, vals),
                  dedup=dedup, plan=plan)
    return logps_from_z(z)


def _bundle(model, bundle: ScoreBundle, dedup: bool, user_plan, ad_plan
            ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(p or None, z) of a bundle. A card model that nothing differentiates
    takes ``bundle_forward``: two kernel launches, the user rows' z added
    to each candidate's inside the ad-side launch and p from its head.
    With a gradient, or on the CPU, it is the composition: both sides'
    z, then ``z_user.index_select(0, session) + z_ad`` (p is None)."""
    model = as_model(model)
    _check_plans(model, user_plan, ad_plan)
    ui, uv = _request_ids(model, bundle.user_ids), _vals(model,
                                                         bundle.user_vals)
    ai, av = _request_ids(model, bundle.ad_ids), _vals(model, bundle.ad_vals)
    session = torch.as_tensor(bundle.session_id, device=model.device)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (model.theta, model.scales, uv, av))
    if model.device.type == "cuda" and not grad:
        return bundle_forward(ui, uv, ai, av, session, theta=model.theta,
                              codes=model.codes, scales=model.scales,
                              dedup=dedup)
    z_user = _z_sparse(model, ui, uv, dedup=dedup, plan=user_plan)
    z_ad = _z_sparse(model, ai, av, dedup=dedup, plan=ad_plan)
    return None, z_user.index_select(0, session.long()) + z_ad


def bundle_logits(model, bundle: ScoreBundle, *, dedup: bool = True,
                  user_plan=None, ad_plan=None) -> torch.Tensor:
    """Session-shared region logits z (B, 2m): the user contraction runs
    once per bundle (G rows), then broadcasts over candidates (Eq. 13).

    ``user_plan``/``ad_plan`` (the full model's transpose plans of the
    bundle's id tensors) keep a differentiated call's backward sort-free;
    they cannot be combined with a pruned model."""
    return _bundle(model, bundle, dedup, user_plan, ad_plan)[1]


def score_bundles(model, bundle: ScoreBundle, *, dedup: bool = True,
                  user_plan=None, ad_plan=None) -> torch.Tensor:
    """p(y=1|x) (B,) for session-grouped bundles — the serving hot path
    (two kernel launches a call on a card model without a gradient)."""
    p, z = _bundle(model, bundle, dedup, user_plan, ad_plan)
    return finalize_p(z) if p is None else p


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
    takes the shared path, an ``(ids, vals)`` pair the flat sparse one,
    and dense rows ``(..., d)`` (a tensor or an array) the dense one.
    A ``SparseCTRBatch``'s transpose plans are threaded through on a full
    model (a differentiated call keeps the sort-free backward) and
    dropped on a pruned artifact (inference only there)."""
    if hasattr(request, "user_ids") and hasattr(request, "session_id"):
        model = as_model(model)
        user_plan = getattr(request, "user_plan", None)
        ad_plan = getattr(request, "ad_plan", None)
        if model.remap is not None:
            user_plan = ad_plan = None
        return score_bundles(model, ScoreBundle(
            user_ids=request.user_ids, user_vals=request.user_vals,
            ad_ids=request.ad_ids, ad_vals=request.ad_vals,
            session_id=request.session_id), dedup=dedup,
            user_plan=user_plan, ad_plan=ad_plan)
    if isinstance(request, (tuple, list)) and len(request) == 2:
        ids, vals = request
        return score_sparse(model, ids, vals, dedup=dedup)
    return score_dense(model, request)
