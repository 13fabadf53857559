"""Carry weights between the JAX package and the port.

Both packages keep the same flat-npz layout, so the crossing is arrays:

  * :func:`theta_from_numpy` — an unpadded (d, 2m) fp32 Theta as saved by
    ``repro.launch.train --ckpt`` (``{"theta": ...}``) -> a tensor;
  * :func:`artifact_from_numpy` / :func:`load_artifact` — a JAX-saved
    ``ServingArtifact`` / ``QuantizedArtifact`` (keys ``theta`` or
    ``codes`` + ``scales``, ``remap``, ``alive_ids``, ``num_features``)
    -> the port's artifact;
  * :func:`to_numpy` — the other way: a port artifact -> the dict of
    arrays ``repro.serve`` rebuilds its artifact from (and
    ``save_artifact`` writes a file ``repro.serve.load_artifact`` reads);
  * :func:`sparse_batch_from_numpy` — the arrays of a reference
    ``SparseCTRBatch`` -> the port's batch with its transpose plans;
  * :func:`common_feature_batch_from_numpy` — a reference (numpy)
    ``CommonFeatureBatch`` -> the port's batch of tensors;
  * :func:`model_from_reference` — the reference LM's parameter pytree
    (``repro.models.init_model``'s, as numpy arrays) -> the port's
    :class:`~repro_torch.models.transformer.Transformer`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.objective import CommonFeatureBatch
from repro_torch.configs.base import ArchConfig
from repro_torch.data.sparse import SparseCTRBatch, build_batch_plans
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.serve.compress import (  # noqa: F401
    QuantizedArtifact,
    ServingArtifact,
    artifact_from_numpy,
    load_artifact,
)


def theta_from_numpy(theta: np.ndarray, device) -> torch.Tensor:
    """An unpadded (d, 2m) fp32 Theta on ``device``."""
    theta = np.asarray(theta)
    if theta.ndim != 2 or theta.shape[1] % 2:
        raise ValueError(f"expected an unpadded (d, 2m) Theta, got "
                         f"{theta.shape}")
    if theta.dtype != np.float32:
        raise ValueError(f"expected a float32 Theta, got {theta.dtype}")
    return torch.from_numpy(np.ascontiguousarray(theta)).to(device)


def to_numpy(artifact: ServingArtifact | QuantizedArtifact) -> dict:
    """The artifact's fields as host numpy arrays (``num_features`` as an
    int), under the reference's field names."""
    return {f: (getattr(artifact, f) if f == "num_features"
                else getattr(artifact, f).detach().cpu().numpy())
            for f in artifact._fields}


def sparse_batch_from_numpy(fields: dict, num_features: int,
                            device) -> SparseCTRBatch:
    """A sparse batch from the arrays of a reference ``SparseCTRBatch``
    (``user_ids``, ``user_vals``, ``ad_ids``, ``ad_vals``, ``session_id``,
    ``y``, given as numpy arrays), on ``device``, with its transpose plans
    built on the host and moved there once."""
    dtypes = {"user_ids": torch.int32, "user_vals": torch.float32,
              "ad_ids": torch.int32, "ad_vals": torch.float32,
              "session_id": torch.int32, "y": torch.float32}
    missing = sorted(set(dtypes) - set(fields))
    if missing:
        raise ValueError(f"missing batch fields {missing}")
    batch = SparseCTRBatch(
        **{k: torch.from_numpy(np.ascontiguousarray(fields[k])).to(
            device=device, dtype=t) for k, t in dtypes.items()},
        num_features=int(num_features))
    return build_batch_plans(batch)


def common_feature_batch_from_numpy(batch, device) -> CommonFeatureBatch:
    """The port's ``CommonFeatureBatch`` on ``device`` from a reference
    one (its fields numpy arrays, or anything ``np.asarray`` takes):
    features, labels and weights as float32, session ids as int32."""
    def t(a, dtype):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(a))).to(device=device,
                                                    dtype=dtype)

    return CommonFeatureBatch(
        x_common=t(batch.x_common, torch.float32),
        x_noncommon=t(batch.x_noncommon, torch.float32),
        session_id=t(batch.session_id, torch.int32),
        y=t(batch.y, torch.float32), weight=t(batch.weight, torch.float32))


def model_from_reference(params: dict, cfg: ArchConfig,
                         device=None) -> Transformer:
    """The port's model on ``device`` (``cuda`` unless ``"cpu"``) from the
    reference's parameters as numpy arrays: ``layers`` (each leaf stacked
    on a leading L axis: ``attn`` wq/wk/wv/wo and, with ``qkv_bias``,
    bq/bk/bv; ``ffn`` w1/(w3)/w2; ``norm1``/``norm2`` with rmsnorm; for
    the ssm family ``mamba`` in_proj/conv_w/conv_b/x_proj/dt_proj/
    dt_bias/A_log/D/out_proj and ``norm``), ``embed``, ``final_norm``
    (rmsnorm) and ``lm_head`` (untied). Every leaf is copied into the
    parameter of the same name, in that parameter's dtype (the matmul
    weights round to ``cfg.dtype`` once here, as the reference rounds
    them at every use; A_log, dt_bias, D and the norm scales stay in
    ``cfg.param_dtype``). Raises ``ValueError`` on a missing, surplus or
    misshapen leaf."""
    model = Transformer(cfg, device=resolve_device(device))
    layers = params["layers"]
    want = {"embed": model.embed}
    if model.final_norm is not None:
        want["final_norm"] = model.final_norm
    if model.lm_head is not None:
        want["lm_head"] = model.lm_head
    stacked = {}
    for blk in model.layers:
        for group, mod in blk.named_children():
            for name, p in mod.named_parameters(recurse=False):
                stacked.setdefault((group, name), []).append(p)
        for name, p in blk.named_parameters(recurse=False):
            stacked.setdefault((name,), []).append(p)
    got = {k for k in params if k != "layers"}
    if got != set(want):
        raise ValueError(f"expected top-level leaves {sorted(want)} + "
                         f"layers, got {sorted(params)}")
    flat = {}
    for key, value in layers.items():
        if isinstance(value, dict):
            flat.update({(key, k): v for k, v in value.items()})
        else:
            flat[(key,)] = value
    if set(flat) != set(stacked):
        raise ValueError(f"expected layer leaves {sorted(stacked)}, got "
                         f"{sorted(flat)}")

    def copy(param, array):
        array = np.asarray(array)
        if tuple(array.shape) != tuple(param.shape):
            raise ValueError(f"shape {array.shape} for a parameter of "
                             f"shape {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(array, dtype=np.float32)))

    for name, param in want.items():
        copy(param, params[name])
    for key, per_layer in stacked.items():
        array = np.asarray(flat[key])
        if array.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{'/'.join(key)} has {array.shape[0]} "
                             f"layers, the config {cfg.num_layers}")
        for i, param in enumerate(per_layer):
            copy(param, array[i])
    return model
