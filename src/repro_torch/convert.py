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
    :class:`~repro_torch.models.transformer.Transformer`, for serving or
    (``trainable=True``) training;
  * :func:`params_to_reference` — the other way: a model's leaves as
    numpy arrays in the reference's layout.

On a mesh (``mesh=``) the model holds this rank's block of each leaf,
cut from the reference's full leaf by ``models.param_specs`` in the
layout of ``models/sharding.py``: the training layout (FSDP over
``data`` included) for a trainable model, the serving layout otherwise;
:func:`params_to_reference` gathers the blocks back exactly (a
collective: every rank calls it), so a model trained on one mesh
becomes a serving model on another by way of the reference's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.objective import CommonFeatureBatch
from repro_torch.configs.base import ArchConfig
from repro_torch.data.sparse import SparseCTRBatch, build_batch_plans
from repro_torch.device import resolve_device
from repro_torch.models import sharding as SH
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


def _leaves(block) -> dict:
    """{(group, name) or (name,): parameter} of one block."""
    out = {(name,): p for name, p in block.named_parameters(recurse=False)}
    for group, mod in block.named_children():
        out.update({(group, name): p for name, p in
                    mod.named_parameters(recurse=False)})
    return out


def _top_level(model: Transformer) -> dict:
    """{name: parameter} of the leaves outside ``layers`` and ``shared``."""
    want = {"embed": model.embed}
    if model.final_norm is not None:
        want["final_norm"] = model.final_norm
    if model.lm_head is not None:
        want["lm_head"] = model.lm_head
    return want


@torch.no_grad()
def model_from_reference(params: dict, cfg: ArchConfig,
                         device=None, trainable: bool = False,
                         mesh=None) -> Transformer:
    """The port's model on ``device`` (``cuda`` unless ``"cpu"``),
    trainable or not (``Transformer``), from the reference's parameters
    as numpy arrays: ``layers`` (each leaf stacked
    on a leading L axis: ``attn`` wq/wk/wv/wo and, with ``qkv_bias``,
    bq/bk/bv; ``ffn`` w1/(w3)/w2, or the MoE's router/w1/w3/w2;
    ``norm1``/``norm2`` with rmsnorm; for the ssm family ``mamba``
    in_proj/conv_w/conv_b/x_proj/dt_proj/dt_bias/A_log/D/out_proj and
    ``norm``, for the hybrid ``mamba`` in_proj/conv_w/conv_b/dt_bias/
    A_log/D/norm_scale/out_proj and ``norm``), ``embed``, ``final_norm``
    (rmsnorm), ``lm_head`` (untied) and the hybrid's ``shared`` block
    (``attn``, ``ffn``, ``norm1``/``norm2``, not stacked). Every leaf is
    copied into the parameter of the same name, in that parameter's dtype
    (for serving the matmul weights round to ``cfg.dtype`` once here, as
    the reference rounds them at every use; A_log, dt_bias, D, norm_scale
    and the norm scales stay in ``cfg.param_dtype``; a trainable model
    keeps every leaf in ``cfg.param_dtype``, fp32 leaves unrounded).
    With a ``mesh`` each parameter is this rank's block of the leaf
    (``Transformer.leaf_specs``: the training layout when ``trainable``,
    else the serving one). Raises ``ValueError`` on a missing,
    surplus or misshapen leaf."""
    model = Transformer(cfg, device=resolve_device(device),
                        trainable=trainable, mesh=mesh)
    cuts = model.leaf_specs() if SH.is_sharded(mesh) else None
    names = {id(p): name for name, p in model.named_parameters()}
    full = {name: tuple(p.shape) for name, p in Transformer(
        cfg, device="meta", trainable=trainable).named_parameters()}
    want = _top_level(model)
    got = {k for k in params if k != "layers"}
    if got != set(want) | ({"shared"} if model.shared is not None else set()):
        raise ValueError(f"expected top-level leaves {sorted(want)} + "
                         f"layers{' + shared' if model.shared is not None else ''}, got "
                         f"{sorted(params)}")

    def flat(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out.update({(key, k): v for k, v in value.items()})
            else:
                out[(key,)] = value
        return out

    def copy(param, array):
        array, name = np.asarray(array), names[id(param)]
        if tuple(array.shape) != full[name]:
            raise ValueError(f"shape {array.shape} for a parameter of "
                             f"shape {full[name]}")
        value = torch.from_numpy(np.array(array, dtype=np.float32))
        if cuts is not None:
            spec, parts = cuts[name]
            value = SH.local_block(value, spec, mesh, parts, name)
        param.copy_(value)

    def match(where, expected, arrays):
        if set(arrays) != set(expected):
            raise ValueError(f"expected {where} leaves {sorted(expected)}, "
                             f"got {sorted(arrays)}")

    stacked = {}
    for blk in model.layers:
        for key, p in _leaves(blk).items():
            stacked.setdefault(key, []).append(p)
    layers = flat(params["layers"])
    match("layer", stacked, layers)
    for name, param in want.items():
        copy(param, params[name])
    for key, per_layer in stacked.items():
        array = np.asarray(layers[key])
        if array.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{'/'.join(key)} has {array.shape[0]} "
                             f"layers, the config {cfg.num_layers}")
        for i, param in enumerate(per_layer):
            copy(param, array[i])
    if model.shared is not None:
        shared, arrays = _leaves(model.shared), flat(params["shared"])
        match("shared", shared, arrays)
        for key, param in shared.items():
            copy(param, arrays[key])
    return model


def params_to_reference(model: Transformer) -> dict:
    """The model's leaves as host numpy arrays in the reference's layout
    (``init_model``'s pytree): ``layers`` with each leaf stacked on a
    leading L axis, ``shared`` (the hybrid) unstacked, the top-level
    leaves as they are. The inverse of :func:`model_from_reference`: a
    trainable model's fp32 leaves come back bit for bit (bf16 serving
    weights come back widened to fp32, which is exact). A model cut for a
    mesh has its blocks gathered exactly over the model's own mesh on
    every rank, so every rank of the mesh must call it."""
    mesh = model.mesh
    cuts = model.leaf_specs() if SH.is_sharded(mesh) else None
    names = {id(p): name for name, p in model.named_parameters()}

    def array(p):
        if cuts is not None:
            spec, parts = cuts[names[id(p)]]
            p = SH.gather_block(p.detach(), spec, mesh, parts)
        return p.detach().to("cpu", torch.float32).numpy()

    def nest(flat: dict) -> dict:
        out: dict = {}
        for key, value in flat.items():
            if len(key) == 1:
                out[key[0]] = value
            else:
                out.setdefault(key[0], {})[key[1]] = value
        return out

    out = {name: array(p) for name, p in _top_level(model).items()}
    per_layer = [_leaves(blk) for blk in model.layers]
    out["layers"] = nest({key: np.stack([array(leaves[key])
                                         for leaves in per_layer])
                          for key in per_layer[0]})
    if model.shared is not None:
        out["shared"] = nest({key: array(p) for key, p in
                              _leaves(model.shared).items()})
    return out
