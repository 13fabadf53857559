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
    ``CommonFeatureBatch`` -> the port's batch of tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.objective import CommonFeatureBatch
from repro_torch.data.sparse import SparseCTRBatch, build_batch_plans
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
