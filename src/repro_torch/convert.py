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
    ``save_artifact`` writes a file ``repro.serve.load_artifact`` reads).
"""
from __future__ import annotations

import numpy as np
import torch

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
