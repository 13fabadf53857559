"""Pruned serving artifacts — the deployable form of a trained Theta.

The port's counterpart of ``repro/serve/compress.py``, in the same npz
format (a file saved by either package loads in the other).

The L1/L2,1 regularisers (Eq. 4) drive whole FEATURE ROWS of Theta to
exact zero, and the paper's deploy ships only the surviving rows (§4,
Table 2: ~2% nonzero). :func:`compress` packs a trained (d, 2m) Theta
into a :class:`ServingArtifact`:

  * ``theta``      (R+1, 2m) — the R surviving rows plus the trailing zero
                   pad row the sparse kernels require (compact pad id R);
  * ``remap``      (d+1,) int32 — old feature id -> compact row; dropped
                   ids AND the old pad id (== d) map to the pad row R;
  * ``alive_ids``  (R,) int32 — the original ids of the packed rows.

Scoring a pruned artifact is BIT-IDENTICAL to scoring the full Theta on
the sparse paths: the gathered rows are the same numbers, dropped ids
land on the zero pad row, and each sample's contraction keeps its slot
order. :func:`quantize` packs the rows into a :class:`QuantizedArtifact`
(int8 codes + one fp32 scale per row behind the same remap): each entry
moves by at most ``max|row| / 254``; the scorers serve it int8-NATIVE.

Artifacts are computed on the host with numpy (the same arithmetic as the
reference, so codes and scales come out equal) and returned on the device
the input lives on (numpy input -> CPU tensors).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.io import checkpoint


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


class ServingArtifact(NamedTuple):
    """A pruned, serving-ready LS-PLM model (see module docstring)."""

    theta: torch.Tensor  # (R+1, 2m) packed alive rows + zero pad row
    remap: torch.Tensor  # (d+1,) int32 old id -> compact row (dropped -> R)
    alive_ids: torch.Tensor  # (R,) int32 original ids of the packed rows
    num_features: int  # d of the full model

    @property
    def num_alive(self) -> int:
        return self.theta.shape[0] - 1

    @property
    def num_regions(self) -> int:
        return self.theta.shape[1] // 2

    @property
    def pad_id(self) -> int:
        return self.theta.shape[0] - 1

    @property
    def compression(self) -> float:
        """Deployed/full row ratio (1.0 = nothing pruned)."""
        return self.num_alive / max(self.num_features, 1)


class QuantizedArtifact(NamedTuple):
    """An int8-quantised pruned model: int8 codes + one fp32 scale per
    row, same remap/alive_ids, bounded-error scoring."""

    codes: torch.Tensor  # (R+1, 2m) int8 — row i fp32 ≈ codes[i] * scales[i]
    scales: torch.Tensor  # (R+1,) fp32 per-row scale; pad row scale == 0
    remap: torch.Tensor  # (d+1,) int32 old id -> compact row (dropped -> R)
    alive_ids: torch.Tensor  # (R,) int32 original ids of the packed rows
    num_features: int  # d of the full model

    @property
    def num_alive(self) -> int:
        return self.codes.shape[0] - 1

    @property
    def num_regions(self) -> int:
        return self.codes.shape[1] // 2

    @property
    def deployed_bytes(self) -> int:
        """Wire size of the model payload (codes + scales + remap +
        alive_ids)."""
        return (self.codes.numel() + self.scales.numel() * 4
                + self.remap.numel() * 4 + self.alive_ids.numel() * 4)


def compress(theta, *, threshold: float = 0.0) -> ServingArtifact:
    """Pack a trained UNPADDED Theta (d, 2m) into a pruned artifact.

    A row survives when ``max(|row|) > threshold``; the default 0.0 drops
    exactly the all-zero rows, which keeps pruned scoring bit-identical.
    ``threshold > 0`` also drops near-zero rows (lossy)."""
    th = _host(theta)
    if th.ndim != 2 or th.shape[1] % 2:
        raise ValueError(f"expected an unpadded (d, 2m) Theta, got {th.shape}")
    d = th.shape[0]
    alive = np.abs(th).max(axis=1) > threshold
    alive_ids = np.flatnonzero(alive).astype(np.int32)
    r = alive_ids.size
    remap = np.full(d + 1, r, np.int32)  # dropped ids AND old pad id -> pad row
    remap[alive_ids] = np.arange(r, dtype=np.int32)
    packed = np.concatenate([th[alive_ids],
                             np.zeros((1, th.shape[1]), th.dtype)])
    dev = _device_of(theta)
    return ServingArtifact(theta=torch.from_numpy(packed).to(dev),
                           remap=torch.from_numpy(remap).to(dev),
                           alive_ids=torch.from_numpy(alive_ids).to(dev),
                           num_features=d)


def quantize(artifact: ServingArtifact) -> QuantizedArtifact:
    """Symmetric per-row int8 quantisation of a pruned artifact:
    ``scale = max|row| / 127``, ``codes = round(row / scale)``. The
    all-zero pad row gets scale 0 and stays exactly zero."""
    th = _host(artifact.theta)
    amax = np.abs(th).max(axis=1)
    scales = (amax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)  # avoid 0/0 on the pad row
    codes = np.rint(th / safe[:, None]).astype(np.int8)
    dev = _device_of(artifact.theta)
    return QuantizedArtifact(codes=torch.from_numpy(codes).to(dev),
                             scales=torch.from_numpy(scales).to(dev),
                             remap=artifact.remap,
                             alive_ids=artifact.alive_ids,
                             num_features=artifact.num_features)


def dequantize(quant: QuantizedArtifact) -> ServingArtifact:
    """The fp32 artifact an int8 one stands for (``codes * scales``)."""
    theta = quant.codes.to(torch.float32) * quant.scales[:, None]
    return ServingArtifact(theta=theta, remap=quant.remap,
                           alive_ids=quant.alive_ids,
                           num_features=quant.num_features)


def save_artifact(path: str,
                  artifact: ServingArtifact | QuantizedArtifact) -> str:
    """Write either artifact form as a flat npz (the reference's keys).
    Returns the real path written (``.npz`` appended when missing)."""
    return checkpoint.save(path, artifact)


def artifact_from_numpy(data: dict, device=None
                        ) -> ServingArtifact | QuantizedArtifact:
    """Rebuild an artifact from its arrays (``theta`` or ``codes`` +
    ``scales``, ``remap``, ``alive_ids``, ``num_features``) — the form a
    JAX-saved artifact file loads as. Tensors land on ``device``
    (default: the CPU)."""
    cls = QuantizedArtifact if "codes" in data else ServingArtifact
    missing = [f for f in cls._fields if f not in data]
    if missing:
        raise ValueError(f"not a serving artifact: missing fields {missing}")
    dev = torch.device("cpu") if device is None else torch.device(device)
    tensors = {f: torch.from_numpy(np.ascontiguousarray(data[f])).to(dev)
               for f in cls._fields if f != "num_features"}
    return cls(num_features=int(np.asarray(data["num_features"]).item()),
               **tensors)


def load_artifact(path: str, device=None
                  ) -> ServingArtifact | QuantizedArtifact:
    """Load an artifact saved by either package's ``save_artifact``; the
    npz field names pick the form. Tensors land on ``device``."""
    data = checkpoint.load_nested(path)
    try:
        return artifact_from_numpy(data, device)
    except ValueError as e:
        raise ValueError(f"{path!r}: {e}") from None
