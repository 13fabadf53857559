"""The Eq. 9 direction: kernel on the card, plain version on the CPU.

The port's counterpart of ``repro/kernels/owlqn_direction/ops.py``. A
CUDA Theta launches the hand-written kernel (``owlqn_direction.py``), a
CPU Theta takes ``ref.owlqn_direction_ref``; there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.owlqn_direction.owlqn_direction import (
    owlqn_direction,
)
from repro_torch.kernels.owlqn_direction.ref import owlqn_direction_ref


def direction(theta: torch.Tensor, grad: torch.Tensor, lam: float,
              beta: float) -> torch.Tensor:
    """d (d, 2m) of Eq. 9 on Theta's device."""
    if theta.ndim != 2 or grad.shape != theta.shape:
        raise ValueError(f"theta and grad must be one (d, 2m) shape, got "
                         f"{tuple(theta.shape)}/{tuple(grad.shape)}")
    if theta.device.type == "cuda":
        return owlqn_direction(theta, grad, lam, beta)
    if theta.device.type == "cpu":
        return owlqn_direction_ref(theta, grad, lam, beta)
    raise ValueError(f"unsupported device {theta.device}")
