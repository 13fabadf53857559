"""The dense Eq. 2 forward: kernel on the card, plain version on the CPU.

The port's counterpart of ``repro/kernels/lsplm_fused/ops.py``. A CUDA x
launches the hand-written kernel (``lsplm_fused.py``, B5), a CPU x takes
``ref.lsplm_forward_ref``; there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lsplm_fused.lsplm_fused import (
    check_inputs,
    lsplm_fused_forward,
)
from repro_torch.kernels.lsplm_fused.ref import lsplm_forward_ref


def lsplm_forward(x: torch.Tensor, u: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """p(y=1|x) (B,) in x's dtype, on x's device."""
    if x.device.type == "cuda":
        return lsplm_fused_forward(x, u, w)
    if x.device.type == "cpu":
        check_inputs("lsplm_forward", x, u, w)
        return lsplm_forward_ref(x, u, w)
    raise ValueError(f"unsupported device {x.device}")
