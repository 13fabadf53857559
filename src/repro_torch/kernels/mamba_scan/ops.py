"""The Mamba1 selective scan: kernel on the card, plain version on the
CPU.

The port's counterpart of ``repro/kernels/mamba_scan/ops.py``. A CUDA x
launches the hand-written kernel (``mamba_scan.py``, B7); a CPU x takes
:func:`plain_scan`; there is no fallback, and no knob: the device
decides. The model's Mamba1 layer calls :func:`selective_scan` for its
full-sequence scan and, at S = 1 from the carried state, for each decode
step (the reference's model runs its own ``lax.scan`` and jnp step
there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.mamba_scan import check_inputs, mamba1_scan
from repro_torch.kernels.mamba_scan.ref import mamba1_scan_ref


def plain_scan(dt, x, B_in, C_in, A, D, h0=None):
    """B7's plain version, on any device, with the kernel's contract: y
    (B, S, di) and hT (B, di, N) in fp32. x is widened before the scan,
    which is exact, so a bf16 x gives the fp32 scan of its values."""
    check_inputs("plain_scan", dt, x, B_in, C_in, A, D, h0)
    return mamba1_scan_ref(dt, x.to(torch.float32), B_in, C_in, A, D, h0)


def selective_scan(dt, x, B_in, C_in, A, D, h0=None):
    """(y (B, S, di) fp32, hT (B, di, N) fp32) on x's device, from h0
    (zeros when None)."""
    if x.device.type == "cuda":
        return mamba1_scan(dt, x, B_in, C_in, A, D, h0)
    if x.device.type == "cpu":
        return plain_scan(dt, x, B_in, C_in, A, D, h0)
    raise ValueError(f"unsupported device {x.device}")
