"""The Mamba1 selective scan: kernel on the card, plain version on the
CPU.

The port's counterpart of ``repro/kernels/mamba_scan/ops.py``. A CUDA x
launches the hand-written kernel (``mamba_scan.py``, B7); a CPU x takes
the plain version; there is no fallback, and no knob: the device
decides. :func:`selective_scan` keeps the reference's contract (dt after
softplus in, the fp32 scan out). The model's Mamba1 layer calls
:func:`gated_selective_scan`, which also takes the softplus of dt, A =
-exp(A_log) and the silu(z) gate (B7's gated mode), for its
full-sequence scan and, at S = 1 from the carried state, for each decode
step (the reference's model runs its own ``lax.scan`` and jnp step
there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.mamba_scan import (
    check_gated_inputs,
    check_inputs,
    mamba1_scan,
    mamba1_scan_gated,
)
from repro_torch.kernels.mamba_scan.ref import mamba1_scan_ref


def plain_scan(dt, x, B_in, C_in, A, D, h0=None):
    """B7's plain version, on any device, with the kernel's contract: y
    (B, S, di) and hT (B, di, N) in fp32. x is widened before the scan,
    which is exact, so a bf16 x gives the fp32 scan of its values."""
    check_inputs("plain_scan", dt, x, B_in, C_in, A, D, h0)
    return mamba1_scan_ref(dt, x.to(torch.float32), B_in, C_in, A, D, h0)


def plain_gated_scan(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0=None):
    """The gated mode's plain version, on any device: the model's
    composition, dt = softplus(dt_raw + dt_bias) in fp32, A =
    -exp(A_log), :func:`plain_scan`, then y * silu(z) in fp32, rounded
    to x's dtype. Returns (y (B, S, di) in x's dtype, hT fp32)."""
    check_gated_inputs("plain_gated_scan", dt_raw, dt_bias, x, B_in, C_in,
                       A_log, D, z, h0)
    f32 = torch.float32
    dt = F.softplus(dt_raw.to(f32) + dt_bias)
    y, h = plain_scan(dt, x, B_in, C_in, -torch.exp(A_log), D, h0)
    return (y * F.silu(z.to(f32))).to(x.dtype), h


def selective_scan(dt, x, B_in, C_in, A, D, h0=None):
    """(y (B, S, di) fp32, hT (B, di, N) fp32) on x's device, from h0
    (zeros when None)."""
    if x.device.type == "cuda":
        return mamba1_scan(dt, x, B_in, C_in, A, D, h0)
    if x.device.type == "cpu":
        return plain_scan(dt, x, B_in, C_in, A, D, h0)
    raise ValueError(f"unsupported device {x.device}")


def gated_selective_scan(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z,
                         h0=None):
    """(silu(z) * the scan (B, S, di) in x's dtype, hT (B, di, N) fp32)
    on x's device, from h0 (zeros when None)."""
    args = (dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0)
    if x.device.type == "cuda":
        return mamba1_scan_gated(*args)
    if x.device.type == "cpu":
        return plain_gated_scan(*args)
    raise ValueError(f"unsupported device {x.device}")
