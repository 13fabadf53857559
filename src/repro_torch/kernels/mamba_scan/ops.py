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

On the card, :func:`gated_selective_scan` goes through a
``torch.autograd.Function``: B7's gated mode computes the forward, and
the backward is :func:`gated_scan_backward_plain`, autograd of
:func:`plain_gated_scan` recomputed from the saved inputs. The reference
has no backward kernel (its Pallas call defines no VJP, and its model
trains through its own ``lax.scan``), so this is the gradient the
reference takes. Its cost is the plain scan's: a loop over time of a
few small ops a step, forward and backward, and (B, S, di, N) fp32 of
saved states. It serves training at reduced sizes; falcon-mamba-7b does
not train at full width on one card in any case (fp32 AdamW needs ~116
GB for its 7.27e9 parameters).
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


def gated_scan_backward_plain(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z,
                              h0, dy, dhT, needs=None):
    """The gradients of :func:`plain_gated_scan` for the output gradients
    dy (of y) and dhT (of hT; either may be None), recomputed under
    autograd, on any device: a tuple with one entry per input, None for
    an input that is None or whose ``needs`` entry is false (``needs``:
    one bool per input, default all). The same graph as autograd of
    :func:`plain_gated_scan`, so the same bits."""
    inputs = (dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0)
    needs = needs if needs is not None else (True,) * len(inputs)
    with torch.enable_grad():
        leaves = [None if t is None else
                  t.detach().requires_grad_(bool(need) and t.is_floating_point())
                  for t, need in zip(inputs, needs)]
        outs = plain_gated_scan(*leaves)
        pairs = [(o, g) for o, g in zip(outs, (dy, dhT)) if g is not None]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        if not pairs or not wrt:
            return (None,) * len(inputs)
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


class _GatedScan(torch.autograd.Function):
    """B7's gated mode forward, :func:`gated_scan_backward_plain`
    backward."""

    @staticmethod
    def forward(ctx, *args):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*args)
        return mamba1_scan_gated(*args)

    @staticmethod
    def backward(ctx, dy, dhT):
        return gated_scan_backward_plain(*ctx.saved_tensors, dy, dhT,
                                         needs=ctx.needs_input_grad)


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
    on x's device, from h0 (zeros when None). Differentiable on both
    devices."""
    args = (dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0)
    if x.device.type == "cuda":
        return _GatedScan.apply(*args)
    if x.device.type == "cpu":
        return plain_gated_scan(*args)
    raise ValueError(f"unsupported device {x.device}")
