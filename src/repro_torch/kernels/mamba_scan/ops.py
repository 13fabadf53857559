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
the backward is one launch of the backward kernel
(``mamba_scan.mamba1_scan_gated_backward``, ``csrc/mamba_scan_bwd.cu``),
which recomputes the forward from the saved inputs and walks the adjoint
recurrence back through time. The reference has no backward kernel (its
Pallas call defines no VJP, and its model trains through its own
``lax.scan``, which JAX differentiates into one reverse loop): the
kernel is that loop. Its plain version is :func:`plain_gated_scan_backward`,
the same adjoint recurrence as a reverse loop over time in PyTorch, in
the kernel's fp32 op order. On the CPU, :func:`gated_selective_scan`
stays differentiable through autograd of :func:`plain_gated_scan`;
:func:`gated_scan_backward_plain` recomputes that autograd graph from
saved inputs and is the tests' oracle for both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.mamba_scan import (
    GATED_INPUTS,
    check_gated_backward_inputs,
    check_gated_inputs,
    check_inputs,
    mamba1_scan,
    mamba1_scan_gated,
    mamba1_scan_gated_backward,
    needs_mask,
)
from repro_torch.kernels.mamba_scan.ref import _fold_sum, mamba1_scan_ref


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
    :func:`plain_gated_scan`, so the same bits. Not to be confused with
    :func:`plain_gated_scan_backward`, the backward kernel's plain
    version."""
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


def _adjoint(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0, dy, dhT,
             absolute=False):
    """The adjoint recurrence of the gated scan in the backward kernel's
    fp32 op order (``csrc/mamba_scan_bwd.cu``'s header gives the
    formulas): the forward from h0, keeping the state entering each
    step, then a reverse loop over time. Returns ({input index: fp32
    gradient} for ddt_raw (0), dx (2), dz (7) and dh0 (8), {input index:
    fp32 sum} for ddt_bias (1), dB_in (3), dC_in (4), dA_log (5) and dD
    (6)); with ``absolute`` each sum adds its terms' magnitudes instead
    (the bar of a reduction taken in another order)."""
    f32 = torch.float32
    Bb, S, di = x.shape
    N = B_in.shape[2]
    xf, zf, Bf, Cf = (t.to(f32) for t in (x, z, B_in, C_in))
    dyf = torch.zeros_like(xf) if dy is None else dy.to(f32)
    v = dt_raw.to(f32) + dt_bias
    ev = torch.exp(v)
    dt = torch.where(v > 20, v, torch.log1p(ev))  # softplus, threshold 20
    a = -torch.exp(A_log)
    en = torch.exp(-zf)
    silu = zf / (1.0 + en)
    sig = torch.reciprocal(1.0 + en)
    dsilu = sig * (1.0 + zf * (1.0 - sig))
    sigv = ev / (ev + 1.0)
    h = (torch.zeros((Bb, di, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    kept = []
    for t in range(S):
        kept.append(h)
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * a)
        h = da * h + (dtt * xf[:, t])[..., None] * Bf[:, t, None, :]
    mag = torch.abs if absolute else (lambda u: u)
    r = (torch.zeros((Bb, di, N), dtype=f32, device=x.device)
         if dhT is None else dhT.to(f32))
    ddt_raw, dx, dz = (torch.empty_like(xf) for _ in range(3))
    dB, dC = (torch.empty((Bb, S, N), dtype=f32, device=x.device)
              for _ in range(2))
    acc_a = torch.zeros_like(r)
    acc_d, acc_bias = torch.zeros_like(r[..., 0]), torch.zeros_like(r[..., 0])
    for t in reversed(range(S)):
        dtt, xt = dt[:, t], xf[:, t]
        Bt, Ct = Bf[:, t, None, :], Cf[:, t, None, :]
        da = torch.exp(dtt[..., None] * a)
        eh = da * kept[t]
        dtx = dtt * xt
        hn = eh + dtx[..., None] * Bt
        u = _fold_sum(hn * Ct) + D * xt
        dys = dyf[:, t] * silu[:, t]
        dz[:, t] = (dyf[:, t] * u) * dsilu[:, t]
        dC[:, t] = mag(dys[..., None] * hn).sum(1)
        g = dys[..., None] * Ct + r
        gB = _fold_sum(g * Bt)
        ge = g * eh
        acc_a = acc_a + mag(dtt[..., None] * ge)
        dB[:, t] = mag(g * dtx[..., None]).sum(1)
        r = da * g
        dx[:, t] = dys * D + dtt * gB
        ddt = _fold_sum(a * ge) + xt * gB
        ddt_raw[:, t] = torch.where(v[:, t] > 20, ddt, ddt * sigv[:, t])
        acc_bias = acc_bias + mag(ddt_raw[:, t])
        acc_d = acc_d + mag(dys * xt)
    return ({0: ddt_raw, 2: dx, 7: dz, 8: r},
            {1: acc_bias.sum(0), 3: dB, 4: dC, 6: acc_d.sum(0),
             5: mag(a) * acc_a.sum(0)})


def plain_gated_scan_backward(dt_raw, dt_bias, x, B_in, C_in, A_log, D, z,
                              h0, dy, dhT, needs=None):
    """The backward kernel's plain version, on any device: the gradients
    of :func:`plain_gated_scan` for the output gradients dy (of y, in x's
    dtype) and dhT (of hT, fp32), either None, by the explicit adjoint
    recurrence in the kernel's fp32 op order (so on the card dx, dz,
    ddt_raw and dh0 are the kernel's bits; the sums over channels and
    over (b, t) are taken in another order). A tuple with one entry per
    input (``mamba_scan.GATED_INPUTS``), None where the input is None or
    its ``needs`` entry is false, each in its input's dtype but dB_in and
    dC_in, which stay fp32, as the kernel's wrapper returns them. Not to
    be confused with :func:`gated_scan_backward_plain`, autograd of
    :func:`plain_gated_scan` (the tests' oracle for both)."""
    args = (dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0)
    check_gated_backward_inputs("plain_gated_scan_backward", args, dy, dhT)
    mask = needs_mask(needs, h0)
    grads = [None] * len(GATED_INPUTS)
    if not mask or (dy is None and dhT is None):
        return tuple(grads)
    per_element, sums = _adjoint(*args, dy, dhT)
    for i, g in {**per_element, **sums}.items():
        if mask >> i & 1:
            grads[i] = g if i in (3, 4) else g.to(args[i].dtype)
    return tuple(grads)


def gated_scan_backward_magnitudes(dt_raw, dt_bias, x, B_in, C_in, A_log, D,
                                   z, h0, dy, dhT):
    """{input name: the sum of its terms' magnitudes} for the gradients
    that are sums (dt_bias, B_in, C_in, A_log, D), fp32, shaped as the
    gradients: the scale of a reduction summed in another order than
    :func:`plain_gated_scan_backward` 's."""
    args = (dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0)
    check_gated_backward_inputs("gated_scan_backward_magnitudes", args, dy,
                                dhT)
    _, sums = _adjoint(*args, dy, dhT, absolute=True)
    return {GATED_INPUTS[i]: s for i, s in sums.items()}


class _GatedScan(torch.autograd.Function):
    """B7's gated mode forward, the backward kernel's backward (both on
    the card)."""

    @staticmethod
    def forward(ctx, *args):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*args)
        return mamba1_scan_gated(*args)

    @staticmethod
    def backward(ctx, dy, dhT):
        args = ctx.saved_tensors
        grads = mamba1_scan_gated_backward(*args, dy, dhT,
                                           needs=ctx.needs_input_grad)
        return tuple(None if g is None else g.to(a.dtype)
                     for g, a in zip(grads, args))


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
