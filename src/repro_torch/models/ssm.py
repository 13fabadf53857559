"""State-space blocks: Mamba1 (falcon-mamba).

The port's counterpart of the Mamba1 half of ``repro/models/ssm.py``.
Shapes: d_inner di = expand * d, state N, conv K, dt rank R. The decode
state is ``{"conv": (B, K-1, di), "ssm": (B, di, N) fp32}``.

The selective scan goes through
``kernels/mamba_scan/ops.gated_selective_scan``: B7's gated mode on the
card, its plain version on the CPU. The reference's layer runs its own
``lax.scan`` for the full sequence and repeats the recurrence in jnp for
decode; here both are the same scan, decode at S = 1 from the carried
state. Around it the reference's op order and dtypes are kept: the
causal conv as K shifted multiply-adds in the activation dtype (rounded
at each step, as the reference's; ``F.conv1d`` would sum in fp32 and
round once), the dt product rounded to the activation dtype, then
widened, then ``dt_bias`` added and softplus taken, A = -exp(A_log), and
the ``silu(z)`` gate in fp32; the gated scan does those last steps
itself, on the card inside B7, with torch's own formulas.

One departure: the reference's decode conv (``conv_step``) is an einsum
that sums the K products in fp32 and rounds once, unlike its forward.
In bf16 that one-ulp gap, fed back through 64 layers, puts decode after
prefill further than the 5e-2 logit bar from the forward of the same
tokens. Here the decode conv does the forward's arithmetic, so prefill
then decode gives the forward's logits (bit for bit on the CPU); in fp32
it stays within the layer's 3e-5 bar of the reference's decode
(``tests/test_torch_ssm.py``).

``F.softplus`` returns x above 20 where the reference's
``jax.nn.softplus`` is ``logaddexp(x, 0) = x + log1p(exp(-x))``: the gap
is below exp(-20) = 2.1e-9, under half an ulp of x there, so the fp32
results agree; below 20 both are log1p(exp(x)) up to rounding.

Mamba2 (``init_mamba2``, ``_ssd_chunked``, ``mamba2_forward``,
``mamba2_decode``) waits for the hybrid slice, ``ROADMAP.md`` A15c.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba_scan import ops
from repro_torch.models.layers import module_device, new_weight

MAMBA2_TODO = ("Mamba2 (the SSD chunked scan of models/ssm.py) waits for "
               "the hybrid slice, ROADMAP.md A15c")


# ------------------------------------------------------------------ helpers
def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C), w (K, C) -> (B, S, C): K
    shifted products added left to right in x's dtype."""
    K, S = w.shape[0], x.shape[1]
    w = w.to(x.dtype)
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def conv_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None):
    """One decode step. conv_state (B, K-1, C), x_t (B, C) -> (the new
    state (B, K-1, C) in x_t's dtype, the conv output (B, C)): the K
    products, each rounded to x_t's dtype, added left to right, which is
    :func:`causal_conv1d`'s arithmetic at the window's last position."""
    window = torch.cat([conv_state.to(x_t.dtype), x_t[:, None, :]], dim=1)
    prods = window * w.to(window.dtype)
    out = prods[:, 0]
    for i in range(1, prods.shape[1]):
        out = out + prods[:, i]
    if bias is not None:
        out = out + bias.to(out.dtype)
    return window[:, 1:], out


# =============================================================== Mamba 1 ====
class Mamba1(nn.Module):
    """One Mamba1 mixer, with the reference's leaf names: in_proj (d,
    2di), conv_w (K, di), conv_b (di,), x_proj (di, R+2N), dt_proj (R,
    di) and out_proj (di, d) in ``cfg.dtype`` (the reference rounds them
    to the activation dtype at every use); dt_bias (di,), A_log (di, N)
    and D (di,) in ``cfg.param_dtype`` (the reference uses them in fp32).
    Left unset, on ``device`` (``cuda`` unless ``"cpu"``; ``"meta"``
    allocates nothing)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.ssm_version != 1:
            raise NotImplementedError(f"{cfg.name}: {MAMBA2_TODO}")
        device = module_device(device)
        d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        R = cfg.resolved_dt_rank
        dt, pdt = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.in_proj = new_weight((d, 2 * di), dt, device)
        self.conv_w = new_weight((K, di), dt, device)
        self.conv_b = new_weight((di,), dt, device)
        self.x_proj = new_weight((di, R + 2 * N), dt, device)
        self.dt_proj = new_weight((R, di), dt, device)
        self.dt_bias = new_weight((di,), pdt, device)
        self.A_log = new_weight((di, N), pdt, device)
        self.D = new_weight((di,), pdt, device)
        self.out_proj = new_weight((di, d), dt, device)


def init_mamba1(mod: Mamba1, cfg: ArchConfig,
                generator: torch.Generator) -> None:
    """Fill ``mod`` with the reference's initialisation, drawn from
    ``generator`` in fp32 in the order in_proj, conv_w, x_proj, dt_proj
    (normals), dt_bias (uniforms), out_proj (normals): in_proj d^-0.5
    N(0, 1), conv_w 0.5 N(0, 1) / K, x_proj and out_proj di^-0.5 N(0, 1),
    dt_proj R^-0.5 N(0, 1); dt_bias = softplus^-1(dt) with dt log-uniform
    in [1e-3, 1e-1]; A_log = log(1..N) per channel, D = 1, conv_b = 0."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    R = cfg.resolved_dt_rank
    dev, f32 = mod.in_proj.device, torch.float32

    def normal(param, scale):
        param.copy_(scale * torch.randn(param.shape, generator=generator,
                                        device=dev, dtype=f32))

    normal(mod.in_proj, d ** -0.5)
    normal(mod.conv_w, 0.5 / K)
    normal(mod.x_proj, di ** -0.5)
    normal(mod.dt_proj, R ** -0.5)
    lo, hi = torch.log(torch.tensor([1e-3, 1e-1], dtype=f32)).tolist()
    u = torch.rand((di,), generator=generator, device=dev, dtype=f32)
    dt = torch.exp(lo + (hi - lo) * u)
    mod.dt_bias.copy_(torch.log(torch.expm1(dt)))
    normal(mod.out_proj, di ** -0.5)
    # log(1..N) rounded once from float64: the correctly rounded values on
    # every device (the reference's XLA log on the CPU is an ulp above at 7)
    mod.A_log.copy_(torch.log(torch.arange(
        1, N + 1, dtype=torch.float64, device=dev)).to(f32).expand(di, N))
    mod.D.fill_(1.0)
    mod.conv_b.zero_()


def _split_xz(x: torch.Tensor, mod: Mamba1, cfg: ArchConfig):
    xz = x @ mod.in_proj.to(x.dtype)
    return xz[..., :cfg.d_inner], xz[..., cfg.d_inner:]


def _mamba1_inner(mod: Mamba1, cfg: ArchConfig, x_conv: torch.Tensor,
                  z: torch.Tensor, h0: torch.Tensor | None = None):
    """The SSM math after the conv. x_conv, z (B, S, di) -> (y (B, S, di)
    in x_conv's dtype, the final state (B, di, N) fp32), from h0 (zeros
    when None)."""
    N, R = cfg.ssm_state, cfg.resolved_dt_rank
    f32 = torch.float32
    xdb = x_conv @ mod.x_proj.to(x_conv.dtype)  # (B, S, R + 2N)
    dt_in, B_ssm, C_ssm = xdb[..., :R], xdb[..., R:R + N], xdb[..., R + N:]
    dt_raw = dt_in @ mod.dt_proj.to(dt_in.dtype)  # (B, S, di)
    return ops.gated_selective_scan(
        dt_raw, mod.dt_bias.to(f32), x_conv, B_ssm, C_ssm,
        mod.A_log.to(f32), mod.D.to(f32), z, h0)


def mamba1_forward(x: torch.Tensor, mod: Mamba1, cfg: ArchConfig,
                   return_state: bool = False):
    """Full-sequence selective scan. x (B, S, d) -> (B, S, d) [+ the
    decode state {"conv": (B, K-1, di) in x's dtype, zero-padded in front
    when S < K-1, "ssm": (B, di, N) fp32}]."""
    K = cfg.ssm_conv
    x_in, z = _split_xz(x, mod, cfg)
    x_conv = F.silu(causal_conv1d(x_in, mod.conv_w, mod.conv_b))
    y, h = _mamba1_inner(mod, cfg, x_conv, z)
    out = y @ mod.out_proj.to(y.dtype)
    if not return_state:
        return out
    B, S, di = x_in.shape
    pad = x_in.new_zeros((B, max(K - 1 - S, 0), di))
    conv_state = torch.cat([pad, x_in[:, max(S - (K - 1), 0):]], dim=1)
    return out, {"conv": conv_state, "ssm": h}


def mamba1_decode(x_t: torch.Tensor, state: dict, mod: Mamba1,
                  cfg: ArchConfig):
    """One token. x_t (B, d); state {"conv" (B, K-1, di), "ssm" (B, di,
    N)} -> (B, d), the new state (new tensors: the conv state in x_t's
    dtype, the ssm state fp32)."""
    x_in, z = _split_xz(x_t, mod, cfg)
    conv_state, x_c = conv_step(state["conv"], x_in, mod.conv_w, mod.conv_b)
    x_c = F.silu(x_c)
    y, h = _mamba1_inner(mod, cfg, x_c[:, None], z[:, None],
                         h0=state["ssm"])
    y = y[:, 0]
    return y @ mod.out_proj.to(y.dtype), {"conv": conv_state, "ssm": h}


def mamba_ref_sequential(x: torch.Tensor, mod: Mamba1,
                         cfg: ArchConfig) -> torch.Tensor:
    """Step-by-step decode-path oracle for tests: running mamba1_decode
    over the sequence must equal mamba1_forward."""
    if cfg.ssm_version != 1:
        raise NotImplementedError(f"{cfg.name}: {MAMBA2_TODO}")
    B, S, _ = x.shape
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    state = {"conv": x.new_zeros((B, K - 1, di)),
             "ssm": torch.zeros((B, di, N), dtype=torch.float32,
                                device=x.device)}
    ys = []
    for t in range(S):
        y, state = mamba1_decode(x[:, t], state, mod, cfg)
        ys.append(y)
    return torch.stack(ys, dim=1)
