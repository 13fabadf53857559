"""State-space blocks: Mamba1 (falcon-mamba) and Mamba2/SSD (zamba2).

The port's counterpart of ``repro/models/ssm.py``. Shapes: d_inner di =
expand * d, state N, conv K; Mamba1's dt rank R; Mamba2's nh = di /
headdim heads of width p = headdim, one scalar A per head. The decode
state is ``{"conv": (B, K-1, di), "ssm": (B, di, N) fp32}`` for Mamba1
and ``{"conv": (B, K-1, di+2N), "ssm": (B, nh, p, N) fp32}`` for Mamba2.

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

One departure, in both versions: the reference's decode conv
(``conv_step``) is an einsum that sums the K products in fp32 and rounds
once, unlike its forward.
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

On a mesh (``models/sharding.py``) a rank's :class:`Mamba1` holds
d_inner / m channels of model rank r: in_proj's x half and z half each
cut by columns (the rank holds [x_r | z_r]), conv_w/conv_b/dt_proj/
dt_bias/A_log/D by channel, x_proj and out_proj by rows. The scan (B7)
runs on the rank's channels; x_proj's (B, S, R + 2N) and out_proj's
(B, S, d) products are partial sums, added over ``model`` in fp32 before
dt, B and C are read and before the residual. Under training the
normed input enters in_proj through ``copy_to`` and the summed x_proj
output enters dt_proj and every rank's channels (B, C) through it too,
so their gradients are summed over ``model``; a trainable model's FSDP
leaves (in_proj, out_proj) are gathered over ``data`` at each use
(``sharding.at_use``), Mamba2's as well.

A rank's :class:`Mamba2` holds nh / m heads of model rank r and their
di / m channels (``models/sharding.py``): in_proj's columns [z_r | x_r |
B | C | dt_r], conv_w/conv_b's [x_r | B | C], dt_bias/A_log/D its heads,
norm_scale its channels and out_proj their rows. The SSD runs on the
rank's heads (states (B, nh / m, p, N)). Three sums over ``model`` make
the layer the unsharded one: out_proj's partial product (row-parallel);
the gated RMSNorm's sum of y^2 over all di channels (fp32), whose result
feeds each rank's own channels, so its backward sums over ``model`` as
well; and, under training, the gradients of the B and C columns of
in_proj and of the B and C channels of conv_w/conv_b, which are whole on
every rank while each rank's heads give only their share (a ``copy_to``
on those weight slices at use). The normed input enters in_proj through
``copy_to`` once, so the activations' path is summed once.

Mamba2's chunked SSD is jnp in the reference (no Pallas kernel), so
:func:`ssd_chunked` is plain PyTorch on every device, all in fp32. The
reference writes three of its contractions as three-operand einsums; here
each is contracted by hand, in an order that never builds the 6-D
(b, chunk, i, j, h, p) tensor (21 GB at 4 x 4,096 for zamba2): the
intra-chunk weights ``C.B * L`` are formed per head and multiplied into
``dt * x`` by a batched product over j, ``decay_to_end`` is folded into
``dt * x`` before the product over positions that makes the chunk
states, and ``state_decay`` is applied after the product over N. The
chunk-state recurrence is the reference's, one chunk after the other.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba_scan import ops
from repro_torch.launch.mesh import copy_to, sum_fp32
from repro_torch.models.layers import (
    module_device,
    new_weight,
    row_parallel,
    weight_dtype,
)
from repro_torch.models.sharding import at_use


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
    and D (di,) in ``cfg.param_dtype`` (the reference uses them in fp32);
    every leaf in ``cfg.param_dtype``, with a gradient, when
    ``trainable``. Left unset, on ``device`` (``cuda`` unless ``"cpu"``;
    ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        device = module_device(device)
        d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        R = cfg.resolved_dt_rank
        dt, pdt = weight_dtype(cfg, trainable), getattr(torch, cfg.param_dtype)

        def weight(dtype, *shape):
            return new_weight(shape, dtype, device, trainable)

        self.in_proj = weight(dt, d, 2 * di)
        self.conv_w = weight(dt, K, di)
        self.conv_b = weight(dt, di)
        self.x_proj = weight(dt, di, R + 2 * N)
        self.dt_proj = weight(dt, R, di)
        self.dt_bias = weight(pdt, di)
        self.A_log = weight(pdt, di, N)
        self.D = weight(pdt, di)
        self.out_proj = weight(dt, di, d)


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


def _split_xz(x: torch.Tensor, mod: Mamba1, cfg: ArchConfig, mesh=None):
    """x (..., d) -> the x and z halves (..., di) of this module's (a
    rank's share of) channels."""
    x = copy_to(x, mesh, "model")
    xz = x @ at_use(mod.in_proj, mesh).to(x.dtype)
    di = mod.in_proj.shape[1] // 2
    return xz[..., :di], xz[..., di:]


def _mamba1_inner(mod: Mamba1, cfg: ArchConfig, x_conv: torch.Tensor,
                  z: torch.Tensor, h0: torch.Tensor | None = None,
                  mesh=None):
    """The SSM math after the conv. x_conv, z (B, S, di) -> (y (B, S, di)
    in x_conv's dtype, the final state (B, di, N) fp32), from h0 (zeros
    when None)."""
    N, R = cfg.ssm_state, cfg.resolved_dt_rank
    f32 = torch.float32
    # (B, S, R+2N), whole on every rank, read by each rank's channels
    xdb = copy_to(row_parallel(x_conv, mod.x_proj, mesh), mesh, "model")
    dt_in, B_ssm, C_ssm = xdb[..., :R], xdb[..., R:R + N], xdb[..., R + N:]
    dt_raw = dt_in @ mod.dt_proj.to(dt_in.dtype)  # (B, S, di)
    return ops.gated_selective_scan(
        dt_raw, mod.dt_bias.to(f32), x_conv, B_ssm, C_ssm,
        mod.A_log.to(f32), mod.D.to(f32), z, h0)


def mamba1_forward(x: torch.Tensor, mod: Mamba1, cfg: ArchConfig,
                   return_state: bool = False, mesh=None):
    """Full-sequence selective scan. x (B, S, d) -> (B, S, d) [+ the
    decode state {"conv": (B, K-1, di) in x's dtype, zero-padded in front
    when S < K-1, "ssm": (B, di, N) fp32}], di the rank's channels on a
    ``mesh``."""
    K = cfg.ssm_conv
    x_in, z = _split_xz(x, mod, cfg, mesh)
    x_conv = F.silu(causal_conv1d(x_in, mod.conv_w, mod.conv_b))
    y, h = _mamba1_inner(mod, cfg, x_conv, z, mesh=mesh)
    out = row_parallel(y, at_use(mod.out_proj, mesh), mesh)
    if not return_state:
        return out
    B, S, di = x_in.shape
    pad = x_in.new_zeros((B, max(K - 1 - S, 0), di))
    conv_state = torch.cat([pad, x_in[:, max(S - (K - 1), 0):]], dim=1)
    return out, {"conv": conv_state, "ssm": h}


def mamba1_decode(x_t: torch.Tensor, state: dict, mod: Mamba1,
                  cfg: ArchConfig, mesh=None):
    """One token. x_t (B, d); state {"conv" (B, K-1, di), "ssm" (B, di,
    N)} -> (B, d), the new state (new tensors: the conv state in x_t's
    dtype, the ssm state fp32); di the rank's channels on a ``mesh``."""
    x_in, z = _split_xz(x_t, mod, cfg, mesh)
    conv_state, x_c = conv_step(state["conv"], x_in, mod.conv_w, mod.conv_b)
    x_c = F.silu(x_c)
    y, h = _mamba1_inner(mod, cfg, x_c[:, None], z[:, None],
                         h0=state["ssm"], mesh=mesh)
    y = y[:, 0]
    return (row_parallel(y, at_use(mod.out_proj, mesh), mesh),
            {"conv": conv_state, "ssm": h})


# =============================================================== Mamba 2 ====
class Mamba2(nn.Module):
    """One Mamba2 mixer, with the reference's leaf names: in_proj (d,
    2di+2N+nh), conv_w (K, di+2N), conv_b (di+2N,) and out_proj (di, d)
    in ``cfg.dtype``; dt_bias, A_log and D (nh,) and norm_scale (di,) in
    ``cfg.param_dtype``, as :class:`Mamba1` keeps its leaves (and, like
    it, all in ``cfg.param_dtype`` with a gradient when ``trainable``).
    Left unset, on ``device`` (``cuda`` unless ``"cpu"``; ``"meta"``
    allocates nothing)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        device = module_device(device)
        d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        nh = di // cfg.ssm_headdim
        dt, pdt = weight_dtype(cfg, trainable), getattr(torch, cfg.param_dtype)

        def weight(dtype, *shape):
            return new_weight(shape, dtype, device, trainable)

        self.in_proj = weight(dt, d, 2 * di + 2 * N + nh)
        self.conv_w = weight(dt, K, di + 2 * N)
        self.conv_b = weight(dt, di + 2 * N)
        self.dt_bias = weight(pdt, nh)
        self.A_log = weight(pdt, nh)
        self.D = weight(pdt, nh)
        self.norm_scale = weight(pdt, di)
        self.out_proj = weight(dt, di, d)


def init_mamba2(mod: Mamba2, cfg: ArchConfig,
                generator: torch.Generator) -> None:
    """Fill ``mod`` with the reference's initialisation, drawn from
    ``generator`` in fp32 in the order in_proj, conv_w, out_proj: in_proj
    d^-0.5 N(0, 1), conv_w 0.5 N(0, 1) / K, out_proj di^-0.5 N(0, 1);
    dt_bias = 0, A_log = log(linspace(1, 16, nh)), D = 1, norm_scale = 1,
    conv_b = 0."""
    d, di, K = cfg.d_model, cfg.d_inner, cfg.ssm_conv
    nh = di // cfg.ssm_headdim
    dev, f32 = mod.in_proj.device, torch.float32

    def normal(param, scale):
        param.copy_(scale * torch.randn(param.shape, generator=generator,
                                        device=dev, dtype=f32))

    normal(mod.in_proj, d ** -0.5)
    normal(mod.conv_w, 0.5 / K)
    normal(mod.out_proj, di ** -0.5)
    # computed in float64 and rounded once, as Mamba1's A_log
    mod.A_log.copy_(torch.log(torch.linspace(
        1.0, 16.0, nh, dtype=torch.float64, device=dev)).to(f32))
    mod.dt_bias.zero_()
    mod.D.fill_(1.0)
    mod.norm_scale.fill_(1.0)
    mod.conv_b.zero_()


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Chunked SSD (Mamba2). xh (b, s, nh, p), dt (b, s, nh) fp32, A (nh,),
    B and C (b, s, N) -> (y (b, s, nh, p), the final state (b, nh, p, N)),
    both fp32. The chunk is ``min(chunk, s)`` and must divide s (the
    reference asserts it; here ``ValueError``)."""
    b, s, nh, p = xh.shape
    N = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: the sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")
    nc, f32 = s // chunk, torch.float32
    # head-major layouts: (b, c, h, l, ...) so each product is a batched
    # matmul over contiguous (l, ...) blocks
    xc = xh.reshape(b, nc, chunk, nh, p).to(f32).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(b, nc, chunk, nh).permute(0, 1, 3, 2)  # (b,c,h,l)
    Bc = B.reshape(b, nc, chunk, N).to(f32)
    Cc = C.reshape(b, nc, chunk, N).to(f32)

    a_cum = torch.cumsum(dtc * A[:, None], dim=-1)  # (b,c,h,l), negative
    # intra-chunk: L_ij = exp(a_cum_i - a_cum_j) for j <= i; the mask goes
    # BEFORE the exp (the upper triangle would overflow)
    upper = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=xh.device).triu(1)
    # (out of place: exp's backward reads its output, which an in-place
    # multiply would overwrite)
    w = a_cum[..., :, None] - a_cum[..., None, :]  # (b,c,h,i,j)
    w = torch.exp(w.masked_fill(upper, float("-inf")))
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))  # (b,c,i,j)
    w = w * cb[:, :, None]
    dtx = dtc[..., None] * xc  # (b,c,h,l,p)
    y = torch.matmul(w, dtx)  # y_diag (b,c,h,i,p)
    del w

    # chunk states: S_c = sum_l exp(a_cum_last - a_cum_l) dtx_l (x) B_l
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)  # (b,c,h,l)
    states = torch.matmul((decay_to_end[..., None] * dtx).transpose(-1, -2),
                          Bc[:, :, None])  # (b,c,h,p,N)
    del dtx, decay_to_end
    chunk_decay = torch.exp(a_cum[..., -1])  # (b,c,h)

    # the reference's scan over chunks: each chunk reads the state before it
    prev = torch.empty_like(states)
    h = torch.zeros((b, nh, p, N), dtype=f32, device=xh.device)
    for c in range(nc):
        prev[:, c] = h
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    del states

    # y_off = (C . prev) * exp(a_cum): the product over N first
    y_off = torch.matmul(Cc[:, :, None], prev.transpose(-1, -2))  # (b,c,h,l,p)
    y = y + y_off * torch.exp(a_cum)[..., None]
    del y_off, prev
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, nh, p), h


def _split(mesh) -> bool:
    return mesh is not None and mesh.shape["model"] > 1


def _whole_cols(w: torch.Tensor, lo: int, hi: int, mesh) -> torch.Tensor:
    """``w`` whose last-axis columns [lo, hi) are whole on every model
    rank (Mamba2's B and C), entering through ``copy_to`` when their
    gradient is taken on a mesh split over ``model``: each rank's heads
    give only their share of it. ``w`` itself otherwise (the same
    values either way)."""
    if not (_split(mesh) and torch.is_grad_enabled() and w.requires_grad):
        return w
    return torch.cat([w[..., :lo], copy_to(w[..., lo:hi], mesh, "model"),
                      w[..., hi:]], dim=-1)


def _mamba2_in(x: torch.Tensor, mod: Mamba2, cfg: ArchConfig, mesh=None):
    """x (..., d) -> z (..., di), xbc_raw (..., di+2N) and dt_in (...,
    nh) of this module's (a rank's) heads: x enters through ``copy_to``
    and in_proj's B and C columns through :func:`_whole_cols`."""
    di, N = mod.norm_scale.shape[0], cfg.ssm_state
    x = copy_to(x, mesh, "model")
    w = _whole_cols(at_use(mod.in_proj, mesh), 2 * di, 2 * di + 2 * N, mesh)
    zxbcdt = x @ w.to(x.dtype)
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _mamba2_conv(mod: Mamba2, cfg: ArchConfig, mesh=None):
    """conv_w and conv_b with their B and C channels through
    :func:`_whole_cols`."""
    di, N = mod.norm_scale.shape[0], cfg.ssm_state
    return (_whole_cols(mod.conv_w, di, di + 2 * N, mesh),
            _whole_cols(mod.conv_b, di, di + 2 * N, mesh))


def _mean_sq(y: torch.Tensor, cfg: ArchConfig, mesh=None) -> torch.Tensor:
    """The mean of y^2 over all d_inner channels (fp32, keepdim). On a mesh
    split over ``model``: each rank's sum over its channels, summed over
    ``model`` and divided by d_inner; the backward sums over ``model``
    too, since each rank's channels read the result."""
    if not _split(mesh):
        return torch.mean(y * y, dim=-1, keepdim=True)
    ss = sum_fp32(torch.sum(y * y, dim=-1, keepdim=True), mesh, "model")
    return copy_to(ss, mesh, "model") / cfg.d_inner


def _gated_rmsnorm_out(y: torch.Tensor, z: torch.Tensor, mod: Mamba2,
                       cfg: ArchConfig, dtype: torch.dtype,
                       mesh=None) -> torch.Tensor:
    """y * silu(z), RMS-normalised over all d_inner channels
    (:func:`_mean_sq`) and scaled by norm_scale, all in fp32, then cast
    to ``dtype`` and projected by out_proj (row-parallel)."""
    y = y * F.silu(z.to(torch.float32))
    y = y * torch.rsqrt(_mean_sq(y, cfg, mesh) + 1e-6)
    y = (y * mod.norm_scale.to(torch.float32)).to(dtype)
    return row_parallel(y, at_use(mod.out_proj, mesh), mesh)


def mamba2_forward(x: torch.Tensor, mod: Mamba2, cfg: ArchConfig,
                   return_state: bool = False, mesh=None):
    """Full-sequence SSD. x (B, S, d) -> (B, S, d) [+ the decode state
    {"conv": (B, K-1, di+2N) in x's dtype, zero-padded in front when S <
    K-1, "ssm": (B, nh, p, N) fp32}], with chunk ``min(cfg.ssd_chunk,
    S)``, which must divide S; di and nh the rank's (the module
    docstring) on a ``mesh``."""
    K, p, f32 = cfg.ssm_conv, cfg.ssm_headdim, torch.float32
    di, N = mod.norm_scale.shape[0], cfg.ssm_state
    z, xbc_raw, dt_in = _mamba2_in(x, mod, cfg, mesh)
    xbc = F.silu(causal_conv1d(xbc_raw, *_mamba2_conv(mod, cfg, mesh)))
    xs, B_ssm, C_ssm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt_in.to(f32) + mod.dt_bias.to(f32))
    A = -torch.exp(mod.A_log.to(f32))
    xh = xs.reshape(*xs.shape[:-1], di // p, p)
    y, h = ssd_chunked(xh, dt, A, B_ssm, C_ssm, cfg.ssd_chunk)
    y = y + mod.D.to(f32)[:, None] * xh.to(f32)
    out = _gated_rmsnorm_out(y.reshape(*x.shape[:-1], di), z, mod, cfg,
                             x.dtype, mesh)
    if not return_state:
        return out
    Bsz, S, C = xbc_raw.shape
    pad = xbc_raw.new_zeros((Bsz, max(K - 1 - S, 0), C))
    conv_state = torch.cat([pad, xbc_raw[:, max(S - (K - 1), 0):]], dim=1)
    return out, {"conv": conv_state, "ssm": h}


def mamba2_decode(x_t: torch.Tensor, state: dict, mod: Mamba2,
                  cfg: ArchConfig, mesh=None):
    """One token. x_t (B, d); state {"conv" (B, K-1, di+2N), "ssm" (B, nh,
    p, N)} -> (B, d), the new state (new tensors: the conv state in x_t's
    dtype, the ssm state fp32); di and nh the rank's on a ``mesh``."""
    p, f32 = cfg.ssm_headdim, torch.float32
    di, N = mod.norm_scale.shape[0], cfg.ssm_state
    z, xbc, dt_in = _mamba2_in(x_t, mod, cfg, mesh)
    conv_state, xbc = conv_step(state["conv"], xbc,
                                *_mamba2_conv(mod, cfg, mesh))
    xbc = F.silu(xbc)
    xs, B_ssm, C_ssm = xbc[:, :di], xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(dt_in.to(f32) + mod.dt_bias.to(f32))  # (B, nh)
    A = -torch.exp(mod.A_log.to(f32))
    xh = xs.reshape(-1, di // p, p).to(f32)
    da = torch.exp(dt * A)
    h = (da[..., None, None] * state["ssm"]
         + (dt[..., None] * xh)[..., None] * B_ssm.to(f32)[:, None, None, :])
    y = torch.matmul(h, C_ssm.to(f32)[:, None, :, None])[..., 0]  # (B,nh,p)
    y = y + mod.D.to(f32)[:, None] * xh
    out = _gated_rmsnorm_out(y.reshape(-1, di), z, mod, cfg, x_t.dtype,
                             mesh)
    return out, {"conv": conv_state, "ssm": h}


def mamba_ref_sequential(x: torch.Tensor, mod: Mamba1 | Mamba2,
                         cfg: ArchConfig) -> torch.Tensor:
    """Step-by-step decode-path oracle for tests: running mamba1_decode
    (``ssm_version`` 1) or mamba2_decode over the sequence must equal the
    version's forward."""
    B, S, _ = x.shape
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    f32 = torch.float32
    if cfg.ssm_version == 1:
        step = mamba1_decode
        state = {"conv": x.new_zeros((B, K - 1, di)),
                 "ssm": torch.zeros((B, di, N), dtype=f32, device=x.device)}
    else:
        step, p = mamba2_decode, cfg.ssm_headdim
        state = {"conv": x.new_zeros((B, K - 1, di + 2 * N)),
                 "ssm": torch.zeros((B, di // p, p, N), dtype=f32,
                                    device=x.device)}
    ys = []
    for t in range(S):
        y, state = step(x[:, t], state, mod, cfg)
        ys.append(y)
    return torch.stack(ys, dim=1)
