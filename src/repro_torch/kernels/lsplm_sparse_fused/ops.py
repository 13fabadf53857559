"""Public fused sparse LS-PLM ops: kernel or plain version.

The port's counterpart of ``repro/kernels/lsplm_sparse_fused/ops.py``
(``:79-135, 165-179, 254-367, 371-517``):

  * ``sparse_gather_matmul(ids, vals, theta, plan=) -> z (N, 2m)`` — the
    region logits, differentiable;
  * ``lsplm_sparse_logps`` — stable (log_p1, log_p0) on top of it, the
    training path;
  * ``lsplm_sparse_forward(ids, vals, theta, plan=) -> p (N,)`` — fully
    fused probabilities, differentiable;
  * ``sparse_gather_matmul_int8`` / ``lsplm_sparse_forward_int8`` — the
    same on an int8 model (``codes`` + per-row fp32 ``scales``) without
    materialising fp32 rows;
  * ``finalize_p`` / ``logps_from_z`` — the Eq. 2 head and the stable
    log-space Eq. 5 head on region logits;
  * ``bundle_forward`` — the session-shared (Eq. 13) forward of a bundle
    on the card without a gradient: two launches, the user rows' z feeding
    the ad-side launch as its addend.

Which implementation runs is decided by where the model lies and by
nothing else: a CUDA model launches the hand-written kernels
(``lsplm_sparse_fused.py``), which collapse duplicate ids within a row
themselves when ``dedup=True`` (bitwise ``dedup_tile_ids`` followed by
the kernel without it; ``dedup_tile_ids`` stays as the plain witness the
tests hold them against); a CPU model takes the plain versions below
(``_chunked_zmap`` / ``_chunked_zmap_int8``), which gather ``chunk`` slots
at a time with ``index_select`` and add them into z in slot order (the
dedup does not apply there, as on the reference's jnp path). There is
no fallback: a CUDA call launches its kernel or raises.

The launch knobs come from ``repro_torch.tune`` at the shape of each
call (``resolve_fused``: one dict lookup once a shape has been seen):
B1's ``block_n`` and ``copy`` (``"fused_fwd"``), B4's ``block_n``
(``"fused_fwd_int8"``) and the plain loops' ``chunk`` (``"chunk_fwd"``).
None of them changes a bit of (p, z).

Training differentiates ``sparse_gather_matmul`` (and
``lsplm_sparse_logps`` on top of it) through :class:`_GatherMatmul`, a
``torch.autograd.Function`` around the same forward; its backward is the
transposed scatter of ``repro_torch.kernels.lsplm_sparse_scatter``
(B2 on the card; the plain class gathers, or the ``index_add_`` oracle
without a plan, on the CPU), and dvals is computed only when asked for.
``lsplm_sparse_forward`` is differentiable too, through
:class:`_ForwardP`: its forward returns the fused kernel's own p (so a
planned call is bitwise the unplanned one) and its backward forms dz from
the Eq. 2 head's derivative and runs the same scatter. The int8 forms
serve scores and carry no gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
    lsplm_sparse_fused_forward,
    lsplm_sparse_fused_int8_forward,
)
from repro_torch.kernels.lsplm_sparse_scatter.ops import (
    TransposePlan,
    dvals_planned,
    dvals_unplanned,
    scatter_add_planned,
    scatter_add_unplanned,
)
from repro_torch.tune.table import resolve_fused


def pad_theta(theta: torch.Tensor) -> torch.Tensor:
    """Append the zero pad row (pad id == d == theta.shape[0]). The
    trailing row is RESERVED: every consumer treats id D-1 as the pad
    slot; its values must be 0."""
    return torch.cat([theta, theta.new_zeros((1, theta.shape[1]))], dim=0)


def finalize_p(z: torch.Tensor) -> torch.Tensor:
    """Eq. 2 head: region logits z (..., 2m) -> p(y=1|x) (...,)."""
    m = z.shape[-1] // 2
    gate = torch.softmax(z[..., :m], dim=-1)
    fit = torch.sigmoid(z[..., m:])
    return (gate * fit).sum(dim=-1)


def logps_from_z(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable (log_p1, log_p0) from region logits z (..., 2m)."""
    m = z.shape[-1] // 2
    log_gate = torch.log_softmax(z[..., :m], dim=-1)
    log_p1 = torch.logsumexp(log_gate + F.logsigmoid(z[..., m:]), dim=-1)
    log_p0 = torch.logsumexp(log_gate + F.logsigmoid(-z[..., m:]), dim=-1)
    return log_p1, log_p0


def dedup_tile_ids(ids: torch.Tensor, vals: torch.Tensor,
                   pad_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Collapse duplicate ids within each sample onto one slot.

    Each row is sorted by id (stably, like ``jnp.argsort``), so a
    repeated id's values sit side by side; its first slot carries the SUM
    of its values and the freed slots become (pad_id, 0). z is unchanged,
    and a gather then loads each hot row once per sample. The card's
    kernels do this themselves (``dedup=True``) with the same sums, bit
    for bit; this function is the plain witness they are held against.

    The sums are a segmented scan over the sorted row (log2 K shifted
    adds), and every output slot has exactly one writer: no atomics, so
    the result is the same on every run and device. (``scatter_add_``
    sums three or more duplicates on the card in an order that changes
    from run to run, which would break the engine's bitwise claims.)
    A run of three or more duplicates is summed as a tree, not left to
    right, so it can differ from the reference's sum in the last bit.
    """
    n, k = ids.shape
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    acc = torch.gather(vals, 1, order)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    seg = torch.cumsum(first, dim=1, dtype=torch.int64) - 1
    closed = first.clone()  # segment start already folded into acc[i]
    s = 1
    while s < k:
        acc = torch.cat([acc[:, :s], torch.where(
            closed[:, s:], acc[:, s:], acc[:, :-s] + acc[:, s:])], dim=1)
        closed = torch.cat([closed[:, :s], closed[:, s:] | closed[:, :-s]],
                           dim=1)
        s *= 2
    last = torch.ones_like(first)
    last[:, :-1] = first[:, 1:]
    # one writer per real slot; every other position writes column k,
    # which is dropped
    spill = torch.full_like(seg, k)
    vals_d = torch.zeros((n, k + 1), dtype=vals.dtype, device=vals.device)
    vals_d.scatter_(1, torch.where(last, seg, spill), acc)
    ids_d = torch.full((n, k + 1), pad_id, dtype=ids.dtype, device=ids.device)
    ids_d.scatter_(1, torch.where(first, seg, spill), ids_s)
    return ids_d[:, :k].contiguous(), vals_d[:, :k].contiguous()


def _chunk(ids: torch.Tensor, rows: torch.Tensor, chunk: int | None) -> int:
    """The plain forward's chunk: the caller's, else the tune table's
    ``chunk_fwd`` at this shape (builtin 8)."""
    if chunk is None:
        chunk = _knobs("chunk_fwd", ids, rows)["chunk"]
    if chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    return chunk


def _chunked_zmap(ids: torch.Tensor, vals: torch.Tensor, theta: torch.Tensor,
                  chunk: int | None = None) -> torch.Tensor:
    """Plain forward z (N, 2m) in Theta's dtype: gather ``chunk`` slots of
    rows at a time (``index_select``, int64 ids) and add their ``vals *
    row`` terms into z one slot at a time, in slot order -- so a row's z
    never depends on N, on the other rows or on the chunk. Pad slots add
    exact zeros. ``chunk`` None takes the tune table's."""
    n, k = ids.shape
    chunk = _chunk(ids, theta, chunk)
    z = torch.zeros((n, theta.shape[1]), dtype=theta.dtype,
                    device=theta.device)
    for k0 in range(0, k, chunk):
        c = min(chunk, k - k0)
        rows = theta.index_select(0, ids[:, k0:k0 + c].reshape(-1).long())
        terms = rows.view(n, c, -1) * vals[:, k0:k0 + c, None].to(rows.dtype)
        for j in range(c):
            z += terms[:, j]
    return z


def _chunked_zmap_int8(ids: torch.Tensor, vals: torch.Tensor,
                       codes: torch.Tensor, scales: torch.Tensor,
                       chunk: int | None = None) -> torch.Tensor:
    """Int8 plain forward: :func:`_chunked_zmap` with each gathered code
    row turned into fp32 by one multiply by its row scale, so the row
    values -- and z -- are IDENTICAL to :func:`_chunked_zmap` on the
    dequantised ``codes * scales`` Theta; only int8 rows are gathered."""
    n, k = ids.shape
    chunk = _chunk(ids, codes, chunk)
    z = torch.zeros((n, codes.shape[1]), dtype=torch.float32,
                    device=codes.device)
    for k0 in range(0, k, chunk):
        c = min(chunk, k - k0)
        flat = ids[:, k0:k0 + c].reshape(-1).long()
        rows = (codes.index_select(0, flat).to(torch.float32)
                * scales.index_select(0, flat)[:, None])
        terms = rows.view(n, c, -1) * vals[:, k0:k0 + c, None].to(rows.dtype)
        for j in range(c):
            z += terms[:, j]
    return z


def _on_card(model_tensor: torch.Tensor) -> bool:
    """True for a CUDA model (kernel), False for a CPU one (plain)."""
    if model_tensor.device.type == "cuda":
        return True
    if model_tensor.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {model_tensor.device}")


def _kernel_inputs(ids, vals):
    return (ids.to(torch.int32).contiguous(),
            vals.to(torch.float32).contiguous())


def _check_theta(theta: torch.Tensor) -> None:
    if theta.ndim != 2 or theta.shape[1] % 2:
        raise ValueError(f"theta must be (D, 2m), got {tuple(theta.shape)}")


def _check_int8_model(codes: torch.Tensor, scales: torch.Tensor) -> None:
    if codes.ndim != 2 or codes.shape[1] % 2:
        raise ValueError(f"codes must be (D, 2m), got {tuple(codes.shape)}")
    if codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {codes.dtype}")
    if tuple(scales.shape) != (codes.shape[0],):
        raise ValueError(f"scales must be ({codes.shape[0]},), got "
                         f"{tuple(scales.shape)}")


def _knobs(kernel, ids, rows):
    """The tune table's launch knobs of ``kernel`` at this call's shape."""
    return resolve_fused(kernel, *ids.shape, rows.shape[1], rows.device)


def _forward(ids, vals, theta, dedup):
    """(p or None, z): the kernel's pair on the card, z alone on the CPU."""
    _check_theta(theta)
    if _on_card(theta):
        return lsplm_sparse_fused_forward(
            *_kernel_inputs(ids, vals), theta.contiguous(), dedup=dedup,
            **_knobs("fused_fwd", ids, theta))
    return None, _chunked_zmap(ids, vals, theta)


def _forward_int8(ids, vals, codes, scales, dedup):
    _check_int8_model(codes, scales)
    if _on_card(codes):
        return lsplm_sparse_fused_int8_forward(
            *_kernel_inputs(ids, vals), codes.contiguous(),
            scales.contiguous(), dedup=dedup,
            **_knobs("fused_fwd_int8", ids, codes))
    return None, _chunked_zmap_int8(ids, vals, codes, scales)


class _GatherMatmul(torch.autograd.Function):
    """z = x @ Theta with the transposed scatter as its backward.

    Forward: B1 on the card (its in-kernel dedup when asked), the plain
    ``_chunked_zmap`` on the CPU. Backward: dTheta by
    ``scatter_add_planned`` when the batch's plan is given, else by
    ``scatter_add_unplanned`` (the card sorts the entries itself and runs
    the same kernel); dvals only when ``vals`` requires grad. ids and the
    plan get no gradient."""

    @staticmethod
    def forward(ctx, ids, vals, theta, plan, dedup):
        z = _forward(ids, vals, theta, dedup)[1]
        ctx.save_for_backward(ids, vals, theta)
        ctx.plan = plan
        return z

    @staticmethod
    def backward(ctx, dz):
        ids, vals, theta = ctx.saved_tensors
        plan = ctx.plan
        dz = dz.contiguous()
        return (None, *_scatter_backward(ctx, ids, vals, theta, plan, dz),
                None, None)


def _scatter_backward(ctx, ids, vals, theta, plan, dz):
    """(dvals, dTheta) from dz (N, 2m), each only when its input asks:
    dTheta by ``scatter_add_planned`` with the batch's plan, else by
    ``scatter_add_unplanned`` (the card sorts the entries itself and runs
    the same kernel)."""
    dvals = dtheta = None
    if ctx.needs_input_grad[2]:
        if plan is not None:
            dtheta = scatter_add_planned(plan, vals, dz)
        else:
            dtheta = scatter_add_unplanned(ids, vals, dz, theta.shape[0],
                                           theta.shape[0] - 1)
        dtheta = dtheta.to(theta.dtype)
    if ctx.needs_input_grad[1]:
        dvals = (dvals_planned(plan, theta, dz, tuple(ids.shape))
                 if plan is not None else dvals_unplanned(ids, theta, dz))
        dvals = dvals.to(vals.dtype)
    return dvals, dtheta


class _ForwardP(torch.autograd.Function):
    """p = Eq. 2 head of x @ Theta, fused, with the reference's p-level
    VJP (``_forward_p``). Forward: B1's own p on the card, the plain
    ``finalize_p`` of ``_chunked_zmap`` on the CPU. Backward: dz from the
    head's derivative at the saved z and p, then the scatter of
    :class:`_GatherMatmul`."""

    @staticmethod
    def forward(ctx, ids, vals, theta, plan, dedup):
        p, z = _forward(ids, vals, theta, dedup)
        if p is None:
            p = finalize_p(z)
        ctx.save_for_backward(ids, vals, theta, z, p)
        ctx.plan = plan
        return p

    @staticmethod
    def backward(ctx, dp):
        ids, vals, theta, z, p = ctx.saved_tensors
        m = z.shape[-1] // 2
        gate = torch.softmax(z[:, :m], dim=-1)
        fit = torch.sigmoid(z[:, m:])
        dp = dp.to(z.dtype)[:, None]
        dzu = dp * gate * (fit - p.to(z.dtype)[:, None])
        dzw = dp * gate * fit * (1.0 - fit)
        dz = torch.cat([dzu, dzw], dim=-1).contiguous()
        return (None, *_scatter_backward(ctx, ids, vals, theta, ctx.plan, dz),
                None, None)


def sparse_gather_matmul(ids, vals, theta, *, dedup: bool = True,
                         plan: TransposePlan | None = None) -> torch.Tensor:
    """z = x @ Theta from padded COO. (N, K) -> (N, 2m), differentiable in
    ``theta`` and ``vals``. Pass the batch's ``plan`` (built once per
    batch, on Theta's device) so the backward needs no sort.
    ``dedup=False`` skips the kernel path's duplicate-id collapse for
    batches known to be duplicate-free."""
    _check_plan(ids, theta, plan)
    return _GatherMatmul.apply(ids, vals, theta, plan, dedup)


def _check_plan(ids, theta, plan) -> None:
    _check_theta(theta)
    if plan is not None:
        plan.validate(tuple(ids.shape), theta.shape[0])
        if plan.device != theta.device:
            raise ValueError(f"the plan lies on {plan.device}, Theta on "
                             f"{theta.device}: move it once with "
                             "plan.to(device)")


def lsplm_sparse_forward(ids, vals, theta, *, dedup: bool = True,
                         plan: TransposePlan | None = None) -> torch.Tensor:
    """p(y=1|x) per Eq. 2 from padded COO, fully fused. Returns (N,),
    differentiable in ``theta`` and ``vals``; ``plan`` keeps the backward
    sort-free and leaves p's bits as they are."""
    _check_plan(ids, theta, plan)
    return _ForwardP.apply(ids, vals, theta, plan, dedup)


def sparse_gather_matmul_int8(ids, vals, codes, scales, *,
                              dedup: bool = True) -> torch.Tensor:
    """z = x @ (codes * scales) from padded COO without materialising fp32
    rows. ``codes`` is (D, 2m) int8 with the zero pad row at D-1,
    ``scales`` the (D,) per-row fp32 scales (pad row scale 0)."""
    return _forward_int8(ids, vals, codes, scales, dedup)[1]


def lsplm_sparse_forward_int8(ids, vals, codes, scales, *,
                              dedup: bool = True) -> torch.Tensor:
    """p(y=1|x) per Eq. 2 on int8 codes, fully fused. Returns (N,)."""
    p, z = _forward_int8(ids, vals, codes, scales, dedup)
    return finalize_p(z) if p is None else p


def lsplm_sparse_logps(ids, vals, theta, *, dedup: bool = True,
                       plan: TransposePlan | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable (log_p1, log_p0) for Eq. 5 on padded COO -- the training
    path, differentiable through :func:`sparse_gather_matmul`."""
    return logps_from_z(sparse_gather_matmul(ids, vals, theta, dedup=dedup,
                                             plan=plan))


def bundle_forward(user_ids, user_vals, ad_ids, ad_vals, session, *,
                   theta=None, codes=None, scales=None, dedup: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Session-shared (Eq. 13) forward of a bundle on the card, without a
    gradient: (p (B,), z (B, 2m)) with z = z_user[session] + z_ad, in two
    launches of B1 (``theta``) or B4 (``codes``/``scales``). The user
    rows' launch skips the head; the ad rows' launch adds their user row
    and applies it. Bitwise ``z_user.index_select(0, session) + z_ad``
    for z, and the kernel's own head for p. ``session`` (B,) is int32 or
    int64; a value outside [0, G) adds a zero row. Each launch takes the
    tune table's knobs at its own shape."""
    if theta is not None:
        _check_theta(theta)

        def run(ids, vals, **kw):
            return lsplm_sparse_fused_forward(
                *_kernel_inputs(ids, vals), theta.contiguous(), dedup=dedup,
                **_knobs("fused_fwd", ids, theta), **kw)
    else:
        _check_int8_model(codes, scales)

        def run(ids, vals, **kw):
            return lsplm_sparse_fused_int8_forward(
                *_kernel_inputs(ids, vals), codes.contiguous(),
                scales.contiguous(), dedup=dedup,
                **_knobs("fused_fwd_int8", ids, codes), **kw)
    z_user = run(user_ids, user_vals, head=False)[1]
    return run(ad_ids, ad_vals, z_add=z_user, session=session.contiguous())
