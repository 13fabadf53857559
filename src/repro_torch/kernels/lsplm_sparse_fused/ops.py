"""Public fused sparse LS-PLM ops (forward half): kernel or plain version.

The port's counterpart of ``repro/kernels/lsplm_sparse_fused/ops.py``
(``:79-135, 165-179, 371-504``):

  * ``sparse_gather_matmul(ids, vals, theta) -> z (N, 2m)`` — the region
    logits;
  * ``lsplm_sparse_forward(ids, vals, theta) -> p (N,)`` — fully fused
    probabilities;
  * ``sparse_gather_matmul_int8`` / ``lsplm_sparse_forward_int8`` — the
    same on an int8 model (``codes`` + per-row fp32 ``scales``) without
    materialising fp32 rows;
  * ``finalize_p`` / ``logps_from_z`` — the Eq. 2 head and the stable
    log-space Eq. 5 head on region logits.

Which implementation runs is decided by where the model lies and by
nothing else: a CUDA model launches the hand-written kernels
(``lsplm_sparse_fused.py``), after the ``dedup_tile_ids`` pre-pass when
``dedup=True``; a CPU model takes the plain versions below
(``_chunked_zmap`` / ``_chunked_zmap_int8``), which gather ``chunk`` slots
at a time with ``index_select`` and add them into z in slot order (the
pre-pass does not apply there, as on the reference's jnp path). There is
no fallback: a CUDA call launches its kernel or raises.

Serving needs no gradient, so no ``torch.autograd.Function`` wraps these
yet; the training slice adds one around the same forward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
    lsplm_sparse_fused_forward,
    lsplm_sparse_fused_int8_forward,
)

DEFAULT_CHUNK = 8  # slots gathered per step by the plain versions


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
    and the kernel then loads each hot row once per sample.

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


def _chunked_zmap(ids: torch.Tensor, vals: torch.Tensor, theta: torch.Tensor,
                  chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Plain forward z (N, 2m): gather ``chunk`` slots of rows at a time
    (``index_select``, int64 ids) and add their ``vals * row`` terms into
    z one slot at a time, in slot order -- so a row's z never depends on
    N or on the other rows. Pad slots add exact zeros."""
    n, k = ids.shape
    z = torch.zeros((n, theta.shape[1]), dtype=torch.float32,
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
                       chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Int8 plain forward: :func:`_chunked_zmap` with each gathered code
    row turned into fp32 by one multiply by its row scale, so the row
    values -- and z -- are IDENTICAL to :func:`_chunked_zmap` on the
    dequantised ``codes * scales`` Theta; only int8 rows are gathered."""
    n, k = ids.shape
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


def _kernel_inputs(ids, vals, pad_id: int, dedup: bool):
    ids = ids.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    if dedup:
        ids, vals = dedup_tile_ids(ids, vals, pad_id)
    return ids, vals


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


def _forward(ids, vals, theta, dedup):
    """(p or None, z): the kernel's pair on the card, z alone on the CPU."""
    _check_theta(theta)
    if _on_card(theta):
        ids, vals = _kernel_inputs(ids, vals, theta.shape[0] - 1, dedup)
        return lsplm_sparse_fused_forward(ids, vals, theta.contiguous())
    return None, _chunked_zmap(ids, vals, theta)


def _forward_int8(ids, vals, codes, scales, dedup):
    _check_int8_model(codes, scales)
    if _on_card(codes):
        ids, vals = _kernel_inputs(ids, vals, codes.shape[0] - 1, dedup)
        return lsplm_sparse_fused_int8_forward(
            ids, vals, codes.contiguous(), scales.contiguous())
    return None, _chunked_zmap_int8(ids, vals, codes, scales)


def sparse_gather_matmul(ids, vals, theta, *, dedup: bool = True
                         ) -> torch.Tensor:
    """z = x @ Theta from padded COO. (N, K) -> (N, 2m). ``dedup=False``
    skips the kernel path's duplicate-id collapse for batches known to be
    duplicate-free."""
    return _forward(ids, vals, theta, dedup)[1]


def lsplm_sparse_forward(ids, vals, theta, *, dedup: bool = True
                         ) -> torch.Tensor:
    """p(y=1|x) per Eq. 2 from padded COO, fully fused. Returns (N,)."""
    p, z = _forward(ids, vals, theta, dedup)
    return finalize_p(z) if p is None else p


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
