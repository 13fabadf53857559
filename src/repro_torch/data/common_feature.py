"""Common-feature trick (§3.2) batch utilities.

The port's counterpart of ``repro/data/common_feature.py``. The trick
has three production aspects (paper list, §3.2):
  1. group samples of one session on the same worker,
  2. store common features once,
  3. compute the common part of Theta^T x once per session.

:func:`shard_sessions` implements (1) for a data-parallel split: sessions
go to workers as whole units so the per-worker gather stays local. (2)
and (3) live in ``CommonFeatureBatch`` + ``core.objective.
nll_common_feature``. The functions take the port's batch (tensors) and
return tensors on its device.
"""
from __future__ import annotations

import torch

from repro_torch.core.objective import CommonFeatureBatch


def memory_bytes(batch: CommonFeatureBatch, compressed: bool) -> int:
    """Storage cost of the two formats (Table 3 'Memory cost/node')."""
    xc, xnc, sid = batch.x_common, batch.x_noncommon, batch.session_id

    def nbytes(t):
        return t.numel() * t.element_size()

    if compressed:
        return nbytes(xc) + nbytes(xnc) + nbytes(sid)
    # decompressed: the user block repeated per sample
    return xc.element_size() * xnc.shape[0] * xc.shape[1] + nbytes(xnc)


def flops_per_eval(batch: CommonFeatureBatch, m: int, compressed: bool) -> int:
    """Dot-product FLOPs of one loss/grad evaluation (Table 3 'Time/iter').

    Common part: 2 * G * d_c * 2m (once per session) vs 2 * B * d_c * 2m.
    """
    g, d_c = batch.x_common.shape
    b, d_nc = batch.x_noncommon.shape
    common_rows = g if compressed else b
    return 2 * (common_rows * d_c + b * d_nc) * 2 * m


def shard_sessions(batch: CommonFeatureBatch,
                   num_shards: int) -> list[CommonFeatureBatch]:
    """Partition a compressed batch into per-worker batches, keeping
    sessions whole (aspect 1). Sessions are dealt round-robin; session
    ids are re-indexed locally."""
    sid = batch.session_id.long()
    dev = sid.device
    g = int(sid.max()) + 1 if sid.numel() else 0
    assignment = torch.arange(g, device=dev) % num_shards
    shards = []
    for s in range(num_shards):
        sessions = torch.nonzero(assignment == s).reshape(-1)
        remap = torch.full((g,), -1, dtype=torch.int64, device=dev)
        remap[sessions] = torch.arange(sessions.numel(), device=dev)
        mask = torch.isin(sid, sessions)
        shards.append(CommonFeatureBatch(
            x_common=batch.x_common[sessions],
            x_noncommon=batch.x_noncommon[mask],
            session_id=remap[sid[mask]].to(torch.int32),
            y=batch.y[mask]))
    return shards


def pad_to_multiple(batch: CommonFeatureBatch,
                    multiple: int) -> CommonFeatureBatch:
    """Pad samples (weight 0) so B divides the data axis; the padding
    carries zero weight, so the loss is unchanged. Always returns a
    batch with weights (ones for the real samples)."""
    b = batch.y.shape[0]
    pad = (-b) % multiple
    dev = batch.y.device
    w = torch.ones(b, dtype=torch.float32, device=dev)
    if pad == 0 and batch.weight is None:
        return CommonFeatureBatch(*batch[:4], weight=w)
    xnc = batch.x_noncommon
    return CommonFeatureBatch(
        x_common=batch.x_common,
        x_noncommon=torch.cat([xnc, xnc.new_zeros((pad, xnc.shape[1]))]),
        session_id=torch.cat([batch.session_id, torch.zeros(
            pad, dtype=torch.int32, device=dev)]),
        y=torch.cat([batch.y, torch.zeros(pad, dtype=torch.float32,
                                          device=dev)]),
        weight=torch.cat([w, torch.zeros(pad, dtype=torch.float32,
                                         device=dev)]))
