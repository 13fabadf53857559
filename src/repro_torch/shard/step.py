"""Distributed sparse loss and gradient: the paper's worker/server split on
a (data, model) mesh of ``torch.distributed`` ranks.

The port's counterpart of ``repro/shard/step.py``. Each rank runs exactly
the single-device fused path on its own block: its rows of Theta (its id
range, padded, with the local pad row at index R), its data block's routed
(ids, vals) and its cell of the transpose plans. B1 gathers z on each
side (``sparse_gather_matmul``) and, in the backward, B2 writes dTheta of
this rank's rows from the cell plan; the kernels are the single-device
path's own, called on local ids. The cross-rank traffic is

  * one all-reduce of the (B_local, 2m) region-logit PARTIALS over
    ``model`` (each server shard adds the rows it owns);
  * one all-reduce of the block's NLL over ``data``;
  * in the gradient, one all-reduce of this rank's dTheta block over
    ``data``: every worker's block contributes to the rows it touches.

Both forward all-reduces go through ``launch.mesh.sum_fp32``, whose
backward passes the cotangent through unchanged, because everything after
each sum is replicated over its axis. The data-axis dTheta sum is then
explicit (:func:`loss_fns`); without it each rank would keep only its own
block's share of the gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core.objective import _nll_from_logps
from repro_torch.kernels.lsplm_sparse_fused.ops import (
    logps_from_z,
    pad_theta,
    sparse_gather_matmul,
)
from repro_torch.launch.mesh import sum_fp32
from repro_torch.shard.partition import ShardCell, ShardedSparseBatch


def _check_mesh(mesh, cell: ShardCell) -> None:
    """The cell's (data, model) factorisation and place must be the
    mesh's and this rank's: another factorisation would alias a local pad
    id with a real Theta row, another rank's cell would train the wrong
    rows."""
    if cell.num_shards != mesh.model or cell.data_shards != mesh.data:
        raise ValueError(
            f"batch routed for (data={cell.data_shards}, "
            f"model={cell.num_shards}) but mesh is (data={mesh.data}, "
            f"model={mesh.model}): re-route with matching shard counts")
    if (cell.data_rank, cell.model_rank) != (mesh.data_rank,
                                             mesh.model_rank):
        raise ValueError(
            f"cell ({cell.data_rank}, {cell.model_rank}) handed to rank "
            f"({mesh.data_rank}, {mesh.model_rank})")


def _cell(sbatch, mesh) -> ShardCell:
    if isinstance(sbatch, ShardedSparseBatch):
        sbatch = sbatch.cell(mesh.data_rank, mesh.model_rank)
    _check_mesh(mesh, sbatch)
    return sbatch


def sharded_sparse_nll(theta: torch.Tensor, sbatch, mesh) -> torch.Tensor:
    """Eq. 5 NLL of the whole routed batch from this rank's block.

    ``theta`` is this rank's (rows_per_shard, 2m) block of the padded
    layout (``Partition.pad_rows``, then ``shard_rows``); ``sbatch`` its
    :class:`~repro_torch.shard.partition.ShardCell` (or the routed batch,
    whose cell is taken). Differentiable in ``theta``: the gradient is
    this rank's share (its data block's), which
    :func:`sharded_sparse_loss_and_grad` sums over ``data``."""
    cell = _cell(sbatch, mesh)
    b = cell.batch
    if theta.shape[0] != cell.rows_per_shard:
        raise ValueError(
            f"theta block has {theta.shape[0]} rows; the routed batch "
            f"expects rows_per_shard = {cell.rows_per_shard}")
    tp = pad_theta(theta)  # local zero pad row at index R
    z_user = sparse_gather_matmul(b.user_ids, b.user_vals, tp,
                                  plan=b.user_plan)
    z_ad = sparse_gather_matmul(b.ad_ids, b.ad_vals, tp, plan=b.ad_plan)
    # one reduction: every server shard's partial logits of the block
    z = sum_fp32(z_user[b.session_id.long()] + z_ad, mesh, "model")
    log_p1, log_p0 = logps_from_z(z)
    nll = _nll_from_logps(log_p1, log_p0, b.y.to(log_p1.dtype))
    return sum_fp32(nll, mesh, "data")


def loss_fns(nll, mesh):
    """``(loss_and_grad, loss)`` of a rank's ``nll(theta)`` (the global
    NLL from this rank's block): the callables
    :class:`~repro_torch.optim.owlqn_plus.OWLQNPlus` takes. The gradient
    is this rank's rows of dTheta, all-reduced over ``data``; ``loss``
    takes no gradient (the line search)."""
    def loss_and_grad(theta):
        leaf = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            value = nll(leaf)
        (grad,) = torch.autograd.grad(value, leaf)
        return value.detach(), mesh.all_reduce_(grad, "data")

    def loss(theta):
        with torch.no_grad():
            return nll(theta)

    return loss_and_grad, loss


def sharded_sparse_loss_and_grad(theta: torch.Tensor, sbatch, mesh
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(NLL, this rank's rows of dTheta), both detached: the smooth part
    the sharded OWLQN+ consumes. The block's gradient is all-reduced over
    ``data`` here."""
    return make_sharded_sparse_loss(sbatch, mesh)[0](theta)


def make_sharded_sparse_loss(sbatch, mesh):
    """``(loss_and_grad, loss)`` (:func:`loss_fns`) of
    :func:`sharded_sparse_nll`, bound to this rank's cell and the mesh.
    Compose with ``dist.make_distributed_step`` so the optimizer's own
    reductions run over the mesh too."""
    cell = _cell(sbatch, mesh)
    return loss_fns(lambda theta: sharded_sparse_nll(theta, cell, mesh),
                    mesh)
