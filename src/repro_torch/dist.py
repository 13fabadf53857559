"""Distribution plan: the paper's worker/server split as a (data, model)
mesh of ``torch.distributed`` ranks.

The port's counterpart of ``repro/dist.py``. Where the reference lets
GSPMD place whole arrays by ``PartitionSpec``, a rank of the port holds
only its own block:

  * batch rows -> ``data`` (the paper's workers): a rank keeps the
    sessions and samples of its data block;
  * Theta rows -> ``model`` (the paper's parameter servers): a rank keeps
    the rows of its id range in the padded layout
    (``shard.Partition.pad_rows``), and its rows of the L-BFGS history;
    feature rows are the L2,1 groups, so the orthant and direction
    algebra stays rank-local;
  * the feature (contraction) columns of a dense x follow Theta's rows, so
    each product is summed once over ``model``.

Sparse batches are routed on the host (``shard.route_batch``) and a rank
takes its cell (:func:`shard_sparse_batch`); the step is
``shard.step``'s. The reference's ``*_specs`` (``PartitionSpec`` trees
for GSPMD) have no counterpart: the ``shard_*`` functions cut a rank's
blocks.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.objective import (
    CommonFeatureBatch,
    CTRBatch,
    _nll_from_logps,
)
from repro_torch.kernels.lsplm_sparse_fused.ops import logps_from_z
from repro_torch.launch.mesh import sum_fp32
from repro_torch.optim.owlqn_plus import OWLQNPlus, OWLQNState
from repro_torch.shard.partition import Partition, make_partition
from repro_torch.shard.step import loss_fns


def _columns(x: torch.Tensor, lo: int, hi: int, width: int) -> torch.Tensor:
    """Columns [lo, hi) of x, zero columns after them up to ``width``."""
    cols = x[:, lo:hi]
    if cols.shape[1] < width:
        cols = torch.cat([cols, cols.new_zeros((x.shape[0],
                                                width - cols.shape[1]))], 1)
    return cols.contiguous()


def shard_batch(mesh, batch, *, common_feature: bool = False,
                partition: Partition | None = None, device=None):
    """This rank's block of a dense batch, on ``device`` (default: the
    batch's): its data block's rows and the feature columns of its id range
    in the padded layout of ``partition`` (default ``make_partition(d,
    mesh.model)``), zero columns in the pad rows' places.

    ``CTRBatch``: rows [b B/Dd, (b+1) B/Dd). ``CommonFeatureBatch``:
    sessions [b G/Dd, (b+1) G/Dd) of x_common and the samples of those
    sessions, session ids rebased; G must divide by ``mesh.data``. The
    common columns come first in Theta's rows, so the block's Theta rows
    split at ``x_common``'s local width, as ``nll_common_feature``
    splits the whole Theta."""
    dev = None if device is None else torch.device(device)
    if common_feature:
        d_c = batch.x_common.shape[1]
        d = d_c + batch.x_noncommon.shape[1]
    else:
        d = batch.x.shape[1]
    part = make_partition(d, mesh.model) if partition is None else partition
    if part.num_rows != d or part.num_shards != mesh.model:
        raise ValueError(f"partition {part} does not cut d={d} columns over "
                         f"model={mesh.model}")
    lo, hi = part.ranges()[mesh.model_rank]
    R, b, Dd = part.rows_per_shard, mesh.data_rank, mesh.data

    def to(t):
        return None if t is None else (t if dev is None else t.to(dev))

    if not common_feature:
        B = batch.x.shape[0]
        if B % Dd:
            raise ValueError(f"{B} rows do not divide over data={Dd}")
        rows = slice(b * (B // Dd), (b + 1) * (B // Dd))
        return CTRBatch(x=to(_columns(batch.x[rows], lo, hi, R)),
                        y=to(batch.y[rows]),
                        weight=to(None if batch.weight is None
                                  else batch.weight[rows]))
    G = batch.x_common.shape[0]
    if G % Dd:
        raise ValueError(f"{G} sessions do not divide over data={Dd}")
    G_l = G // Dd
    sid = batch.session_id.long()
    mine = (sid // G_l) == b
    c_hi = min(hi, d_c)
    x_c = batch.x_common[b * G_l:(b + 1) * G_l, lo:max(lo, c_hi)]
    x_nc = _columns(batch.x_noncommon[mine], max(lo, d_c) - d_c,
                    max(hi, d_c) - d_c, R - x_c.shape[1])
    return CommonFeatureBatch(
        x_common=to(x_c.contiguous()), x_noncommon=to(x_nc),
        session_id=to((sid[mine] - b * G_l).to(torch.int32)),
        y=to(batch.y[mine]),
        weight=to(None if batch.weight is None else batch.weight[mine]))


def sharded_nll(theta: torch.Tensor, batch, mesh, *,
                common_feature: bool = False) -> torch.Tensor:
    """Eq. 5 NLL of the whole dense batch from this rank's block: the
    rank's partial products x_block @ Theta_block, one sum over ``model``,
    the block's NLL, one sum over ``data`` (``nll_common_feature`` /
    ``nll`` with the two sums put in)."""
    if common_feature:
        d_c = batch.x_common.shape[-1]
        z_c = batch.x_common @ theta[:d_c]
        z = z_c[batch.session_id.long()] + batch.x_noncommon @ theta[d_c:]
    else:
        z = batch.x @ theta
    z = sum_fp32(z, mesh, "model")
    log_p1, log_p0 = logps_from_z(z)
    loss = _nll_from_logps(log_p1, log_p0, batch.y.to(log_p1.dtype),
                           batch.weight)
    return sum_fp32(loss, mesh, "data")


def make_sharded_dense_loss(batch, mesh, *, common_feature: bool = False):
    """``(loss_and_grad, loss)`` (``shard.step.loss_fns``) of
    :func:`sharded_nll` on this rank's block (from :func:`shard_batch`)."""
    return loss_fns(lambda theta: sharded_nll(
        theta, batch, mesh, common_feature=common_feature), mesh)


def shard_sparse_batch(mesh, sbatch, device=None):
    """This rank's cell of a routed sparse batch (``ShardCell``), its
    tensors and plans moved to ``device``."""
    if sbatch.num_shards != mesh.model or sbatch.data_shards != mesh.data:
        raise ValueError(
            f"batch routed for (data={sbatch.data_shards}, "
            f"model={sbatch.num_shards}) but mesh is (data={mesh.data}, "
            f"model={mesh.model})")
    return sbatch.cell(mesh.data_rank, mesh.model_rank, device)


def shard_state(state: OWLQNState, mesh, device=None) -> OWLQNState:
    """This rank's block of an optimizer state whose Theta is the whole
    padded layout (``Partition.pad_rows``): rows [j R, (j+1) R) of Theta,
    prev_theta, prev_d and the history's (s, y), with j = the rank's
    ``model_rank``, on ``device`` (default: where they are)."""
    rows = state.theta.shape[0]
    if rows % mesh.model:
        raise ValueError(f"{rows} padded rows do not divide over "
                         f"model={mesh.model}")
    R, j = rows // mesh.model, mesh.model_rank

    def block(t, axis=0):
        out = t.narrow(axis, j * R, R).clone()
        return out if device is None else out.to(device)

    h = state.history
    hist = dataclasses.replace(
        h, s=block(h.s, 1), y=block(h.y, 1),
        rho=h.rho.clone() if device is None else h.rho.to(device),
        gamma=h.gamma.clone() if device is None else h.gamma.to(device),
        valid=list(h.valid))
    return state._replace(theta=block(state.theta), history=hist,
                          prev_theta=block(state.prev_theta),
                          prev_d=block(state.prev_d))


def make_distributed_step(opt: OWLQNPlus, mesh):
    """The step of ``opt`` on a row-sharded state: the same optimizer
    built with ``reduce=mesh.sum_model``, so its global reductions are
    summed over ``mesh``'s ``model`` group."""
    return OWLQNPlus(opt.loss_and_grad, opt.lam, opt.beta,
                     memory=opt.memory, c1=opt.c1, max_ls=opt.max_ls,
                     ls_shrink=opt.ls_shrink, loss=opt.loss,
                     reduce=mesh.sum_model).step
