"""Sparse CTR batches in padded COO, the paper's input format.

The port's counterpart of ``repro/data/sparse.py``. Each sample holds a
few dozen active feature ids out of ~10^6 columns:

    ids  (B, K) int32    active column ids (pad with id = d, value 0)
    vals (B, K) float32  feature values

with the common-feature trick (Eq. 13): user ids are stored once per
session (G, Ku) and gathered per sample, ad ids per sample (B, Ka).

The generator draws from numpy's ``default_rng`` in the reference's order,
so its arrays equal the reference's bit for bit. Transpose plans are built
on the host once per batch (:func:`build_batch_plans`) and moved to the
batch's device once; every optimizer step's backward then runs without a
sort. With ``shards=`` (a shard count or a ``repro_torch.shard.Partition``)
the planned batch is routed for a (data x model) mesh and a
``repro_torch.shard.ShardedSparseBatch`` is returned instead.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.objective import nll_sparse, smooth_loss_and_grad
from repro_torch.kernels.lsplm_sparse_scatter.plan import (
    TransposePlan,
    build_transpose_plan,
)


class SparseCTRBatch(NamedTuple):
    """A session-structured padded-COO batch on one device."""

    user_ids: torch.Tensor  # (G, Ku) int32, pad = num_features
    user_vals: torch.Tensor  # (G, Ku) float32
    ad_ids: torch.Tensor  # (B, Ka) int32
    ad_vals: torch.Tensor  # (B, Ka) float32
    session_id: torch.Tensor  # (B,) int32 in [0, G)
    y: torch.Tensor  # (B,) float32 in {0, 1}
    num_features: int = 0  # d
    # backward transpose plans (None -> the backward sorts per call)
    user_plan: TransposePlan | None = None
    ad_plan: TransposePlan | None = None

    @property
    def device(self) -> torch.device:
        return self.ad_ids.device


def _route(batch: SparseCTRBatch, shards, data_shards: int):
    """Coerce ``shards`` (a count or a Partition) and route the batch for
    a (data x model) mesh."""
    from repro_torch.shard.partition import (
        Partition,
        make_partition,
        route_batch,
    )

    part = shards if isinstance(shards, Partition) else make_partition(
        batch.num_features, int(shards))
    return route_batch(batch, part, data_shards=data_shards)


def build_batch_plans(batch: SparseCTRBatch, *, shards=None,
                      data_shards: int = 1):
    """Attach the per-batch transpose plans (one argsort per id tensor, on
    the host), moved to the batch's device. Plans address the PADDED Theta
    (d + 1 rows, pad id == d).

    With ``shards`` (a model-shard count or a ``repro_torch.shard.
    Partition``) the planned batch is ROUTED for a (data x model) mesh
    and a ``repro_torch.shard.ShardedSparseBatch`` is returned instead:
    ids bucketed per id-range shard and the plans sliced per (data block,
    id range) cell, without a second sort."""
    rows, pad = batch.num_features + 1, batch.num_features
    batch = batch._replace(
        user_plan=build_transpose_plan(batch.user_ids, rows,
                                       pad_id=pad).to(batch.device),
        ad_plan=build_transpose_plan(batch.ad_ids, rows,
                                     pad_id=pad).to(batch.device))
    if shards is None:
        return batch
    return _route(batch, shards, data_shards)


# ----------------------------------------------------------------- generator
def planted_id_weight(ids: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic latent weight per feature id (a hash of the id)."""
    h = (np.asarray(ids).astype(np.uint64) * np.uint64(2654435761)
         + np.uint64(salt))
    return (((h % np.uint64(10007)).astype(np.float64) / 10007.0) * 4.0
            - 2.0).astype(np.float32)


def planted_ctr_labels(user_ids, user_vals, ad_ids, ad_vals, session_id,
                       rng: np.random.Generator) -> np.ndarray:
    """Click labels from the planted piecewise-linear truth: hashed per-id
    weights; the user side selects one of 4 latent regions, which scales
    the ad-side weights."""
    regions = 4
    session_id = np.asarray(session_id)
    region_score = np.stack([
        (user_vals * planted_id_weight(user_ids, 31 * (r + 1))).sum(-1)
        for r in range(regions)], axis=-1)  # (G, regions)
    region = np.argmax(region_score, axis=-1)[session_id]  # (B,)
    gains = np.asarray([2.5, -2.5, 1.0, -1.0], np.float32)[region]
    base = (ad_vals * planted_id_weight(ad_ids, 7)).sum(-1) \
        + 0.5 * (user_vals * planted_id_weight(user_ids, 13)).sum(-1)[session_id]
    logits = gains * base
    p = 1 / (1 + np.exp(-logits))
    return (rng.random(session_id.shape[0]) < p).astype(np.float32)


def zipf_ids(rng: np.random.Generator, lo: int, hi: int,
             shape) -> np.ndarray:
    """int64 ids in [lo, hi) with the very hot head at ``lo`` that CTR id
    traffic has (``u ** 10``), the law of :func:`generate_sparse`."""
    u = rng.random(shape)
    r = (hi - lo) * (u ** 10.0)
    return (lo + r).astype(np.int64)


def generate_sparse(
    num_features: int = 1_000_000,
    num_user_features_range: tuple[int, int] = (600_000, 1_000_000),
    sessions: int = 512,
    ads_per_session: int = 4,
    active_user: int = 24,
    active_ad: int = 12,
    seed: int = 0,
    with_plans: bool = True,
    shards=None,
    data_shards: int = 1,
    *,
    device,
) -> SparseCTRBatch:
    """A million-column sparse CTR batch with session structure, on
    ``device``. Ids are Zipf-hot (``u ** 10``): one id carries about a
    quarter of each side's entries at the defaults.

    ``shards`` (a model-shard count or a ``repro_torch.shard.Partition``)
    routes the batch for a (data x model) mesh and returns a
    ``repro_torch.shard.ShardedSparseBatch`` on ``device`` (see
    :func:`build_batch_plans`)."""
    rng = np.random.default_rng(seed)
    d = num_features
    g, a = sessions, ads_per_session
    b = g * a
    user_lo = num_user_features_range[0]

    user_ids = zipf_ids(rng, user_lo, d, (g, active_user))
    ad_ids = zipf_ids(rng, 0, user_lo, (b, active_ad))
    user_vals = rng.normal(size=(g, active_user)).astype(np.float32) / np.sqrt(active_user)
    ad_vals = rng.normal(size=(b, active_ad)).astype(np.float32) / np.sqrt(active_ad)
    session_id = np.repeat(np.arange(g, dtype=np.int32), a)
    y = planted_ctr_labels(user_ids, user_vals, ad_ids, ad_vals,
                           session_id, rng)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    batch = SparseCTRBatch(
        user_ids=t(user_ids, torch.int32), user_vals=t(user_vals, torch.float32),
        ad_ids=t(ad_ids, torch.int32), ad_vals=t(ad_vals, torch.float32),
        session_id=t(session_id, torch.int32), y=t(y, torch.float32),
        num_features=d)
    if with_plans:
        return build_batch_plans(batch, shards=shards,
                                 data_shards=data_shards)
    if shards is not None:  # routed, unplanned backward
        return _route(batch, shards, data_shards)
    return batch


def to_dense(batch: SparseCTRBatch) -> np.ndarray:
    """Densify to a (B, d) numpy array (tests only)."""
    d = batch.num_features
    sid = batch.session_id.cpu().numpy()
    ad_ids = batch.ad_ids.cpu().numpy()
    b = ad_ids.shape[0]
    x = np.zeros((b, d), np.float32)
    uid = batch.user_ids.cpu().numpy()[sid]
    uval = batch.user_vals.cpu().numpy()[sid]
    np.add.at(x, (np.arange(b)[:, None], uid), uval)
    np.add.at(x, (np.arange(b)[:, None], ad_ids), batch.ad_vals.cpu().numpy())
    return x


def sparse_nll(theta: torch.Tensor, batch: SparseCTRBatch) -> torch.Tensor:
    """Eq. 5 on the sparse batch (see ``core.objective.nll_sparse``)."""
    return nll_sparse(theta, batch)


def sparse_loss_and_grad(theta: torch.Tensor, batch: SparseCTRBatch):
    """(loss, dloss/dTheta) of :func:`sparse_nll`."""
    return smooth_loss_and_grad(theta, batch)


def sparse_predict(theta, batch: SparseCTRBatch) -> torch.Tensor:
    """p(y=1|x) (B,) through the serving layer's session-shared path
    (``repro_torch.serve.score.predict``); ``theta`` may be a raw Theta or
    a pruned artifact."""
    from repro_torch.serve.score import predict

    return predict(theta, batch)
