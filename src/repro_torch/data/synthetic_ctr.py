"""Synthetic dense CTR data with the paper's session / common-feature
structure (§3.2, Fig. 3).

The port's counterpart of ``repro/data/synthetic_ctr.py``. A session is
one user page view showing ``ads_per_session`` ads: the user features
are COMMON to the session's samples, the ad features are per sample. The
planted click probability is PIECEWISE-LINEAR: the user vector picks one
of ``true_regions`` latent regions (argmax of a linear gating) and each
region has its own linear logit over the full feature vector -- the
function class LS-PLM, but not LR, represents. Noise columns carry no
signal, so the L1/L2,1 selection has something to find.

Every draw is numpy's ``default_rng`` in the reference's order, so the
arrays equal the reference's bit for bit; they are built on the host and
moved to ``device`` once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.objective import CommonFeatureBatch, CTRBatch
from repro_torch.eval.metrics import auc  # noqa: F401  (the reference's re-export)


@dataclasses.dataclass(frozen=True)
class CTRDataConfig:
    num_user_features: int = 48  # common block d_c
    num_ad_features: int = 48  # per-sample block d_nc
    density: float = 0.15  # fraction of active features per sample
    true_regions: int = 4  # ground-truth piecewise regions
    noise_features: int = 16  # appended pure-noise columns (in ad block)
    ads_per_session: int = 4
    label_noise: float = 0.02
    seed: int = 0

    @property
    def num_features(self) -> int:
        return (self.num_user_features + self.num_ad_features
                + self.noise_features)


def _sparse_block(rng: np.random.Generator, n: int, d: int,
                  density: float) -> np.ndarray:
    mask = rng.random((n, d)) < density
    vals = rng.normal(size=(n, d)) / np.sqrt(max(density * d, 1.0))
    return (mask * vals).astype(np.float32)


class PiecewiseLinearTruth:
    """The planted ground-truth model (host numpy)."""

    def __init__(self, cfg: CTRDataConfig, rng: np.random.Generator):
        d = cfg.num_features
        du = cfg.num_user_features
        self.gate = rng.normal(size=(du, cfg.true_regions)).astype(np.float32)
        w = rng.normal(size=(d, cfg.true_regions)).astype(np.float32) * 2.0
        if cfg.noise_features:  # noise features carry no signal
            w[-cfg.noise_features:, :] = 0.0
        self.w = w
        self.bias = (rng.normal(size=(cfg.true_regions,)).astype(np.float32)
                     * 0.5)
        self.du = du

    def proba(self, x: np.ndarray) -> np.ndarray:
        region = np.argmax(x[:, : self.du] @ self.gate, axis=-1)
        logits = (np.einsum("nd,dn->n", x, self.w[:, region])
                  + self.bias[region])
        return 1.0 / (1.0 + np.exp(-logits))


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def generate(cfg: CTRDataConfig, num_sessions: int, seed: int | None = None,
             *, device, with_dense: bool = True
             ) -> tuple[CommonFeatureBatch, torch.Tensor | None]:
    """(compressed common-feature batch, dense x), both on ``device``.

    The batch stores the user features once per session (G rows); the
    dense x repeats them per sample (B = G * ads_per_session rows) -- the
    two storage formats of Table 3. ``with_dense=False`` returns None in
    its place (the draws are the same), for callers that train on the
    batch alone and would only move the (B, d) copy for nothing."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    # the truth depends ONLY on cfg.seed, so different splits share it
    truth = PiecewiseLinearTruth(cfg, np.random.default_rng(cfg.seed + 7919))
    g, a = num_sessions, cfg.ads_per_session
    b = g * a
    x_user = _sparse_block(rng, g, cfg.num_user_features, cfg.density)
    x_ad = _sparse_block(rng, b, cfg.num_ad_features, cfg.density)
    x_noise = _sparse_block(rng, b, cfg.noise_features, cfg.density)
    x_nc = np.concatenate([x_ad, x_noise], axis=1)
    del x_ad, x_noise
    session_id = np.repeat(np.arange(g, dtype=np.int32), a)

    x_dense = np.concatenate([x_user[session_id], x_nc], axis=1)
    p = truth.proba(x_dense)
    p = (1 - cfg.label_noise) * p + cfg.label_noise * 0.5
    y = (rng.random(b) < p).astype(np.float32)

    batch = CommonFeatureBatch(
        x_common=_tensor(x_user, device), x_noncommon=_tensor(x_nc, device),
        session_id=_tensor(session_id, device), y=_tensor(y, device))
    return batch, (_tensor(x_dense, device) if with_dense else None)


def to_dense_batch(batch: CommonFeatureBatch) -> CTRBatch:
    """Decompress (the 'Without CF' storage format of Table 3), on the
    batch's device."""
    x = torch.cat([batch.x_common.index_select(0, batch.session_id.long()),
                   batch.x_noncommon], dim=1)
    return CTRBatch(x=x, y=batch.y)


def train_val_test(cfg: CTRDataConfig, sessions: tuple[int, ...],
                   seed: int = 0, *, device):
    """Disjoint 'days' as in Table 1: one :func:`generate` per entry of
    ``sessions`` (seeds ``seed * 1000 + i``)."""
    return [generate(cfg, n, seed=seed * 1000 + i, device=device)
            for i, n in enumerate(sessions)]
