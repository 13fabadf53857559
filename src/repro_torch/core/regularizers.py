"""Regularisers of Eq. 4: elementwise L1 and row-group L2,1.

The port's counterpart of ``repro/core/regularizers.py``. The L2,1 group
is a feature row of Theta (the 2m parameters one input feature owns):
||Theta||_{2,1} = sum_i sqrt(sum_j Theta_ij^2).
"""
from __future__ import annotations

import torch


def l1_norm(theta: torch.Tensor) -> torch.Tensor:
    return theta.abs().sum()


def row_norms(theta: torch.Tensor) -> torch.Tensor:
    """(d,) row L2 norms; rows are the feature-group axis 0."""
    return torch.sqrt((theta * theta).sum(dim=tuple(range(1, theta.ndim))))


def l21_norm(theta: torch.Tensor) -> torch.Tensor:
    return row_norms(theta).sum()


def nonzero_count(theta: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    return (theta.abs() > tol).sum()


def nonzero_feature_count(theta: torch.Tensor,
                          tol: float = 0.0) -> torch.Tensor:
    """Features with any surviving parameter (Table 2's '#features')."""
    return (row_norms(theta) > tol).sum()
