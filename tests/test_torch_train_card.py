"""The sparse training path's loss and gradient on a CUDA card: bitwise
repeatable, and at the repo's bars against the CPU's (moved out of
``test_torch_train.py``).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_train_card.py``.
Every test needs a card and skips without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import objective as tobj
from repro_torch.data import sparse as tsparse

D = 3000


def _gen_kwargs(d=D, sessions=96, seed=1):
    return dict(num_features=d, num_user_features_range=(int(0.6 * d), d),
                sessions=sessions, seed=seed)


def _theta0(d, m, seed=0):
    return (0.02 * np.random.default_rng(seed).normal(size=(d, 2 * m))
            ).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_loss_and_grad_bitwise_repeatable_on_card(cuda):
    kw = _gen_kwargs(d=20000, sessions=256)
    tb = tsparse.generate_sparse(**kw, device=cuda)
    cb = tsparse.generate_sparse(**kw, device="cpu")
    theta = torch.from_numpy(_theta0(20000, 12)).to(cuda)
    l1, g1 = tobj.smooth_loss_and_grad(theta, tb)
    l2, g2 = tobj.smooth_loss_and_grad(theta, tb)
    torch.cuda.synchronize()
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    lc, gc = tobj.smooth_loss_and_grad(theta.cpu(), cb)
    np.testing.assert_allclose(float(l1), float(lc), rtol=2e-5)
    g_scale = max(1.0, float(gc.abs().max()))
    np.testing.assert_allclose(g1.cpu().numpy() / g_scale,
                               gc.numpy() / g_scale, atol=3e-5)
