"""The dense LS-PLM path on a CUDA card against the CPU's: the Eq. 13
loss and gradient, and B5 through ``serve.predict`` (moved out of
``test_torch_dense.py``).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_dense_card.py``.
Every test needs a card and skips without one.
"""
import numpy as np
import pytest
import torch

from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch import serve as tserve
from repro_torch.kernels.lsplm_fused import lsplm_fused as b5

CF_FIELDS = ("x_common", "x_noncommon", "session_id", "y")
CFG = dict(num_user_features=24, num_ad_features=20, noise_features=6)


@pytest.fixture(scope="module")
def batches():
    """(None, port batch) of 64 sessions, as ``test_torch_dense.py``'s
    fixture without its reference side."""
    tb, _ = tdata.generate(tdata.CTRDataConfig(**CFG), 64, seed=1,
                           device="cpu")
    return None, tb


def _theta0(d, m, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).normal(size=(d, 2 * m))
            ).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_path_on_card_matches_cpu(cuda, batches):
    _, tb = batches
    cb = tdata.pad_to_multiple(tb, 1)
    gb = cb._replace(**{f: getattr(cb, f).to(cuda) for f in CF_FIELDS
                        + ("weight",)})
    theta = torch.from_numpy(_theta0(50, 12, seed=11))
    l_c, g_c = tcore.smooth_loss_and_grad(theta, cb, common_feature=True)
    l_g, g_g = tcore.smooth_loss_and_grad(theta.to(cuda), gb,
                                          common_feature=True)
    np.testing.assert_allclose(float(l_g), float(l_c), rtol=2e-5)
    g_scale = max(1.0, float(g_c.abs().max()))
    np.testing.assert_allclose(g_g.cpu().numpy() / g_scale,
                               g_c.numpy() / g_scale, atol=3e-5)
    x = tdata.to_dense_batch(tb).x
    before = b5.LAUNCHES["lsplm_fused_forward"]
    p_g = tserve.predict(theta.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert b5.LAUNCHES["lsplm_fused_forward"] == before + 1
    torch.testing.assert_close(p_g.cpu(), tserve.predict(theta, x),
                               rtol=1e-5, atol=1e-6)
