"""Planned sparse scoring on a CUDA card: bitwise the unplanned call
(moved out of ``test_torch_serve.py``).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_serve_card.py``.
Every test needs a card and skips without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.serve import score as tscore

D, M = 4000, 4


@pytest.fixture(scope="module")
def theta():
    """A pruned-looking Theta: ~10% of rows alive, the rest exactly 0."""
    rng = np.random.default_rng(0)
    th = (rng.normal(size=(D, 2 * M)) * 0.3).astype(np.float32)
    th[rng.random(D) >= 0.1] = 0.0
    return th


def _planned_batches(seed):
    """The port's plan-carrying batch (``test_torch_serve.py``'s, without
    the reference's copy), and itself without plans."""
    from repro_torch.data.sparse import generate_sparse as tgenerate

    kw = dict(num_features=D, num_user_features_range=(D // 2, D),
              sessions=8, seed=seed)
    tb = tgenerate(**kw, device="cpu")
    assert tb.user_plan is not None and tb.ad_plan is not None
    return None, tb, tb._replace(user_plan=None, ad_plan=None)


@pytest.mark.cuda
def test_planned_scoring_bitwise_equals_unplanned_on_card(theta):
    """On the card a planned score_sparse / predict_proba_sparse returns
    the fused kernel's p, bit for bit the unplanned call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.core import lsplm as tlsplm

    _, tb, _ = _planned_batches(7)
    th = torch.from_numpy(theta).cuda()
    ids, vals = tb.ad_ids.cuda(), tb.ad_vals.cuda()
    plan = tb.ad_plan.to(th.device)
    bare = tscore.score_sparse(th, ids, vals)
    assert torch.equal(tscore.score_sparse(th, ids, vals, plan=plan), bare)
    params = tlsplm.params_from_theta(th)
    assert torch.equal(tlsplm.predict_proba_sparse(params, ids, vals,
                                                   plan=plan), bare)
    assert torch.equal(tlsplm.predict_proba_sparse(params, ids, vals), bare)
