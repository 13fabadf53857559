"""Sharded LM training (``loss_and_grads`` / ``make_train_step`` on a
(data, model) mesh, FSDP over ``data``) on a CUDA card, held against the
same ranks on the CPU.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda
tests/test_torch_lm_train_shard_card.py`` (``chip_smoke.py`` phase 27).
Every test needs a card and skips without one. Reduced llama3.2-1b in
fp32, trainable, on a 2 x 2 mesh of spawned ranks sharing the card over
gloo (B6 on each rank's heads, forward and recompute) against a 2 x 2
mesh of CPU ranks (B6's plain version): the loss within rtol 1e-5, every
gathered gradient leaf within 1e-4 max |g| + 1e-7, three AdamW steps'
losses within 1e-4 and the parameters within 2 lr n, B6 launched twice a
layer in a gradient on every card rank, every rank's loss bitwise equal.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import sharding as SH

ARCH, SHAPE, B, S = "llama3.2-1b", (2, 2), 4, 32
LOSS_RTOL, GRAD_REL, STEP_RTOL, LR, STEPS = 1e-5, 1e-4, 1e-4, 1e-3, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg():
    return dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                               dtype="float32")


def _rank(rank, dev):
    """One rank: the model drawn on the CPU from one seed and moved to
    ``dev``, its loss and gathered gradients (B6 counted), then STEPS
    updates and the gathered parameters."""
    mesh, cfg = Mesh(*SHAPE), _cfg()
    model = tmodels.Transformer(cfg, device=dev, trainable=True, mesh=mesh)
    model.load_state_dict(tmodels.init_model(
        cfg, torch.Generator().manual_seed(0), device="cpu", trainable=True,
        mesh=mesh).state_dict())
    raw = TokenStream(cfg.vocab_size, seed=0).batch(B, S + 1)
    rows = {k: SH.batch_rows(torch.from_numpy(v), mesh).to(dev)
            for k, v in raw.items()}
    b6 = fa.LAUNCHES["flash_attention"]
    loss, _, grads = tmodels.loss_and_grads(model, rows)
    launches = fa.LAUNCHES["flash_attention"] - b6
    cuts = model.leaf_specs()

    def gathered(tensors):
        return {n: SH.gather_block(t.detach(), cuts[n][0], mesh,
                                   cuts[n][1]).cpu().numpy()
                for n, t in tensors.items()}

    out = {"loss": float(loss), "launches": launches,
           "grads": gathered(grads)}
    opt, step = tmodels.make_train_step(model, lr=LR)
    state, losses = opt.init(dict(model.named_parameters())), []
    for _ in range(STEPS):
        state, m = step(state, rows)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["params"] = gathered(dict(model.named_parameters()))
    return out


@pytest.mark.cuda
def test_sharded_training_on_card_matches_cpu_ranks(cuda):
    with ThreadPoolExecutor(2) as pool:  # the two worlds at once
        card, cpu = (pool.submit(run_ranks, _rank, 4, device=d)
                     for d in ("cuda", "cpu"))
        card, cpu = card.result(), cpu.result()
    layers = _cfg().num_layers
    want = cpu[0]
    for r, got in enumerate(card):
        assert got["launches"] == 2 * layers, r
        assert got["loss"] == card[0]["loss"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=STEP_RTOL)
        for n, g in want["grads"].items():
            bar = GRAD_REL * np.abs(g).max() + 1e-7
            assert np.abs(got["grads"][n] - g).max() <= bar, n
        for n, p in want["params"].items():
            assert np.abs(got["params"][n] - p).max() <= 2 * LR * STEPS, n
