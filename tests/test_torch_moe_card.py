"""The MoE family on a CUDA card (moved out of ``tests/test_torch_moe.py``,
whose CPU tests hold the port against the JAX reference).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_moe_card.py``
(``chip_smoke.py`` phase 27). Every test needs a card and skips without
one: the combine has one writer per token and no atomics, so two
prefills give the same bits, and the card's fp32 logits are within 1e-4
of the CPU's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_logits_bitwise_repeatable_on_card(cuda, dtype):
    """The combine has one writer per token and no atomics: two prefills
    of the same tokens give the same bits, and the card's fp32 logits are
    within 1e-4 of the CPU's."""
    cfg = dataclasses.replace(
        tconfigs.get_config("granite-moe-1b-a400m").reduced(), dtype=dtype)
    cpu = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    card = tmodels.Transformer(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(_tokens(cfg, 9, (4, 96)))
    a, _ = tmodels.prefill(card, tokens=toks.to(cuda))
    b, _ = tmodels.prefill(card, tokens=toks.to(cuda))
    assert torch.equal(a, b)
    if dtype == "float32":
        want, _ = tmodels.prefill(cpu, tokens=toks)
        torch.testing.assert_close(a.cpu(), want, rtol=1e-4, atol=1e-4)
