"""The zoo's serving paths on a CUDA card, held against the port on the
CPU: rope near position 2^19 and a window decode there.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_lm_zoo_card.py``.
Every test needs a card and skips without one. At positions 524,280-
524,287 (the reference's ``long_500k`` decode) the fp32 angle pos *
inv_freq is ~5e5 rad, whose ulp is 2^-5; the card's fp32 ``pow`` and
the CPU's may give inverse frequencies an ulp or more apart, so the
tables there part by as many ulps of the angle (``ROADMAP.md`` C, a
departure): they are held to what the frequencies explain, and the
window decode there is held with the CPU's tables on both devices.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import decode_step, init_caches, init_model, prefill
from repro_torch.models import layers as L
from repro_torch.models.generate import fill_caches

POSITIONS = torch.arange(524_280, 524_288)
CPU_TOL = 1e-4  # fp32 logits, card vs CPU (chip_smoke.py LM_CPU_TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmo-1b", "mistral-nemo-12b",
                                  "zamba2-2.7b", "dbrx-132b"])
def test_rope_tables_part_only_as_their_frequencies_do(cuda, arch):
    """The card's tables against the CPU's at small positions and near
    2^19: apart by no more than cos/sin's own rounding (1e-6) plus 2k + 1
    ulps of the fp32 angle, where k is how many ulps the inverse
    frequencies of the two sides' fp32 ``pow`` lie apart (a position
    times a frequency's ulp is within two of the product's, and each
    product rounds once)."""
    cfg = get_config(arch)
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    inv = [(1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=d) / hd))).cpu()
           for d in ("cpu", cuda)]
    k = float(((inv[1] - inv[0]).abs()
               / torch.from_numpy(np.spacing(inv[0].numpy()))).max())
    for positions in (POSITIONS, torch.arange(0, 8192, 61)):
        ulp = torch.from_numpy(np.spacing(
            (positions[:, None].float() * inv[0]).numpy()))
        cpu = L.rope_cos_sin(positions, hd, theta)
        card = L.rope_cos_sin(positions.to(cuda), hd, theta)
        for want, got in zip(cpu, card):
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert bool(((got.cpu() - want).abs()
                         <= (2 * k + 1) * ulp + 1e-6).all())


@pytest.mark.cuda
def test_window_decode_near_2_19_matches_the_cpu(cuda, monkeypatch):
    """Reduced mistral-nemo (hd 128, rope theta 1e6) in fp32: a ring of
    64 slots filled by a prefill of 64 tokens, then window decode steps
    at positions 524,280-524,287, card (B6 in the prefill) against CPU
    on the same weights and the CPU's rope tables: logits within 1e-4,
    argmax equal."""
    cfg = dataclasses.replace(get_config("mistral-nemo-12b").reduced(),
                              head_dim=128, dtype="float32")
    W = cfg.sliding_window
    toks = torch.from_numpy(TokenStream(cfg.vocab_size, seed=1).batch(
        2, W + 9)["tokens"])
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = card.to(cuda)
    tables = L.rope_cos_sin
    monkeypatch.setattr(L, "rope_cos_sin", lambda p, hd, th: tuple(
        t.to(p.device) for t in tables(p.cpu(), hd, th)))
    got = {}
    for where, m in (("cpu", cpu), ("card", card)):
        t = toks.to(m.device)
        _, caches = prefill(m, tokens=t[:, :W])
        ring = fill_caches(init_caches(cfg, 2, W, dtype=torch.float32,
                                       device=m.device), caches)
        got[where] = [decode_step(m, ring, token=t[:, W + i], pos=int(p),
                                  window=True)[0].cpu()
                      for i, p in enumerate(POSITIONS)]
    for a, b in zip(got["card"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=CPU_TOL, atol=CPU_TOL)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
