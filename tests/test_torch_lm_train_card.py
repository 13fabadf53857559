"""The LM training path on a CUDA card, held against the port itself.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_lm_train_card.py``.
Every test needs a card and skips without one. The gates:

  * B6's autograd Function (the kernel's forward, the plain version's
    chunked backward) against autograd of ``plain_attention`` on one
    output gradient: fp32 within 1e-6 max|g|, bf16 within one bf16 ulp
    of max|g|; one launch each;
  * B7's Function (the gated kernel's forward, the backward kernel's
    backward) against autograd of ``plain_gated_scan``: B6's bars; one
    launch of each;
  * the ctypes wrappers refuse a graph they would cut on the card too;
  * a reduced llama's loss and every gradient leaf, card against CPU on
    the same weights (loss rtol 1e-5, leaves within 1e-4 max|g| +
    1e-7), no leaf all zero (the graph is not cut at B6), and B6 twice
    per layer (forward and checkpointed recompute);
  * three train steps, card against CPU: losses rtol 1e-4, parameters
    within 2 lr n everywhere and 1e-6 on 99.9% of the elements.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels.flash_attention import flash_attention as tk_attn
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.mamba_scan import mamba_scan as tk_scan
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import init_model, loss_fn, make_train_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _bar(g, dtype):
    top = float(g.abs().max())
    if dtype == torch.float32:
        return 1e-6 * top
    return torch.finfo(dtype).eps * 2.0 ** np.floor(np.log2(top))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,kvh,hd", [(2, 600, 8, 2, 64),
                                          (1, 129, 4, 4, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_function_matches_plain_gradient(cuda, B, S, H, kvh, hd,
                                                   dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (_randn(gen, (B, S, h, hd), cuda, dtype)
                   for h in (H, kvh, kvh, H))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tk_attn.LAUNCHES["flash_attention"]
    o = attn_ops.causal_attention(*leaves, causal=causal, chunk=256)
    got = torch.autograd.grad(o, leaves, do)
    assert tk_attn.LAUNCHES["flash_attention"] == before + 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        attn_ops.plain_attention(*plain, causal=causal, chunk=256), plain,
        do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= _bar(
            w.float(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_scan_function_is_the_plain_gradient(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    Bq, S, di, N = 2, 48, 96, 16
    args = [3 * _randn(gen, (Bq, S, di), cuda), _randn(gen, (di,), cuda) - 3,
            _randn(gen, (Bq, S, di), cuda), _randn(gen, (Bq, S, N), cuda),
            _randn(gen, (Bq, S, N), cuda), 0.5 * _randn(gen, (di, N), cuda),
            _randn(gen, (di,), cuda), _randn(gen, (Bq, S, di), cuda),
            _randn(gen, (Bq, di, N), cuda)]
    for i in (0, 2, 3, 4, 7):
        args[i] = args[i].to(dtype)
    dy, dh = _randn(gen, (Bq, S, di), cuda, dtype), _randn(gen, (Bq, di, N),
                                                           cuda)
    grads = []
    for fn in (scan_ops.gated_selective_scan, scan_ops.plain_gated_scan):
        leaves = [a.clone().requires_grad_() for a in args]
        before = dict(tk_scan.LAUNCHES)
        y, hT = fn(*leaves)
        grads.append(torch.autograd.grad([y, hT], leaves, [dy, dh]))
        launched = {k: n - before[k] for k, n in tk_scan.LAUNCHES.items()}
        card = fn is scan_ops.gated_selective_scan
        assert launched == {"mamba1_scan": 0, "mamba1_scan_gated": card,
                            "mamba1_scan_gated_backward": card}
    for g, w in zip(*grads):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= _bar(
            w.float(), w.dtype)


@pytest.mark.cuda
def test_wrappers_refuse_a_graph_they_would_cut_on_the_card(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="ops.causal_attention"):
        tk_attn.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        assert tk_attn.flash_attention(q, q, q).grad_fn is None


def _reduced_pair(cuda, arch="llama3.2-1b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                     trainable=True)
    params = convert.params_to_reference(cpu)
    card = convert.model_from_reference(params, cfg, device=cuda,
                                        trainable=True)
    raw = TokenStream(cfg.vocab_size, seed=0).batch(2, 65)
    return cfg, cpu, card, raw


def _grads(model, batch):
    named = list(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss), {n: g.cpu() for (n, _), g in zip(named, grads)}


@pytest.mark.cuda
def test_reduced_loss_and_gradient_card_vs_cpu(cuda):
    cfg, cpu, card, raw = _reduced_pair(cuda)
    before = tk_attn.LAUNCHES["flash_attention"]
    l_card, g_card = _grads(card, {k: torch.from_numpy(v).to(cuda)
                                   for k, v in raw.items()})
    assert tk_attn.LAUNCHES["flash_attention"] - before == 2 * cfg.num_layers
    l_cpu, g_cpu = _grads(cpu, {k: torch.from_numpy(v)
                                for k, v in raw.items()})
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    assert set(g_card) == set(g_cpu)
    for name, w in g_cpu.items():
        g = g_card[name]
        assert bool(torch.isfinite(g).all()) and bool(g.any()), name
        assert float((g - w).abs().max()) <= 1e-4 * float(
            w.abs().max()) + 1e-7, name


@pytest.mark.cuda
def test_reduced_train_steps_card_vs_cpu(cuda):
    lr, steps = 1e-3, 3
    _, cpu, card, raw = _reduced_pair(cuda)
    losses = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, cuda)):
        opt, step = make_train_step(model, lr=lr)
        state = opt.init(dict(model.named_parameters()))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        losses[name] = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses[name].append(float(metrics["loss"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert losses["cuda"][-1] < losses["cuda"][0]
    card_p = dict(card.named_parameters())
    diffs = torch.cat([(card_p[n].detach().cpu() - p.detach()).abs().ravel()
                       for n, p in cpu.named_parameters()])
    assert float(diffs.max()) <= 2 * lr * steps
    assert float((diffs <= 1e-6).float().mean()) >= 0.999
