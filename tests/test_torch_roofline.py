"""The port's roofline (``repro_torch.utils.roofline``) against the
reference's ``repro.utils.roofline``: ``model_flops_per_chip`` equal for
every config of the zoo; ``Roofline``'s terms equal the reference's
once the reference's TPU constants are rescaled to the H100's; the
port's constants the H100's; and the counts that stand in for XLA's cost
analysis, held against the port's own model shapes and against a FLOP
counter on a reduced model."""
import dataclasses

import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.launch import mesh as tmesh
from repro_torch.utils import roofline as R

REL = 1e-12


def _jax():
    import repro.configs as jconfigs
    from repro.launch import mesh as jmesh
    from repro.utils import roofline as JR

    return jconfigs, jmesh, JR


def test_constants_are_the_h100s():
    """NVIDIA H100 80GB HBM3 (SXM), 700 W: 989 TFLOP/s dense bf16, 3.35
    TB/s of device memory, NVLink 4's 18 links of 25 GB/s a direction."""
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.LINK_BW == 450e9


@pytest.mark.parametrize("kind,tokens,chips", [("train", 4 * 4096, 1),
                                               ("train", 4 * 512, 4),
                                               ("prefill", 4 * 512, 2)])
def test_model_flops_per_chip_is_the_references(kind, tokens, chips):
    jconfigs, _, JR = _jax()
    for arch in jconfigs.list_archs():
        want = JR.model_flops_per_chip(jconfigs.get_config(arch), kind,
                                       tokens, chips)
        got = R.model_flops_per_chip(tconfigs.get_config(arch), kind,
                                     tokens, chips)
        assert got == want, arch


@pytest.mark.parametrize("flops,hbm,coll,model", [
    (1e15, 1e10, 1e8, 6e14), (1e12, 1e12, 0.0, 5e11), (2e13, 1e9, 5e11,
                                                         1e13)])
def test_roofline_terms_are_the_references_rescaled(flops, hbm, coll, model):
    _, jmesh, JR = _jax()
    ref = JR.Roofline(flops, hbm, coll, model)
    got = R.Roofline(flops, hbm, coll, model)
    scale = {"t_compute": jmesh.PEAK_FLOPS_BF16 / tmesh.PEAK_FLOPS_BF16,
             "t_memory": jmesh.HBM_BW / tmesh.HBM_BW,
             "t_collective": jmesh.ICI_BW / tmesh.LINK_BW}
    for term, s in scale.items():
        assert getattr(got, term) == pytest.approx(getattr(ref, term) * s,
                                                   rel=REL)
    terms = {t: getattr(got, t) for t in scale}
    assert got.t_bound == max(terms.values())
    assert got.bottleneck == max(terms, key=terms.get).removeprefix("t_")
    assert got.useful_flops_ratio == ref.useful_flops_ratio
    assert got.mfu_bound == pytest.approx(
        model / tmesh.PEAK_FLOPS_BF16 / got.t_bound, rel=REL)
    assert got.to_dict().keys() == ref.to_dict().keys()
    assert R.Roofline(0.0, 0.0, 0.0, 0.0).mfu_bound == 0.0


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_matmul_params_are_the_models_shapes(arch):
    """matmul_params against the port's model on ``meta``: every 2-D
    weight a token multiplies (the hybrid's shared block once per group,
    the MoE's router and top_k of its E experts a layer), the embedding
    and the head aside."""
    cfg = tconfigs.get_config(arch)
    model = tmodels.Transformer(cfg, device="meta")
    n = 0
    for name, p in model.named_parameters():
        if name in ("embed", "lm_head") or p.dim() < 2 or name.endswith(
                ("conv_w", "A_log")):
            continue
        count = p.numel()
        if name.split(".")[-1] in ("w1", "w3", "w2") and cfg.num_experts:
            count = count // cfg.num_experts * cfg.top_k
        if name.startswith("shared."):
            count *= cfg.num_layers // cfg.shared_attn_every
        n += count
    assert R.matmul_params(cfg) == n


def _square_attention(cfg, B, S) -> int:
    """What the CPU's plain attention adds over the causal count in one
    forward: every score of the S x S square, in each of the two
    products."""
    units = cfg.num_layers // (cfg.shared_attn_every or 1)
    if cfg.family == "ssm":
        units = 0
    return units * 2 * B * cfg.num_heads * cfg.resolved_head_dim * S * (
        S - 1)


def _elementwise(cfg, B, S) -> int:
    """The Mamba convs' and Mamba1 scan's terms of one forward, which a
    FLOP counter (products only) does not see."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    conv = di if cfg.family == "ssm" else di + 2 * N
    scan = 6 * di * N if cfg.family == "ssm" else 0
    return cfg.num_layers * B * S * (2 * K * conv + scan)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_forward_flops_match_a_flop_counter(arch):
    """The forward's count, F + 2 T d V (every position's logits), against
    ``torch.utils.flop_counter`` on a reduced model's forward on the CPU
    (the square attention and the elementwise terms as in
    :func:`test_step_flops_match_a_flop_counter`): Mamba2's chunked SSD
    products included."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              dtype="float32")
    B, S = 2, 16
    model = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S))
    with FlopCounterMode(display=False) as counter:
        tmodels.forward(model, tokens=toks, remat=False)
    head = 2 * cfg.d_model * cfg.vocab_size
    want = (R.lm_step_flops(cfg, B, S, train=False) + (B * S - B) * head
            + _square_attention(cfg, B, S) - _elementwise(cfg, B, S))
    assert counter.get_total_flops() == want


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "falcon-mamba-7b"])
def test_step_flops_match_a_flop_counter(arch):
    """lm_step_flops on a reduced attention model against
    ``torch.utils.flop_counter`` over a training step's forward and
    backward on the CPU, with remat (the recompute counted, less each
    unit's last product, which torch's checkpoint does not rerun). The CPU's
    plain attention computes every score of the square, so the count is
    read with the S x S products in place of the causal S (S + 1) / 2;
    MoE expert products run on a capacity buffer (E x capacity rows, not
    top_k per token), so that term is counted from the buffer too. The
    counter sees products only: the Mamba1 scan's and the convs'
    elementwise terms are taken out of the count. (Mamba2's SSD is held
    in the forward alone: torch's backward of its broadcast products is
    not two of each forward product.)"""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import moe

    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              dtype="float32")
    B, S = 2, 16
    model = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu", trainable=True)
    toks = torch.randint(0, cfg.vocab_size, (B, S))
    with FlopCounterMode(display=False) as counter:
        tmodels.loss_and_grads(model, {"tokens": toks, "labels": toks})
    want = (R.lm_step_flops(cfg, B, S) + 4 * _square_attention(cfg, B, S)
            - 4 * _elementwise(cfg, B, S))
    if cfg.num_experts:  # w1, w3 and w2 in all 4 passes
        T, d, f = B * S, cfg.d_model, cfg.d_ff
        rows = cfg.num_experts * moe.capacity_for(T, cfg.num_experts,
                                                  cfg.top_k, 1.25)
        want += cfg.num_layers * 4 * 3 * 2 * d * f * (rows - cfg.top_k * T)
    assert counter.get_total_flops() == want


def test_train_hbm_bytes_count():
    cfg = tconfigs.get_config("llama3.2-1b")  # fp32 parameters, bf16 acts
    got = R.lm_train_hbm_bytes(cfg, 1000, 4, 512, 16)
    assert got == 4 * 2 * 4 * 1000 + 2 * 16 * 4 * 512 * cfg.d_model * 2
