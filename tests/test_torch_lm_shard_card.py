"""Sharded LM serving (``models/sharding.py`` and the ``mesh=`` of the
serving entry points) on a CUDA card, held against the port's own
unsharded run on the same card.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_lm_shard_card.py``
(``chip_smoke.py`` phase 27). Every test needs a card and skips without
one. Reduced llama3.2-1b (B6), falcon-mamba-7b (B7's gated mode) and
granite-moe-1b-a400m (experts, ``token_gather``) in fp32 on a 2 x 2 mesh
of spawned ranks sharing the card over gloo: prefill logits within
rtol = atol = 1e-4 of the unsharded card run and greedy tokens equal,
every rank of a data shard bitwise equal, B6 launched once per layer and
prefill on each rank (on its 2 of 4 heads) and B7's gated mode likewise
(on its half of d_inner), ``Mesh.gather`` exact on bf16 card tensors; a
1 x 1 mesh bitwise the unsharded path in bf16.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.mamba_scan import mamba_scan as ms
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import sharding as SH
from repro_torch.models.generate import generate

ARCHS = ("llama3.2-1b", "falcon-mamba-7b", "granite-moe-1b-a400m")
B, S, NEW, TOL = 4, 32, 4, 1e-4
MODE = "token_gather"  # the MoE plan whose semantics are the unsharded one


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               dtype=dtype)


def _prompt(cfg):
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))


def _model(cfg, dev, mesh=None):
    return tmodels.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev, mesh=mesh)


def _rank(rank, dev, shape):
    """One rank of the mesh ``shape``: each family's prefill (its B6 and
    B7 launches counted) and greedy tokens, then a bf16 gather."""
    mesh = Mesh(*shape)
    out = {"data_rank": mesh.data_rank}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = _model(cfg, dev, mesh)
        toks = _prompt(cfg).to(dev)
        b6, b7 = fa.LAUNCHES["flash_attention"], ms.LAUNCHES[
            "mamba1_scan_gated"]
        logits, _ = tmodels.prefill(model, tokens=SH.batch_rows(toks, mesh),
                                    mesh=mesh, moe_serving_mode=MODE)
        torch.cuda.synchronize()
        launches = (fa.LAUNCHES["flash_attention"] - b6,
                    ms.LAUNCHES["mamba1_scan_gated"] - b7)
        tokens = generate(model, toks, NEW, temperature=0.0, mesh=mesh,
                          moe_serving_mode=MODE)
        out[arch] = {"logits": logits.cpu().numpy(),
                     "tokens": tokens.cpu().numpy(), "launches": launches}
    full = torch.arange(6 * 10 * shape[1], device=dev).reshape(6, -1).to(
        torch.bfloat16) / 7
    mine = full.chunk(shape[1], 1)[mesh.model_rank]
    out["gather_exact"] = bool(torch.equal(mesh.gather(mine, "model", 1),
                                           full))
    return out


@pytest.mark.cuda
def test_sharded_serving_matches_unsharded_on_card(cuda):
    want = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = _model(cfg, cuda)
        toks = _prompt(cfg).to(cuda)
        logits, _ = tmodels.prefill(model, tokens=toks)
        want[arch] = (logits.cpu().numpy(), generate(
            model, toks, NEW, temperature=0.0).cpu().numpy())
        del model
    torch.cuda.empty_cache()
    ranks = run_ranks(_rank, 4, (2, 2), device="cuda")
    for arch in ARCHS:
        cfg = _cfg(arch)
        logits, tokens = want[arch]
        first = {}
        for r in ranks:
            got = r[arch]
            rows = np.split(logits, 2)[r["data_rank"]]
            np.testing.assert_allclose(got["logits"], rows, rtol=TOL,
                                       atol=TOL)
            np.testing.assert_array_equal(got["tokens"], tokens)
            seen = first.setdefault(r["data_rank"], got["logits"])
            np.testing.assert_array_equal(got["logits"], seen)
            attention = 0 if cfg.family == "ssm" else cfg.num_layers
            scans = cfg.num_layers if cfg.family == "ssm" else 0
            assert got["launches"] == (attention, scans), arch
    assert all(r["gather_exact"] for r in ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_the_unsharded_path_on_card(cuda, arch):
    cfg, mesh = _cfg(arch, "bfloat16"), Mesh(1, 1)
    plain, meshed = _model(cfg, cuda), _model(cfg, cuda, mesh)
    toks = _prompt(cfg).to(cuda)
    a, _ = tmodels.prefill(plain, tokens=toks)
    b, _ = tmodels.prefill(meshed, tokens=toks, mesh=mesh)
    assert torch.equal(a, b)
    assert torch.equal(generate(plain, toks, NEW, temperature=0.0),
                       generate(meshed, toks, NEW, temperature=0.0,
                                mesh=mesh))
