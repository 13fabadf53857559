"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_lsplm``,
``utils/memtrack.py``, ``utils/collectives.py``, ``configs.input_specs``
and the B3/B6/B7 operators' fakes) against the reference and against
real runs of the same steps.

This machine's torch has no CUDA, and while it can make a fake CUDA
tensor it cannot index or differentiate one; so the traces here run the
CPU's paths (``device="cpu"``: the plain versions) on fake CPU tensors,
at the reference test's tiny shapes (``tests/test_dryrun_small.py``),
and the operators' fakes are held on fake CUDA tensors one call at a
time. The card's paths are traced in ``chip_smoke.py``.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.launch import dryrun, dryrun_lsplm
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SH
from repro_torch.utils import collectives, memtrack
from repro_torch.utils import roofline as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference test's shapes and reduced archs (tests/test_dryrun_small.py)
SMALL_SHAPES = {
    "train_4k": dict(kind="train", seq_len=64, global_batch=4),
    "prefill_32k": dict(kind="prefill", seq_len=64, global_batch=4),
    "decode_32k": dict(kind="decode", seq_len=64, global_batch=4),
    "long_500k": dict(kind="decode", seq_len=256, global_batch=1),
}
SMALL_ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "falcon-mamba-7b",
               "zamba2-2.7b", "musicgen-medium", "internvl2-2b"]


def _small(arch):
    cfg = tconfigs.get_config(arch).reduced()
    return dataclasses.replace(
        cfg, num_prefix_embeds=min(cfg.num_prefix_embeds, 8),
        attn_chunk=32, sliding_window=32)


@pytest.fixture
def small_shapes(monkeypatch):
    """The workload shapes cut to the reference test's, for one test."""
    for name, spec in SMALL_SHAPES.items():
        monkeypatch.setitem(tconfigs.INPUT_SHAPES, name, spec)


def _trace(arch, shape, mesh=(2, 2), rank=0):
    cfg = _small(arch)
    with dryrun.fake_world(*mesh, rank=rank) as m:
        tr = dryrun.trace_combo(cfg, shape, m, device="cpu")
        return dryrun.analyse(arch, shape, "x".join(map(str, mesh)), tr,
                              cfg, m)


# ------------------------------------------------------------ input_specs
@pytest.mark.parametrize("shape", list(tconfigs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_input_specs_are_the_references(arch, shape):
    """Leaf for leaf, the reference's names, shapes and dtypes, exactly."""
    import jax.numpy as jnp

    import repro.configs as jconfigs

    want = jconfigs.input_specs(jconfigs.get_config(arch), shape)
    got = tconfigs.input_specs(tconfigs.get_config(arch), shape)
    dtypes = {jnp.dtype(jnp.int32): torch.int32,
              jnp.dtype(jnp.bfloat16): torch.bfloat16}
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape), name
        assert got[name].dtype == dtypes[jnp.dtype(leaf.dtype)], name
        assert got[name].device.type == "meta"


# ------------------------------------------------------------- the traces
@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_reduced_archs_trace_on_a_fake_2x2_world(small_shapes, arch):
    """Every shape of every reduced arch of the reference test builds and
    runs on a fake 2 x 2 world: FLOPs, memory and (training, prefill)
    collectives above zero, the categories summing to the peak, and on
    the CPU's paths no B6 or B7 call."""
    for shape, spec in SMALL_SHAPES.items():
        rec = _trace(arch, shape)
        mem, r = rec["memory"], rec["roofline"]
        assert r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0, shape
        assert mem["total_bytes_per_chip"] > 0
        assert sum(mem["peak_by_category"].values()) == \
            mem["total_bytes_per_chip"]
        assert mem["peak_by_category"]["parameters"] > 0
        assert (mem["peak_by_category"]["gradients"] > 0) == (
            spec["kind"] == "train"), shape
        assert rec["collectives"]["total_bytes"] > 0, shape
        assert rec["kernel_calls"] == {}
        assert rec["kind"] == spec["kind"] and rec["chips"] == 4


def _real_counts(rank, dev, cases):
    """On a real gloo 2 x 2 world: each case's step (a training step of
    make_train_step, or a prefill), the mesh's counts around it, and the
    rank's parameter bytes."""
    mesh = Mesh(2, 2)
    out = {}
    for arch, shape in cases:
        spec = SMALL_SHAPES[shape]
        cfg = dryrun.placeable(_small(arch), mesh)
        train = spec["kind"] == "train"
        model = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                                   device=dev, trainable=train, mesh=mesh)
        B, S = spec["global_batch"], spec["seq_len"]
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
        rows = SH.batch_rows(toks, mesh)
        if train:
            opt, step = tmodels.make_train_step(model, mesh=mesh)
            state = opt.init(dict(model.named_parameters()))
            mesh.reset_counts()
            step(state, {"tokens": rows, "labels": rows})
        else:
            mesh.reset_counts()
            tmodels.prefill(model, tokens=rows, mesh=mesh)
        out[(arch, shape)] = {
            "by_axis": collectives.by_axis(mesh),
            "layout": collectives.collective_bytes(mesh),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
    return out


COUNT_CASES = (("llama3.2-1b", "train_4k"),
               ("granite-moe-1b-a400m", "prefill_32k"))


@pytest.fixture(scope="module")
def real_counts():
    return run_ranks(_real_counts, 4, COUNT_CASES)


@pytest.mark.parametrize("case", COUNT_CASES)
def test_fake_collectives_equal_a_gloo_run(small_shapes, real_counts,
                                           case):
    """The fake 2 x 2 trace's all-reduces and bytes, per axis and with
    the FSDP gathers and reduce-scatters among them, equal those of the
    same step on a real gloo world, exactly."""
    rec = _trace(*case)
    assert rec["collectives_by_axis"] == real_counts[0][case]["by_axis"]
    assert rec["collectives"] == real_counts[0][case]["layout"]
    assert rec["collectives"]["all-reduce"]["count"] > 0


@pytest.mark.parametrize("case", COUNT_CASES)
def test_parameter_bytes_are_a_real_ranks_blocks(small_shapes, real_counts,
                                                 case):
    """Each rank's parameters (the trace's ``parameters`` category,
    traced as that rank of the fake world) are the real rank's blocks,
    byte for byte."""
    for rank in range(4):
        rec = _trace(*case, rank=rank)
        got = rec["memory"]["argument_by_category"]["parameters"]
        assert got == real_counts[rank][case]["param_bytes"], rank


def _square_attention(cfg, B, S) -> int:
    """What the CPU's plain attention adds over the causal count in one
    forward (``tests/test_torch_roofline.py``): every score of the S x S
    square, in each of the two products."""
    return cfg.num_layers * 2 * B * cfg.num_heads * cfg.resolved_head_dim \
        * S * (S - 1)


def _scan_terms(cfg, B, S) -> int:
    """Mamba1's conv and scan terms of one forward, which a FLOP counter
    (products only) does not see."""
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return cfg.num_layers * B * S * (2 * K * di + 6 * di * N)


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", "train_4k"),
                                        ("granite-moe-1b-a400m", "train_4k"),
                                        ("llama3.2-1b", "prefill_32k"),
                                        ("falcon-mamba-7b", "prefill_32k")])
def test_traced_flops_are_lm_step_flops(small_shapes, arch, shape):
    """The bar: exact. On the CPU's paths a trace's FLOPs on one rank are
    ``roofline.lm_step_flops`` plus only what ``test_torch_roofline.py``
    names and counts from the shapes: the plain attention's S x S square
    (4 times in a step: forward, recompute, and the backward's two
    products of each), the MoE buffer's empty slots, and less the Mamba1
    conv's and scan's elementwise terms, which a FLOP counter does not
    see (Mamba1's prefill has no attention and no MoE)."""
    cfg = _small(arch)
    spec = SMALL_SHAPES[shape]
    B, S = spec["global_batch"], spec["seq_len"]
    rec = _trace(arch, shape, mesh=(1, 1))
    train = spec["kind"] == "train"
    passes = 4 if train else 1
    want = R.lm_step_flops(cfg, B, S, train=train)
    if cfg.family == "ssm":
        want -= _scan_terms(cfg, B, S)
    else:
        want += passes * _square_attention(cfg, B, S)
    if cfg.num_experts:  # w1, w3 and w2 on the capacity buffer
        T, d, f = B * S, cfg.d_model, cfg.d_ff
        rows = cfg.num_experts * MOE.capacity_for(T, cfg.num_experts,
                                                  cfg.top_k, 1.25)
        want += cfg.num_layers * passes * 3 * 2 * d * f * (
            rows - cfg.top_k * T)
    assert rec["roofline"]["flops_per_chip"] == want


def test_meshes_and_placement():
    """The three mesh names, and ``head_dim`` where the KV heads do not
    divide by ``model`` (the port's ``heads`` layout refuses that mesh)."""
    assert dryrun.mesh_shape("single") == (16, 16)
    assert dryrun.mesh_shape("multi") == (32, 16)
    assert dryrun.mesh_shape("2x4") == (2, 4)
    with pytest.raises(ValueError, match="single, multi or DxM"):
        dryrun.mesh_shape("pod")
    llama = tconfigs.get_config("llama3.2-1b")  # 32 heads over 8 KV heads
    assert dryrun.placeable(llama, Mesh(1, 1)) is llama  # cuts nothing
    for model, shard in ((16, "head_dim"), (8, "heads")):
        mesh = types.SimpleNamespace(model=model)
        cfg = dryrun.placeable(llama, mesh)
        assert cfg.attn_shard == shard
        SH.check_mesh(cfg, 16, model)
    with pytest.raises(ValueError, match="num_kv_heads"):
        SH.check_mesh(llama, 16, 16)


def test_cli_sweeps_and_skips_existing(small_shapes, monkeypatch, tmp_path,
                                       capsys):
    """``main`` over every shape of one arch on a fake 2 x 2 world writes
    one record each; ``--skip-existing`` traces none of them again."""
    monkeypatch.setattr(dryrun, "get_config", _small)
    out = tmp_path / "dry.json"
    argv = ["--arch", "musicgen-medium", "--mesh", "2x2", "--device", "cpu",
            "--out", str(out)]
    assert dryrun.main(argv) == 0
    import json

    recs = json.loads(out.read_text())
    assert [r["shape"] for r in recs] == list(SMALL_SHAPES)
    assert all("roofline" in r and r["mesh"] == "2x2" for r in recs)
    capsys.readouterr()
    assert dryrun.main(argv + ["--skip-existing"]) == 0
    assert "[OK]" not in capsys.readouterr().out
    assert json.loads(out.read_text()) == recs
    failed = {"arch": "x", "shape": "train_4k", "mesh": "2x2",
              "error": "ValueError: y"}
    out.write_text(json.dumps(recs + [failed]))
    assert dryrun.main(["--table", str(out)]) == 0
    table = capsys.readouterr().out.strip().splitlines()
    assert table[0] == "| arch | shape | 2x2 | B6 / B7 |"
    assert len(table) == 2 + len(recs) + 1
    assert table[2].startswith("| musicgen-medium | train_4k | ")
    assert "GB, " in table[2] and "!" not in table[2]
    assert table[2].endswith("| 0 / 0 |")  # the CPU's plain versions
    assert "error: ValueError: y" in table[-1]


def test_cli_jobs_record_each_childs_failure(tmp_path, capsys):
    """``--jobs`` traces each combo in a process of its own; a combo that
    fails there, or runs past ``--timeout``, is recorded with its error,
    and the sweep goes on."""
    out = tmp_path / "jobs.json"
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--mesh", "1x1,2x2", "--jobs", "2", "--device", "cpu",
                        "--out", str(out)]) == 1
    import json

    recs = json.loads(out.read_text())
    assert sorted(r["mesh"] for r in recs) == ["1x1", "2x2"]
    assert all(r["error"].startswith("KeyError") for r in recs)
    assert capsys.readouterr().out.count("[FAIL] no-such-arch") == 2
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                        "--mesh", "1x1", "--jobs", "2", "--timeout", "0.01",
                        "--device", "cpu", "--out", str(out)]) == 1
    assert json.loads(out.read_text())[0]["error"] == (
        "TimeoutExpired: the trace ran past 0.01 s")


# ------------------------------------------------------------ LS-PLM
@pytest.mark.parametrize("variant", dryrun_lsplm.VARIANTS)
def test_lsplm_iteration_traces_on_fake_meshes(variant):
    """One Algorithm-1 iteration of each variant at a small width on a
    fake 2 x 2 world (the last model rank's block, non-common columns)
    and on one rank: the FLOPs of the two products and their backward,
    memory in every category but activations on the mesh, and the
    collectives of the sharded loss and the optimizer's reductions."""
    small = dict(d=2**10, d_common=2**9, m=4, batch=2**8, sessions=2**6)
    with dryrun.fake_world(2, 2, rank=1) as mesh:
        tr = dryrun_lsplm.trace_iteration(mesh, variant, "cpu", **small)
    with dryrun.fake_world(1, 1) as one:
        tr1 = dryrun_lsplm.trace_iteration(one, variant, "cpu", **small)
    memory = 5 if "m5" in variant else 10
    R2 = small["d"] // 2  # the rank's rows
    by = tr["peak"]["by_category"]
    assert by["parameters"] == R2 * 2 * small["m"] * 4
    assert by["optimizer_state"] >= (2 * memory + 2) * R2 * 2 * 4 * small[
        "m"]
    assert tr["flops"] > 0 and tr1["flops"] > tr["flops"]
    assert tr["collectives"]["all-reduce"]["count"] > 0
    assert tr1["collectives"] == {"total_bytes": 0}
    assert tr["calls"] == {}  # B3's plain version on the CPU


def test_lsplm_cli_records_each_variant(monkeypatch, tmp_path, capsys):
    """``dryrun_lsplm``'s entry point at a small width on a fake 2 x 2
    world: one record per variant, with the parameters of d x 2m."""
    import json

    for name, value in (("D_FEATURES", 2**10), ("D_COMMON", 2**9),
                        ("M_REGIONS", 4), ("BATCH", 2**8),
                        ("SESSIONS", 2**6)):
        monkeypatch.setattr(dryrun_lsplm, name, value)
    out = tmp_path / "lsplm.json"
    assert dryrun_lsplm.main(["--mesh", "2x2", "--device", "cpu", "--out",
                              str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["variant"] for r in recs] == list(dryrun_lsplm.VARIANTS)
    assert all(r["params"] == 2**10 * 8 and r["rank"] == 1
               and r["line_search_trials"] == 1 for r in recs)
    assert capsys.readouterr().out.count("params=0.0M") == 4


# --------------------------------------------------- the operators' fakes
def _fake_vs_plain(op_call, plain_call, make, device="cuda"):
    """``op_call`` on fake ``device`` tensors of ``make`` 's shapes and
    dtypes against ``plain_call`` on real CPU tensors: outputs' shapes
    and dtypes equal."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    real = make("cpu")
    want = plain_call(*real)
    with FakeTensorMode():
        fake = [None if t is None else torch.empty(
            t.shape, dtype=t.dtype, device=device) for t in real]
        got = op_call(*fake)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == device for t in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fake_is_plains_shape(dtype, causal):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )

    def make(dev):
        g = torch.Generator().manual_seed(0)
        return [torch.randn((2, 24, h, 64), generator=g).to(dtype).to(dev)
                for h in (8, 2, 2)]

    _fake_vs_plain(lambda q, k, v: flash_attention(q, k, v, causal=causal),
                   lambda q, k, v: ops.plain_attention(q, k, v,
                                                       causal=causal), make)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [False, True])
def test_mamba_scan_fakes_are_plains_shapes(dtype, h0, monkeypatch):
    """B7's two modes and its backward: the wrappers under
    ``FakeTensorMode`` give the plain versions' shapes and dtypes. The
    backward's wrapper slices its operator's outputs, which a torch built
    without CUDA cannot do on a fake CUDA tensor: it runs on fake CPU
    tensors, its device check lifted; its operator runs on meta tensors
    too."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan import mamba_scan as tk

    B, S, di, N = 2, 5, 24, 8

    def gated(dev):
        g = torch.Generator().manual_seed(1)
        acts = [torch.randn(s, generator=g).to(dtype) for s in (
            (B, S, di), (B, S, di), (B, S, N), (B, S, N))]
        f32 = [torch.randn(s, generator=g) for s in ((di,), (di, N),
                                                      (di,))]
        z = torch.randn((B, S, di), generator=g).to(dtype)
        state = torch.randn((B, di, N), generator=g) if h0 else None
        dt_raw, x, Bi, Ci = acts
        dt_bias, A_log, D = f32
        return [t if t is None else t.to(dev) for t in (
            dt_raw, dt_bias, x, Bi, Ci, A_log, D, z, state)]

    def contract(dev):
        dt_raw, dt_bias, x, Bi, Ci, A_log, D, z, state = gated(dev)
        return [dt_raw.float().abs(), x, Bi, Ci, -A_log.exp(), D, state]

    _fake_vs_plain(tk.mamba1_scan_gated, ops.plain_gated_scan, gated)
    _fake_vs_plain(tk.mamba1_scan, ops.plain_scan, contract)

    # the backward: the wrapper on fake CUDA tensors against the plain
    # version, for dy with and without dhT and two needs patterns
    def backward(dev):
        g = torch.Generator().manual_seed(2)
        grads = [torch.randn((B, S, di), generator=g).to(dtype),
                 torch.randn((B, di, N), generator=g)]
        return gated(dev) + [t.to(dev) for t in grads]

    odd = (True, False) * 4 + (True,)
    monkeypatch.setattr(tk, "_on_card", lambda *args: None)
    for needs in (None, odd):
        for keep_dhT in (True, False):
            def call(fn, *args, needs=needs, keep_dhT=keep_dhT):
                *inputs, dy, dhT = args
                return fn(*inputs, dy, dhT if keep_dhT else None,
                          needs=needs)

            def strip(out):  # the entries that are tensors
                return tuple(t for t in out if t is not None)

            _fake_vs_plain(
                lambda *a: strip(call(tk.mamba1_scan_gated_backward, *a)),
                lambda *a: strip(call(ops.plain_gated_scan_backward, *a)),
                backward, device="cpu")
    # the operator itself on meta tensors: its outputs' shapes and dtypes
    meta = [None if t is None else t.to("meta") for t in backward("cpu")]
    mask = tk.needs_mask(None, meta[8])
    outs = torch.ops.repro_torch.mamba1_scan_gated_backward(*meta, mask)
    assert [(tuple(t.shape), t.dtype) for t in outs] == [
        (tuple(shape), dt) for shape, dt in tk._backward_shapes(
            (B, S, di), dtype, N, mask)]
    assert outs[4].shape == (B, S, 1, 2 * N)  # one block of 128 channels
    assert outs[8].shape == (B, -(-S // tk.backward_chunk(N)), di, N)


def test_owlqn_direction_fake_is_plains_shape():
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        owlqn_direction,
    )
    from repro_torch.kernels.owlqn_direction.ref import owlqn_direction_ref

    def make(dev):
        g = torch.Generator().manual_seed(2)
        return [torch.randn((300, 24), generator=g).to(dev)
                for _ in range(2)]

    _fake_vs_plain(lambda t, g: owlqn_direction(t, g, 0.1, 0.2),
                   lambda t, g: owlqn_direction_ref(t, g, 0.1, 0.2), make)


def test_the_operators_are_counted():
    """Under ``FlopCounterMode`` and the traffic counter, each operator
    counts its formula's FLOPs, its bytes and one call; a real CPU tensor
    reaches no kernel of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan as tk
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba1_scan_gated
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        owlqn_direction,
    )

    B, S, H, KVH, hd, di, N = 2, 32, 8, 2, 64, 48, 16
    with FakeTensorMode():
        def e(*s, dt=torch.bfloat16):
            return torch.empty(s, dtype=dt, device="cuda")

        q, k = e(B, S, H, hd), e(B, S, KVH, hd)
        th = e(100, 24, dt=torch.float32)
        scan = [e(B, S, di), e(di, dt=torch.float32), e(B, S, di),
                e(B, S, N), e(B, S, N), e(di, N, dt=torch.float32),
                e(di, dt=torch.float32), e(B, S, di), None]
        with FlopCounterMode(display=False) as fc, \
                memtrack.MemTracker("cuda") as tc, tc.counting():
            flash_attention(q, k, k, causal=True)
            flash_attention(q, k, k, causal=False)
            mamba1_scan_gated(*scan)
            # the backward's operator (the wrapper's glue sums aside)
            tk._GATED_BWD(*scan, e(B, S, di), None,
                          tk.needs_mask(None, None))
            owlqn_direction(th, th, 0.1, 0.1)
    counts = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    assert tc.flops == fc.get_total_flops()
    assert counts == {"repro_torch.flash_attention": 6 * B * H * S * S * hd,
                      "repro_torch.mamba1_scan_gated": 8 * B * S * di * N,
                      "repro_torch.mamba1_scan_gated_backward":
                          27 * B * S * di * N,
                      "repro_torch.owlqn_direction": 16 * 100 * 24}
    assert tc.calls == {"flash_attention": 2, "mamba1_scan_gated": 1,
                        "mamba1_scan_gated_backward": 1,
                        "owlqn_direction": 1}
    # q, k, v read and o written; dt_raw, x, z, B_in, C_in, dt_bias,
    # A_log and D read and y and hT written; Theta, the gradient, d
    attn = 2 * (2 * B * S * H * hd + 2 * B * S * KVH * hd) * 2
    scan_b = (4 * B * S * di + 2 * B * S * N) * 2 + 2 * di * 4 \
        + di * N * 4 + B * di * N * 4
    # the backward: the same inputs and dy read, ddt_raw, dx, dz written
    # (bf16), the partials of dB/dC (one block), dA_log, dD, ddt_bias and
    # the workspace of S / 8 checkpoints written, the workspace read back
    chunks = S // tk.backward_chunk(N)
    bwd_b = (4 * B * S * di + 2 * B * S * N) * 2 + 2 * di * 4 \
        + di * N * 4 + 3 * B * S * di * 2 + (B * S * 2 * N + B * di * N
                                             + 2 * B * di) * 4 \
        + 2 * B * chunks * di * N * 4
    assert tc.hbm_bytes == attn + scan_b + bwd_b + 3 * 100 * 24 * 4
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_attention(
            torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, 1, 8),
            torch.zeros(1, 2, 1, 8), True)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b"])
def test_tracked_flops_are_flop_counter_modes(arch):
    """The tracker's FLOPs (one dispatch mode for memory, bytes and FLOPs)
    are ``FlopCounterMode`` 's over the same training step, exactly."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _small(arch)
    with FakeTensorMode():
        model = tmodels.Transformer(cfg, device="cpu", trainable=True)
        opt, step = tmodels.make_train_step(model)
        state = opt.init(dict(model.named_parameters()))
        toks = torch.empty((2, 16), dtype=torch.int32)
        with FlopCounterMode(display=False) as fc, \
                memtrack.MemTracker("cpu") as mem, mem.counting():
            step(state, {"tokens": toks, "labels": toks})
    assert mem.flops == fc.get_total_flops() > 0


class _Dispatches(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_mamba_train_step_traces_in_bounded_time(monkeypatch):
    """Reduced falcon-mamba's train step on the card's path, B7's forward
    and its backward kernel as traced operators, dispatches the same
    operators at S = 4,096 as at S = 64 (on the CPU's path the backward
    is autograd of a loop over time: a graph of S steps), and traces in
    seconds: 2 layers give 4 forward calls (forward and recompute) and 2
    backward calls. A torch built without CUDA cannot differentiate a
    fake CUDA tensor, so the card's path runs on fake CPU tensors: the
    wrappers' device check lifted and ``gated_selective_scan`` routed
    through its Function, as a CUDA tensor routes it."""
    import time

    from repro_torch.kernels.mamba_scan import mamba_scan as tk
    from repro_torch.kernels.mamba_scan import ops

    monkeypatch.setattr(tk, "_on_card", lambda *args: None)
    monkeypatch.setattr(ops, "gated_selective_scan",
                        lambda *args: ops._GatedScan.apply(*args))
    cfg = tconfigs.get_config("falcon-mamba-7b").reduced()
    dispatched, secs = {}, {}
    for seq in (64, 4096):
        monkeypatch.setitem(tconfigs.INPUT_SHAPES, "train_4k",
                            dict(kind="train", seq_len=seq, global_batch=2))
        t0 = time.perf_counter()
        with _Dispatches() as count, dryrun.fake_world(1, 1) as m:
            tr = dryrun.trace_combo(cfg, "train_4k", m, device="cpu")
        secs[seq] = time.perf_counter() - t0
        dispatched[seq] = count.n
        assert tr.calls == {"mamba1_scan_gated": 4,
                            "mamba1_scan_gated_backward": 2}, tr.calls
        assert tr.flops > 0 and tr.peak["peak_bytes"] > 0
    assert dispatched[4096] == dispatched[64] > 0, dispatched
    assert secs[4096] < 60, secs


# ---------------------------------------------------------- the tracker
def test_memtracker_counts_storages_once_and_frees_them():
    """Views and in-place results are their base's storage; a storage is
    uncounted when its last view dies; the peak's split follows tags made
    after the storage was made."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), memtrack.MemTracker("cpu") as mem:
        a = torch.empty(1000)
        b = a.view(10, 100)
        b.mul_(2)
        c = b * 2  # 4,000 bytes more
        del a
        assert sum(mem.live_bytes().values()) == 8000  # b holds a's
        del b
        assert sum(mem.live_bytes().values()) == 4000
        d = c.narrow(0, 0, 5)
        del c
        assert sum(mem.live_bytes().values()) == 4000
        mem.tag(d, "gradients")
        del d
        assert sum(mem.live_bytes().values()) == 0
    peak = mem.peak()
    assert peak["peak_bytes"] == 8000
    assert peak["by_category"] == {"parameters": 0, "gradients": 4000,
                                   "optimizer_state": 0, "inputs": 0,
                                   "activations": 4000}


# ------------------------------------------------ what the port imports
def test_dry_run_modules_import_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun, "
            "repro_torch.launch.dryrun_lsplm, repro_torch.utils.memtrack, "
            "repro_torch.utils.collectives; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


# --------------------------------- a fault the dry run found (ROADMAP C)
def test_bf16_features_promote_as_the_reference():
    """The dense common-feature NLL with bf16 features and an fp32 Theta
    (``dryrun_lsplm``'s bf16 variants): the reference's jnp promotes the
    features and multiplies in fp32; the port raised a dtype error there.
    Now it promotes too, and equals the reference's loss."""
    import jax.numpy as jnp

    from repro.core.objective import CommonFeatureBatch as JBatch
    from repro.core.objective import nll_common_feature as j_nll
    from repro_torch.core.objective import CommonFeatureBatch as TBatch
    from repro_torch.core.objective import nll_common_feature as t_nll
    from repro_torch.dist import sharded_nll

    rng = np.random.default_rng(5)
    G, per, d_c, d_nc, m = 6, 3, 20, 12, 4
    xc = rng.random((G, d_c)).astype(np.float32)
    xnc = rng.random((G * per, d_nc)).astype(np.float32)
    sid = np.repeat(np.arange(G), per).astype(np.int32)
    y = (rng.random(G * per) < 0.4).astype(np.float32)
    theta = (0.3 * rng.normal(size=(d_c + d_nc, 2 * m))).astype(np.float32)
    jb = JBatch(jnp.asarray(xc, jnp.bfloat16), jnp.asarray(xnc, jnp.bfloat16),
                jnp.asarray(sid), jnp.asarray(y), None)
    tb = TBatch(torch.from_numpy(xc).bfloat16(),
                torch.from_numpy(xnc).bfloat16(), torch.from_numpy(sid),
                torch.from_numpy(y))
    want = float(j_nll(jnp.asarray(theta), jb))
    got = t_nll(torch.from_numpy(theta), tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=2e-5)
    one = sharded_nll(torch.from_numpy(theta), tb, Mesh(1, 1),
                      common_feature=True)
    assert torch.equal(one, got)
