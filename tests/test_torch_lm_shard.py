"""Sharded LM serving in the port (``models/sharding.py``, the ``mesh=``
of ``models.prefill`` / ``decode_step`` / ``generate`` / ``init_model``
/ ``init_caches``, ``convert.model_from_reference``) against the
reference's UNSHARDED ``prefill`` / ``decode_step`` / ``generate`` on the
CPU, on the same numpy parameters.

Reduced configs in fp32, batch 4, prompt 16, 4 decode tokens, on (2, 2),
(1, 2) and (2, 1) meshes run as spawned gloo ranks
(``launch.mesh.run_ranks``): one world of 4 ranks and one of 2 that runs
its two meshes in turn. The ranks' worker is this module's
:func:`_world`, so a rank imports this module: it imports no JAX at
module level (the reference runs in the parent, and hands its numpy
parameters to the ranks).

Bars (rtol = atol = 1e-4, ``tests/test_torch_lm.py``'s fp32 bar):
llama3.2-1b and falcon-mamba-7b prefill logits, the caches gathered back
into the reference's layout and 4 decode steps' logits against the
reference's full-batch run, greedy tokens equal; granite-moe-1b-a400m's
``weight_gather`` prefill against the reference's unsharded prefill run
on each data shard's rows alone (the plan's own semantics: capacity from
B_loc * S tokens), on a prompt whose routing drops assignments (a drop
count > 0 asserted, and the full-batch result shown to differ by more
than the bar), its aux loss the mean of the shards' (rtol 1e-5);
granite's ``token_gather`` prefill and decode against the full batch;
zamba2-2.7b on the data-only mesh. Within the port, bitwise: a 1 x 1 mesh
and the unsharded path, every rank of a data shard's logits and every
rank's tokens, ``init_model(mesh=)``'s blocks and the unsharded model's
slices, a sharded model gathered back and the reference's leaves, and
``Mesh.gather`` in five dtypes.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import convert
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SH
from repro_torch.models.generate import fill_caches, generate

LLAMA, SSM, MOE_ARCH, HYBRID = ("llama3.2-1b", "falcon-mamba-7b",
                                "granite-moe-1b-a400m", "zamba2-2.7b")
B, S, DECODE = 4, 16, 4
TOL, AUX_RTOL = 1e-4, 1e-5
# the meshes and what runs on each: (arch, MoE plan)
CASES = {(2, 2): ((LLAMA, "weight_gather"), (SSM, "weight_gather"),
                  (MOE_ARCH, "weight_gather"), (MOE_ARCH, "token_gather")),
         (1, 2): ((LLAMA, "weight_gather"), (SSM, "weight_gather"),
                  (MOE_ARCH, "weight_gather")),
         (2, 1): ((LLAMA, "weight_gather"), (SSM, "weight_gather"),
                  (MOE_ARCH, "weight_gather"), (HYBRID, "weight_gather"))}
# on the 2 x 2 mesh, also with the batch whole on every data rank
# (batch_sharded=False): the full-batch function, global MoE capacity
REPLICATED = ((LLAMA, "weight_gather"), (MOE_ARCH, "weight_gather"),
              (MOE_ARCH, "token_gather"))
WORLDS = {4: ((2, 2),), 2: ((1, 2), (2, 1))}
MESHES = [(2, 2), (1, 2), (2, 1)]


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               dtype="float32")


def _prompt(arch) -> np.ndarray:
    """(B, S) ids. granite's rows are each one repeated id (7, 7, 11, 13):
    every position of a row routes alike, so data shard 0's 32 tokens
    overflow its experts' capacity of 24 (a shard's B_loc * S = 32
    tokens) but not the full batch's 40."""
    if arch == MOE_ARCH:
        return np.repeat(np.array([[7], [7], [11], [13]], np.int32), S, 1)
    return np.random.default_rng(1).integers(
        0, _cfg(arch).vocab_size, (B, S)).astype(np.int32)


def _decode_tokens(arch) -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, _cfg(arch).vocab_size, (B, DECODE)).astype(np.int32)


# ------------------------------------------------------------- the ranks
def _serve(mesh, arch, mode, params, batch_sharded=True):
    """One family on one mesh: prefill (assignments dropped counted), the
    caches gathered into the reference's layout, DECODE steps of
    make_serve_step on _decode_tokens, greedy generate, and (MoE) the
    forward's aux."""
    cfg = _cfg(arch)
    model = convert.model_from_reference(params, cfg, device="cpu",
                                         mesh=mesh)
    at = dict(mesh=mesh, batch_sharded=batch_sharded)

    def rows(a):
        return SH.batch_rows(torch.from_numpy(a), mesh, batch_sharded)

    dropped, plan = [], MOE.dispatch_plan

    def recording(*args, **kw):
        out = plan(*args, **kw)
        dropped.append(int((out.mine & ~out.keep).sum()))
        return out

    MOE.dispatch_plan = recording
    try:
        logits, c0 = tmodels.prefill(model, tokens=rows(_prompt(arch)),
                                     moe_serving_mode=mode, **at)
    finally:
        MOE.dispatch_plan = plan
    specs = tmodels.cache_specs(cfg, batch_sharded, mesh.model)
    out = {"prefill": logits.numpy(), "dropped": sum(dropped),
           "caches": {n: SH.gather_block(c, specs[n], mesh).numpy()
                      for n, c in c0.items()}}
    caches = fill_caches(tmodels.init_caches(
        cfg, B, S + DECODE, dtype=torch.float32, device="cpu", **at), c0)
    step = tmodels.make_serve_step(model, moe_serving_mode=mode, **at)
    dec, steps = _decode_tokens(arch), []
    for i in range(DECODE):
        lg, caches = step(caches, rows(dec[:, i]), S + i)
        steps.append(lg.numpy())
    out["decode"] = np.stack(steps)
    out["tokens"] = generate(model, torch.from_numpy(_prompt(arch)), DECODE,
                             temperature=0.0, moe_serving_mode=mode,
                             **at).numpy()
    if cfg.num_experts:
        out["aux"] = float(tmodels.forward(model, tokens=rows(_prompt(arch)),
                                           **at)[1])
    return out


def _layout_checks(mesh, params):
    """init_model(mesh=)'s blocks against the unsharded model's slices and
    the sharded reference parameters gathered back, per family that
    splits over model; Mesh.gather over both axes in five dtypes, each
    rank's block holding its rank's numbers."""
    out = {"init": {}, "gathered": {}, "gather": {}}
    for arch in (LLAMA, SSM, MOE_ARCH):
        cfg = _cfg(arch)
        sharded = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                                     device="cpu", mesh=mesh)
        full = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        cuts = sharded.leaf_specs()
        out["init"][arch] = all(
            torch.equal(p, SH.local_block(full.get_parameter(n), cuts[n][0],
                                          mesh, cuts[n][1]))
            for n, p in sharded.named_parameters())
        model = convert.model_from_reference(params[arch], cfg,
                                             device="cpu", mesh=mesh)
        out["gathered"][arch] = convert.params_to_reference(model)
    for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.int64,
                  torch.bool):
        for axis, dim in (("data", 0), ("model", 1)):
            n = mesh.shape[axis]
            full = torch.arange(n * 3 * 5).reshape(3 * (n if dim == 0 else 1),
                                                   5 * (n if dim else 1))
            full = (full % 2 if dtype == torch.bool else full - 7).to(dtype)
            r = mesh.data_rank if axis == "data" else mesh.model_rank
            mine = full.chunk(n, dim)[r]
            out["gather"][str(dtype), axis] = torch.equal(
                mesh.gather(mine, axis, dim), full)
    return out


def _world(rank, dev, shapes, params):
    """One rank of a world that runs each mesh of ``shapes`` in turn:
    CASES[mesh], then on the 2 x 2 mesh the layout checks."""
    out = {}
    for shape in shapes:
        mesh = Mesh(*shape)
        out[shape] = {"rank": rank, "data_rank": mesh.data_rank,
                      "cases": {(arch, mode): _serve(mesh, arch, mode,
                                                     params[arch])
                                for arch, mode in CASES[shape]}}
        if shape == (2, 2):
            out[shape]["replicated"] = {
                (arch, mode): _serve(mesh, arch, mode, params[arch], False)
                for arch, mode in REPLICATED}
            out[shape]["layout"] = _layout_checks(mesh, params)
    return out


# ------------------------------------------------------------ the parent
@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's parameters (numpy) and its unsharded full-batch
    prefill, caches, decode steps and greedy tokens; for the MoE family
    also its prefill logits and aux per data shard of two (and of one)."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    import repro.models as jmodels
    from repro.models.generate import generate as jgenerate

    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               dtype="float32")
    params = jmodels.init_model(jcfg, jax.random.PRNGKey(0))
    prefill = jax.jit(lambda p, t: jmodels.prefill(p, jcfg, tokens=t))
    decode = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
        p, jcfg, c, token=t, pos=pos))
    toks, dec = _prompt(arch), _decode_tokens(arch)
    logits, caches = prefill(params, jnp.asarray(toks))
    out = {"params": jax.tree.map(np.asarray, params),
           "prefill": np.asarray(logits),
           "caches": {n: np.asarray(c) for n, c in caches.items()}}
    big = {n: (jnp.pad(c, [(0, 0)] * 2 + [(0, DECODE)] + [(0, 0)] *
                       (c.ndim - 3)) if n in ("k", "v") else c)
           for n, c in caches.items()}
    steps = []
    for i in range(DECODE):
        lg, big = decode(params, big, jnp.asarray(dec[:, i]),
                         jnp.asarray(S + i))
        steps.append(np.asarray(lg))
    out["decode"] = np.stack(steps)
    out["tokens"] = np.asarray(jgenerate(params, jcfg, jnp.asarray(toks),
                                         DECODE, jax.random.PRNGKey(0),
                                         temperature=0.0))
    if jcfg.num_experts:
        fwd = jax.jit(lambda p, t: jmodels.forward(p, jcfg, tokens=t,
                                                   remat=False)[1])
        for data in (1, 2):
            shards = np.split(toks, data)
            out["prefill_by_shard", data] = np.concatenate(
                [np.asarray(prefill(params, jnp.asarray(t))[0])
                 for t in shards])
            out["aux_by_shard", data] = float(np.mean(
                [float(fwd(params, jnp.asarray(t))) for t in shards]))
    return out


@functools.lru_cache(maxsize=None)
def _world_run(size):
    params = {arch: _reference(arch)["params"]
              for arch in (LLAMA, SSM, MOE_ARCH, HYBRID)}
    return run_ranks(_world, size, WORLDS[size], params)


def _ranks(shape):
    return [r[shape] for r in _world_run(shape[0] * shape[1])]


def _rows(a, data, data_rank):
    return np.split(a, data)[data_rank]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", [LLAMA, SSM])
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_caches_decode_match_reference(shape, arch):
    ref = _reference(arch)
    for r in _ranks(shape):
        got = r["cases"][arch, "weight_gather"]
        _close(got["prefill"], _rows(ref["prefill"], shape[0],
                                     r["data_rank"]))
        _close(got["decode"], np.stack([_rows(s, shape[0], r["data_rank"])
                                        for s in ref["decode"]]))
        assert got["caches"].keys() == ref["caches"].keys()
        for name, c in ref["caches"].items():
            assert got["caches"][name].shape == c.shape
            _close(got["caches"][name], c)


@pytest.mark.parametrize("shape,arch", [
    (shape, arch) for shape in MESHES for arch in (LLAMA, SSM, HYBRID)
    if (arch, "weight_gather") in CASES[shape]])
def test_greedy_generate_matches_reference(shape, arch):
    want = _reference(arch)["tokens"]
    for r in _ranks(shape):
        got = r["cases"][arch, "weight_gather"]["tokens"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_zamba2_on_a_data_mesh_matches_reference():
    ref = _reference(HYBRID)
    for r in _ranks((2, 1)):
        got = r["cases"][HYBRID, "weight_gather"]
        _close(got["prefill"], _rows(ref["prefill"], 2, r["data_rank"]))
        _close(got["decode"], np.stack([_rows(s, 2, r["data_rank"])
                                        for s in ref["decode"]]))
        for name, c in ref["caches"].items():
            _close(got["caches"][name], c)


@pytest.mark.parametrize("shape", MESHES)
def test_weight_gather_is_the_reference_per_data_shard(shape):
    """Capacity from a shard's B_loc * S tokens: the reference's unsharded
    prefill run on each data shard's rows alone; with two shards, shard 0
    drops assignments, and the full batch's logits differ past the bar."""
    ref = _reference(MOE_ARCH)
    want = ref["prefill_by_shard", shape[0]]
    for r in _ranks(shape):
        got = r["cases"][MOE_ARCH, "weight_gather"]
        _close(got["prefill"], _rows(want, shape[0], r["data_rank"]))
        if shape[0] == 2 and r["data_rank"] == 0:
            assert got["dropped"] > 0
    if shape[0] == 2:
        assert np.abs(ref["prefill"] - want).max() > 100 * TOL


@pytest.mark.parametrize("shape", MESHES)
def test_weight_gather_aux_is_the_mean_of_the_shards(shape):
    want = _reference(MOE_ARCH)["aux_by_shard", shape[0]]
    for r in _ranks(shape):
        got = r["cases"][MOE_ARCH, "weight_gather"]["aux"]
        assert got == pytest.approx(want, rel=AUX_RTOL)


def test_token_gather_is_the_full_batch_reference():
    """Tokens gathered over data and routed at the global capacity: the
    reference's full-batch prefill (drops and all), decode and tokens."""
    ref = _reference(MOE_ARCH)
    for r in _ranks((2, 2)):
        got = r["cases"][MOE_ARCH, "token_gather"]
        _close(got["prefill"], _rows(ref["prefill"], 2, r["data_rank"]))
        _close(got["decode"], np.stack([_rows(s, 2, r["data_rank"])
                                        for s in ref["decode"]]))
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        for name, c in ref["caches"].items():
            _close(got["caches"][name], c)


@pytest.mark.parametrize("arch,mode", REPLICATED)
def test_a_batch_whole_on_every_rank_is_the_full_batch_reference(arch,
                                                                 mode):
    """batch_sharded=False on 2 x 2: every data rank serves all four rows,
    each MoE plan at the global capacity (the reference's moe_mesh=None),
    against the reference's full-batch run."""
    ref = _reference(arch)
    for r in _ranks((2, 2)):
        got = r["replicated"][arch, mode]
        _close(got["prefill"], ref["prefill"])
        _close(got["decode"], ref["decode"])
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        for name, c in ref["caches"].items():
            _close(got["caches"][name], c)
        if MOE_ARCH == arch:
            assert got["aux"] == pytest.approx(ref["aux_by_shard", 1],
                                               rel=AUX_RTOL)


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_agree_bitwise(shape):
    """Every rank of a data shard holds the same logits' bits, and every
    rank the same tokens."""
    ranks = _ranks(shape)
    for case in CASES[shape]:
        first = {}
        for r in ranks:
            got = r["cases"][case]
            seen = first.setdefault(r["data_rank"], got)
            for key in ("prefill", "decode"):
                np.testing.assert_array_equal(got[key], seen[key])
            np.testing.assert_array_equal(got["tokens"],
                                          ranks[0]["cases"][case]["tokens"])


@pytest.mark.parametrize("arch", [LLAMA, SSM, MOE_ARCH])
def test_init_model_blocks_are_the_unsharded_slices(arch):
    assert all(r["layout"]["init"][arch] for r in _ranks((2, 2)))


@pytest.mark.parametrize("arch", [LLAMA, SSM, MOE_ARCH])
def test_sharded_model_gathers_back_to_the_reference_bitwise(arch):
    want = _reference(arch)["params"]
    for r in _ranks((2, 2)):
        got = r["layout"]["gathered"][arch]
        for path, leaf in _flat(want):
            np.testing.assert_array_equal(_get(got, path), leaf,
                                          err_msg="/".join(path))


def test_mesh_gather_is_exact_in_every_dtype():
    for r in _ranks((2, 2)):
        bad = [k for k, ok in r["layout"]["gather"].items() if not ok]
        assert not bad


def _flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + (k,))
        else:
            yield pre + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------- in this process
@pytest.mark.parametrize("arch", [LLAMA, SSM, MOE_ARCH, HYBRID])
def test_one_by_one_mesh_is_the_unsharded_path_bitwise(arch):
    cfg, mesh = _cfg(arch), Mesh(1, 1)
    plain = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    meshed = tmodels.init_model(cfg, torch.Generator().manual_seed(0),
                                device="cpu", mesh=mesh)
    for (n, p), (m, q) in zip(plain.named_parameters(),
                              meshed.named_parameters()):
        assert n == m and torch.equal(p, q)
    toks = torch.from_numpy(_prompt(arch))
    for mode in MOE.SERVING_MODES:
        a, ca = tmodels.prefill(plain, tokens=toks, moe_serving_mode=mode)
        b, cb = tmodels.prefill(meshed, tokens=toks, mesh=mesh,
                                moe_serving_mode=mode)
        assert torch.equal(a, b)
        assert all(torch.equal(ca[n], cb[n]) for n in ca)
        tok = torch.from_numpy(_decode_tokens(arch)[:, 0])
        da, _ = tmodels.decode_step(plain, ca, token=tok, pos=S + 1,
                                    window=True, moe_serving_mode=mode)
        db, _ = tmodels.decode_step(meshed, cb, token=tok, pos=S + 1,
                                    window=True, mesh=mesh,
                                    moe_serving_mode=mode)
        assert torch.equal(da, db)
    assert torch.equal(generate(plain, toks, 3, temperature=0.0),
                       generate(meshed, toks, 3, temperature=0.0, mesh=mesh))


@pytest.mark.parametrize("what,over", [
    ("num_heads", dict(num_heads=3, num_kv_heads=3, head_dim=64)),
    ("num_kv_heads", dict(num_kv_heads=1)),
    ("d_inner", dict(d_model=255, ssm_expand=1)),
    ("num_experts", dict(num_experts=3)),
])
def test_a_count_that_does_not_divide_raises(what, over):
    arch = {"d_inner": SSM, "num_experts": MOE_ARCH}.get(what, LLAMA)
    cfg = dataclasses.replace(_cfg(arch), **over)
    with pytest.raises(ValueError, match=what):
        SH.check_mesh(cfg, 1, 2)
    SH.check_mesh(cfg, 2, 1)  # a data-only mesh cuts none of them


@pytest.mark.parametrize("arch,over", [
    (HYBRID, {}), (LLAMA, dict(attn_shard="head_dim")),
    (LLAMA, dict(seq_parallel=True))])
def test_what_a12e_added_is_accepted(arch, over):
    """The hybrid's Mamba2, ``attn_shard="head_dim"`` and ``seq_parallel``
    on a mesh with model > 1: the mesh is accepted and a model's blocks
    are cut for it (on ``meta``)."""
    cfg = dataclasses.replace(_cfg(arch), **over)
    SH.check_mesh(cfg, 2, 2)
    SH.check_mesh(cfg, 2, 1)
    mesh = types.SimpleNamespace(data=2, model=2, size=4, rank=0,
                                 data_rank=0, model_rank=1,
                                 shape={"data": 2, "model": 2})
    for trainable in (False, True):
        model = tmodels.Transformer(cfg, device="meta", trainable=trainable,
                                    mesh=mesh)
        assert model.embed.shape[0] == cfg.vocab_size // 2


@pytest.mark.parametrize("what,arch,over", [
    ("nh", HYBRID, dict(d_model=96)),  # d_inner 192: 3 heads of 64
    ("KVH hd", LLAMA, dict(attn_shard="head_dim", num_kv_heads=1,
                           head_dim=3))])
def test_an_a12e_count_that_does_not_divide_raises(what, arch, over):
    """The Mamba2 heads, and under ``attn_shard="head_dim"`` the KV
    heads' width, must divide by ``model`` (a KV head count need not)."""
    cfg = dataclasses.replace(_cfg(arch), ssm_headdim=64, **over) \
        if arch == HYBRID else dataclasses.replace(_cfg(arch), **over)
    with pytest.raises(ValueError, match=what):
        SH.check_mesh(cfg, 1, 2)
    SH.check_mesh(cfg, 2, 1)
    SH.check_mesh(dataclasses.replace(_cfg(LLAMA), attn_shard="head_dim",
                                      num_kv_heads=1), 1, 2)


@pytest.mark.parametrize("model_size", [2, 16])
def test_specs_equal_the_reference(model_size):
    """param_specs and cache_specs of every config of the zoo, entry for
    entry the reference's PartitionSpecs (a one-axis tuple such as
    ``("data",)`` read as its axis)."""
    import repro.configs as jconfigs
    from repro.models import transformer as JT

    def norm(tree):
        if isinstance(tree, dict):
            return {k: norm(v) for k, v in tree.items()}
        return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in tree)

    for arch in jconfigs.list_archs():
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        assert tmodels.param_specs(t, model_size) == norm(
            JT.param_specs(j, model_size)), arch
        for bs in (True, False):
            assert tmodels.cache_specs(t, bs, model_size) == norm(
                JT.cache_specs(j, bs, model_size=model_size)), arch


def test_specs_follow_the_reference_rules():
    """The vocab stays unsplit where it does not divide (granite's
    49,155), experts keep their data entries in the serving layout, the
    other leaves drop theirs, and Mamba1's in_proj is cut in halves."""
    granite = tconfigs.get_config(MOE_ARCH)
    specs = tmodels.param_specs(granite, 2)
    assert specs["embed"] == (None, "data")
    assert specs["lm_head"] == ("data", None)
    assert SH.serving_spec(specs, "layers.0.ffn.w2", granite) == (
        ("model", "data", None), SH.CONTIGUOUS)
    assert SH.serving_spec(specs, "layers.0.attn.wq", granite) == (
        (None, "model"), SH.CONTIGUOUS)
    llama = tconfigs.get_config(LLAMA)
    assert tmodels.param_specs(llama, 2)["embed"] == ("model", "data")
    ssm = tconfigs.get_config(SSM)
    assert SH.serving_spec(tmodels.param_specs(ssm, 2),
                           "layers.5.mamba.in_proj", ssm) == (
        (None, "model"), ((ssm.d_inner, True), (ssm.d_inner, True)))
    assert tmodels.cache_specs(llama, False, 2)["k"] == (
        None, None, None, "model", None)
    assert tmodels.cache_specs(ssm, True, 2)["ssm"] == (
        None, "data", "model", None)


def test_in_proj_halves_are_cut_apart():
    """A rank holds [x_r | z_r] of Mamba1's in_proj, and gathering puts
    [x | z] back."""
    leaf = torch.arange(24.0).reshape(2, 12)  # x = cols 0-5, z = 6-11
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 3}, model=3,
                                 data=1, model_rank=1, data_rank=0)
    block = SH.local_block(leaf, (None, "model"), mesh,
                           parts=((6, True), (6, True)))
    assert torch.equal(block, leaf[:, [2, 3, 8, 9]])


def test_a_model_cut_for_another_mesh_raises():
    model = tmodels.init_model(_cfg(LLAMA), torch.Generator().manual_seed(0),
                               device="cpu")
    other = types.SimpleNamespace(data=2, model=2, size=4)
    with pytest.raises(ValueError, match="cut for it"):
        tmodels.prefill(model, tokens=torch.zeros((2, 4), dtype=torch.int64),
                        mesh=other)
    with pytest.raises(ValueError, match="divide"):
        SH.batch_rows(torch.zeros((3, 4)), types.SimpleNamespace(
            data=2, data_rank=0))


# ------------------------------------------ the reference's own shard_map
SHARD_MAP_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
import repro.configs as jconfigs
from repro.launch.mesh import make_debug_mesh
from repro.models import transformer as T

src, dst = sys.argv[1], sys.argv[2]
cfg = dataclasses.replace(jconfigs.get_config(sys.argv[3]).reduced(),
                          dtype="float32")
npz = np.load(src)
params = {}
for key in npz.files:
    if key == "tokens":
        continue
    *path, leaf = key.split("/")
    node = params
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = npz[key]
mesh = make_debug_mesh(2, 2)
specs = T.param_specs(cfg, model_size=2)
placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                      params, specs)
logits, _ = jax.jit(lambda p, t: T.prefill(p, cfg, tokens=t, mesh=mesh))(
    placed, jnp.asarray(npz["tokens"]))
np.save(dst, np.asarray(logits))
"""


def test_weight_gather_matches_the_reference_shard_map(tmp_path):
    """The per-data-shard oracle above is the reference's own sharded
    semantics: its reduced granite ``prefill(mesh=make_debug_mesh(2, 2))``
    on four host devices, parameters placed by its ``param_specs``,
    against the port's 2 x 2 prefill logits (a subprocess, for the
    device count)."""
    import os
    import subprocess
    import sys

    ref = _reference(MOE_ARCH)
    src, dst = tmp_path / "in.npz", tmp_path / "logits.npy"
    np.savez(src, tokens=_prompt(MOE_ARCH), **{
        "/".join(path): leaf for path, leaf in _flat(ref["params"])})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SHARD_MAP_SCRIPT, str(src),
                           str(dst), MOE_ARCH], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(dst)
    for r in _ranks((2, 2)):
        _close(r["cases"][MOE_ARCH, "weight_gather"]["prefill"],
               _rows(want, 2, r["data_rank"]))
