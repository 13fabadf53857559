"""Sharded LM training in the port (``loss_fn`` / ``loss_and_grads`` /
``make_train_step`` with ``mesh=``, the training layout of
``models/sharding.py``, the differentiable collectives of
``launch/mesh.py``) against the reference's UNSHARDED ``loss_fn``,
``jax.value_and_grad`` and ``AdamW`` on the CPU, on the same numpy
parameters and batches. (The reference's own sharded step cannot be the
yardstick on jax 0.9.0: ``ROADMAP.md`` C, reference-side caveats.)

Reduced configs in fp32, batch 4 x 16 tokens, parameters drawn by the
port's ``init_model`` from one seed and handed to both packages, on
(2, 2), (1, 2) and (2, 1) meshes run as spawned gloo ranks
(``launch.mesh.run_ranks``): one
world of 4 ranks, and one of 2 that runs (2, 1) and then (1, 2), both
started at the module's first test and run in the background while the
parent computes the reference; each world checks every family inside
it. The ranks' worker is this module's
:func:`_world`, so a rank imports this module: it imports no JAX at
module level (the reference runs in the parent and hands its numpy
parameters to the ranks).

Bars (``tests/test_torch_lm_train.py``'s): loss rtol 1e-5; every
gathered gradient leaf within 1e-4 max|g_ref| + 1e-7; three AdamW steps
at lr 1e-3: losses rtol 1e-4, every parameter within 2 lr n of the
reference's and within AdamW's own sensitivity to the gradient bar, 1e-6
+ lr sum_t min(2, e_t / |g_t|) per element, within 1e-6 on 99.9% of the
elements whose gradient keeps that sum under 1e-3. granite-moe-1b-a400m
on a mesh with data > 1 runs ``weight_gather``, whose capacity comes
from each shard's own tokens, so its yardstick is the reference run on
each data shard's rows alone, combined by the global CE's sums and the
aux's mean over ``data`` (the mean of the shards' losses, at equal
token counts). Within the port, bitwise: the 1 x 1 mesh and the
unsharded step (loss, every gradient, the parameters after two updates);
the ranks of a data shard's losses; every model-replicated block's
gradient and update across ``model`` ranks; the untouched embedding
rows' gradients (exactly 0 on every rank); a model trained with FSDP on
2 x 1, gathered into the reference's layout, and a serving model cut
from those leaves on 1 x 2 (its prefill logits at
``tests/test_torch_lm_shard.py``'s bar, 1e-4, of the reference's).
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import convert
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.mesh import (
    Mesh,
    copy_to,
    gather_replicated,
    gather_split,
    run_ranks,
    sum_fp32,
)
from repro_torch.models import sharding as SH

LLAMA, SSM, MOE_ARCH, HYBRID = ("llama3.2-1b", "falcon-mamba-7b",
                                "granite-moe-1b-a400m", "zamba2-2.7b")
ARCHS = (LLAMA, MOE_ARCH, SSM, HYBRID)
B, S, LR, STEPS = 4, 16, 1e-3, 3
LOSS_RTOL, GRAD_REL, STEP_RTOL, SERVE_TOL = 1e-5, 1e-4, 1e-4, 1e-4
CASES = {(2, 2): (LLAMA, MOE_ARCH, SSM),
         (1, 2): (LLAMA, MOE_ARCH, SSM),
         (2, 1): (LLAMA, MOE_ARCH, SSM, HYBRID)}
WORLDS = {4: ((2, 2),), 2: ((2, 1), (1, 2))}
MESHES = [(2, 2), (1, 2), (2, 1)]
CASE_IDS = [(shape, arch) for shape in MESHES for arch in CASES[shape]]


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               dtype="float32")


def _batch(arch, weighted=False) -> dict:
    """(B, S) tokens and labels from the token stream (Zipf ids, so most
    of the vocab is untouched); with ``weighted``, 0/1 loss weights whose
    share of ones differs between the two halves of the batch (the data
    shards of a 2 x 1 mesh)."""
    b = TokenStream(_cfg(arch).vocab_size, seed=1).batch(B, S + 1)
    out = {"tokens": b["tokens"], "labels": b["labels"]}
    if weighted:
        u = np.random.default_rng(2).random((B, S))
        keep = np.array([[0.1], [0.1], [0.8], [0.8]])
        out["loss_weights"] = (u > keep).astype(np.float32)
    return out


def _shards(batch: dict, data: int) -> list:
    return [dict(zip(batch, parts))
            for parts in zip(*(np.split(v, data) for v in batch.values()))]


def _rows(batch: dict, mesh) -> dict:
    return {k: SH.batch_rows(torch.from_numpy(v), mesh)
            for k, v in batch.items()}


def _gathered(model, tensors: dict) -> dict:
    cuts = model.leaf_specs()
    return {n: SH.gather_block(t.detach(), cuts[n][0], model.mesh,
                               cuts[n][1]).numpy()
            for n, t in tensors.items()}


# ------------------------------------------------------------- the ranks
def _case(mesh, arch, params):
    """One family on one mesh: the loss and every block's gradient
    (gathered), the model-replicated blocks' gradients, the embedding
    block's gradient, then STEPS AdamW steps (losses, the parameters
    gathered, the model-replicated blocks)."""
    cfg = _cfg(arch)
    model = convert.model_from_reference(params, cfg, device="cpu",
                                         trainable=True, mesh=mesh)
    rows = _rows(_batch(arch), mesh)
    loss, (ce, aux), grads = tmodels.loss_and_grads(model, rows)
    cuts = model.leaf_specs()
    replicated = [n for n, (spec, _) in cuts.items() if "model" not in spec]
    gathered = _gathered(model, grads)  # a collective: every rank gathers
    out = {"loss": float(loss.detach()), "ce": float(ce.detach()),
           "aux": float(aux.detach()),
           "grads": gathered if mesh.rank == 0 else None,
           "grads_replicated": {n: grads[n].numpy() for n in replicated},
           "embed_grad": grads["embed"].numpy(),
           "embed_rows": (mesh.model_rank * model.embed.shape[0],
                          model.embed.shape[0])}
    # the first update from these gradients (what train_step applies),
    # the others through train_step itself
    opt, step = tmodels.make_train_step(model, lr=LR)
    params = dict(model.named_parameters())
    _, state = opt.apply(grads, opt.init(params), params)
    losses = [out["loss"]]
    for _ in range(STEPS - 1):
        state, m = step(state, rows)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["params"] = convert.params_to_reference(model)
    out["params_replicated"] = {n: model.get_parameter(n).detach().numpy()
                                for n in replicated}
    return out


def _weighted(mesh, params):
    """llama with loss weights that differ between the data shards: the
    loss and the gathered gradients."""
    model = convert.model_from_reference(params, _cfg(LLAMA), device="cpu",
                                         trainable=True, mesh=mesh)
    loss, _, grads = tmodels.loss_and_grads(
        model, _rows(_batch(LLAMA, weighted=True), mesh))
    return {"loss": float(loss.detach()), "grads": _gathered(model, grads)}


def _serve_from(mesh, trained):
    """A serving model on ``mesh`` cut from the trained leaves: its leaves
    gathered back, and its prefill logits on the batch's tokens."""
    cfg = _cfg(LLAMA)
    model = convert.model_from_reference(trained, cfg, device="cpu",
                                         mesh=mesh)
    logits, _ = tmodels.prefill(model, tokens=SH.batch_rows(
        torch.from_numpy(_batch(LLAMA)["tokens"]), mesh), mesh=mesh)
    return {"leaves": convert.params_to_reference(model),
            "logits": logits.numpy()}


def _collectives(mesh):
    """The four Functions' backwards on x = (rank + 1) * ones: copy_to's
    cotangent summed over the axis, sum_fp32's passed through,
    gather_replicated's sliced, gather_split's summed then sliced."""
    out = {}
    for axis in ("data", "model"):
        n = mesh.shape[axis]
        r = mesh.data_rank if axis == "data" else mesh.model_rank
        x = torch.full((2, 3), float(r + 1), requires_grad=True)
        g = torch.autograd.grad((copy_to(x, mesh, axis) * (r + 1)).sum(),
                                x)[0]
        out["copy_to", axis] = (g, torch.full((2, 3), n * (n + 1) / 2))
        g = torch.autograd.grad(sum_fp32(x, mesh, axis).sum(), x)[0]
        out["sum_fp32", axis] = (g, torch.ones(2, 3))
        w = torch.arange(2.0 * 3 * n).reshape(2, 3 * n)
        y = gather_replicated(x, mesh, axis, 1)
        g = torch.autograd.grad((y * w).sum(), x)[0]
        out["gather_replicated", axis] = (g, w.chunk(n, 1)[r])
        y = gather_split(x, mesh, axis, 1)
        g = torch.autograd.grad((y * w * (r + 1)).sum(), x)[0]
        out["gather_split", axis] = (g, w.chunk(n, 1)[r] * n * (n + 1) / 2)
    return {k: bool(torch.equal(*v)) for k, v in out.items()}


def _world(rank, dev, shapes, params):
    """One rank of a world that runs each mesh of ``shapes`` in turn:
    CASES[mesh]; on 2 x 1 also the weighted CE, and the llama it trained
    is served on the next mesh (1 x 2)."""
    out, trained = {}, None
    for shape in shapes:
        mesh = Mesh(*shape)
        res = {"rank": rank, "data_rank": mesh.data_rank,
               "model_rank": mesh.model_rank,
               "cases": {arch: _case(mesh, arch, params[arch])
                         for arch in CASES[shape]},
               "collectives": _collectives(mesh)}
        if shape == (2, 1):
            res["weighted"] = _weighted(mesh, params[LLAMA])
            trained = res["cases"][LLAMA]["params"]
        elif trained is not None:
            res["served"] = _serve_from(mesh, trained)
        out[shape] = res
    return out


# ------------------------------------------------------------ the parent
@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    import repro.models as jmodels
    from repro.models import transformer as jtransformer
    from repro.optim import AdamW as JAdamW

    return jax, jnp, jconfigs, jmodels, jtransformer, JAdamW


def _jcfg(arch):
    _, _, jconfigs, _, _, _ = _jax()
    return dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               dtype="float32")


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The parameters both packages get, in the reference's layout: the
    port's init_model drawn from one seed (the reference's own init is
    slower to run and gives the same distribution)."""
    return convert.params_to_reference(tmodels.init_model(
        _cfg(arch), torch.Generator().manual_seed(0), device="cpu",
        trainable=True))


def _shard_loss(jcfg, shards):
    """The reference's loss over ``shards``: the mean of each shard's own
    ``loss_fn`` (one shard: the full batch's), and the mean ce and aux."""
    _, jnp, _, _, jtransformer, _ = _jax()

    def f(p):
        outs = [jtransformer.loss_fn(p, jcfg, sh) for sh in shards]
        n = len(outs)
        return (sum(o[0] for o in outs) / n,
                (sum(o[1][0] for o in outs) / n,
                 sum(o[1][1] for o in outs) / n))
    return f


@functools.lru_cache(maxsize=None)
def _reference(arch, data):
    """The reference's loss, ce, aux and gradients at the parameters, and
    STEPS AdamW steps (losses, the gradients of each step, the
    parameters after them), on the full batch or (``data`` > 1) as the
    mean of the data shards' own losses."""
    jax, jnp, _, _, _, JAdamW = _jax()
    jcfg = _jcfg(arch)
    shards = [jax.tree.map(jnp.asarray, sh)
              for sh in _shards(_batch(arch), data)]
    vg = jax.jit(jax.value_and_grad(_shard_loss(jcfg, shards), has_aux=True))
    p = jax.tree.map(jnp.asarray, _params(arch))
    opt = JAdamW(lr=LR, weight_decay=0.01)
    state, losses, step_grads, out = opt.init(p), [], [], {}
    for _ in range(STEPS):
        (loss, (ce, aux)), g = vg(p)
        losses.append(float(loss))
        step_grads.append(_by_name(jax.tree.map(np.asarray, g)))
        if not out:
            out = {"loss": float(loss), "ce": float(ce), "aux": float(aux),
                   "grads": step_grads[0]}
        p, state = opt.apply(g, state, p)
    out.update(losses=losses, step_grads=step_grads,
               params=_by_name(jax.tree.map(np.asarray, p)))
    return out


def _ref_for(shape, arch):
    """The yardstick of ``arch`` on ``shape``: per data shard for the MoE
    family on a mesh with data > 1 (weight_gather), else the full
    batch."""
    moe = bool(_cfg(arch).num_experts)
    return _reference(arch, shape[0] if moe else 1)


@functools.lru_cache(maxsize=None)
def _worlds() -> dict:
    """Both worlds, started at once in the background ({size: future}),
    so the parent computes the reference while the ranks run."""
    params = {arch: _params(arch) for arch in ARCHS}
    pool = ThreadPoolExecutor(len(WORLDS))
    return {size: pool.submit(run_ranks, _world, size, shapes, params)
            for size, shapes in WORLDS.items()}


@pytest.fixture(scope="module", autouse=True)
def _start_worlds():
    _worlds()


def _ranks(shape):
    return [r[shape] for r in _worlds()[shape[0] * shape[1]].result()]


def _by_name(tree):
    """A reference pytree as {port parameter name: numpy array}."""
    out = {}

    def walk(prefix, node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(prefix + (key,), value)
            elif prefix[:1] == ("layers",):
                for i, a in enumerate(np.asarray(value)):
                    out[".".join(("layers", str(i)) + prefix[1:]
                                 + (key,))] = a
            else:
                out[".".join(prefix + (key,))] = np.asarray(value)

    walk((), tree)
    return out


def _leaf_close(got: dict, want: dict, rel=GRAD_REL, absolute=1e-7):
    assert set(got) == set(want)
    for name, w in want.items():
        bar = rel * np.abs(w).max() + absolute
        err = np.abs(got[name] - w).max()
        assert err <= bar, (name, err, bar)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("shape,arch", CASE_IDS)
def test_loss_and_grads_match_reference(shape, arch):
    ref = _ref_for(shape, arch)
    for r in _ranks(shape):
        got = r["cases"][arch]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["ce"], ref["ce"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["aux"], ref["aux"], rtol=LOSS_RTOL,
                                   atol=1e-7)
        if got["grads"] is not None:
            _leaf_close(got["grads"], ref["grads"])


@pytest.mark.parametrize("shape,arch", CASE_IDS)
def test_train_steps_match_reference(shape, arch):
    ref = _ref_for(shape, arch)
    sens = {}  # per element: sum over steps of AdamW's gradient sensitivity
    for g in ref["step_grads"]:
        for name, a in g.items():
            err = GRAD_REL * np.abs(a).max() + 1e-7
            sens[name] = sens.get(name, 0.0) + np.minimum(
                2.0, err / np.maximum(np.abs(a), 1e-30))
    want = ref["params"]
    for r in _ranks(shape):
        got = r["cases"][arch]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=STEP_RTOL)
        assert got["losses"][-1] < got["losses"][0]
        params = _by_name(got["params"])
        assert set(params) == set(want)
        diffs = np.concatenate([np.abs(params[n] - want[n]).ravel()
                                for n in want])
        assert diffs.max() <= 2 * LR * STEPS
        bars = np.concatenate([(1e-6 + LR * sens[n]).ravel() for n in want])
        sharp = np.concatenate([(sens[n] <= 1e-3).ravel() for n in want])
        assert np.all(diffs <= bars), float(np.max(diffs / bars))
        assert np.mean(diffs[sharp] <= 1e-6) >= 0.999


def test_weighted_ce_is_the_global_one():
    """Loss weights whose share of ones differs between the two data
    shards of 2 x 1: the loss is the reference's global weighted CE
    (sum over both shards over the global sum of weights), which the
    mean of the shards' own weighted means misses by far more than the
    bar (shown on the port's unsharded logits); the gradients at the
    bar."""
    jax, jnp, _, _, jtransformer, _ = _jax()
    jcfg, batch = _jcfg(LLAMA), _batch(LLAMA, weighted=True)
    p = jax.tree.map(jnp.asarray, _params(LLAMA))
    (want, _), g = jax.jit(jax.value_and_grad(
        lambda q, b: jtransformer.loss_fn(q, jcfg, b), has_aux=True))(
            p, jax.tree.map(jnp.asarray, batch))
    model = convert.model_from_reference(_params(LLAMA), _cfg(LLAMA),
                                         device="cpu", trainable=True)
    with torch.no_grad():
        logits, _ = tmodels.forward(model, tokens=batch["tokens"])
    means = [float(tmodels.cross_entropy(lg, sh["labels"],
                                         sh["loss_weights"]))
             for lg, sh in zip(logits.chunk(2), _shards(batch, 2))]
    assert abs(np.mean(means) - float(want)) > 100 * LOSS_RTOL * abs(
        float(want))
    for r in _ranks((2, 1)):
        got = r["weighted"]
        np.testing.assert_allclose(got["loss"], float(want), rtol=LOSS_RTOL)
        _leaf_close(got["grads"], _by_name(jax.tree.map(np.asarray, g)))


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_agree_bitwise(shape):
    """The ranks of a data shard hold the same loss bits (every rank the
    same global loss, in fact); every model-replicated block's gradient
    and its parameters after the steps are bitwise equal across the
    ``model`` ranks of a data shard."""
    ranks = _ranks(shape)
    for arch in CASES[shape]:
        by_shard = {}
        for r in ranks:
            got = r["cases"][arch]
            assert got["losses"] == ranks[0]["cases"][arch]["losses"]
            first = by_shard.setdefault(r["data_rank"], got)
            assert got["loss"] == first["loss"]
            for key in ("grads_replicated", "params_replicated"):
                assert got[key].keys() == first[key].keys()
                for n, a in got[key].items():
                    np.testing.assert_array_equal(a, first[key][n],
                                                  err_msg=f"{arch} {n}")


@pytest.mark.parametrize("shape", MESHES)
def test_untouched_embedding_rows_have_zero_gradient(shape):
    """On every rank, the rows of its embedding block whose ids are not in
    the batch get a gradient of exactly 0 (the untied families; llama's
    tied embedding is the head, which reaches every row), and the rows
    of ids in it do not."""
    for r in _ranks(shape):
        for arch in CASES[shape]:
            if _cfg(arch).tie_embeddings:
                continue
            got = r["cases"][arch]
            lo, n = got["embed_rows"]
            seen = np.isin(np.arange(lo, lo + n), _batch(arch)["tokens"])
            g = got["embed_grad"]
            assert (g[~seen] == 0).all()
            assert (np.abs(g[seen]).max(axis=1) > 0).all()
            assert 0 < seen.sum() < n


def test_fsdp_trained_model_serves_on_another_mesh():
    """llama trained three steps on 2 x 1 (FSDP over data), gathered into
    the reference's layout, then cut as a serving model for 1 x 2: its
    leaves gathered back are the trained ones bitwise, and its prefill
    logits are the reference's prefill on the trained parameters at
    1e-4."""
    jax, jnp, _, jmodels, _, _ = _jax()
    trained = _ranks((2, 1))[0]["cases"][LLAMA]["params"]
    logits, _ = jmodels.prefill(jax.tree.map(jnp.asarray, trained),
                                _jcfg(LLAMA), tokens=jnp.asarray(
                                    _batch(LLAMA)["tokens"]))
    want = _by_name(trained)
    for r in _ranks((1, 2)):
        got = _by_name(r["served"]["leaves"])
        assert got.keys() == want.keys()
        for n, a in want.items():
            np.testing.assert_array_equal(got[n], a, err_msg=n)
        np.testing.assert_allclose(r["served"]["logits"], np.asarray(logits),
                                   rtol=SERVE_TOL, atol=SERVE_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_collective_backwards(shape):
    """copy_to's backward sums over the axis, sum_fp32's passes the
    cotangent through, gather_replicated's keeps the rank's block and
    gather_split's sums over the axis and keeps it, over both axes."""
    for r in _ranks(shape):
        bad = [k for k, ok in r["collectives"].items() if not ok]
        assert not bad


# ---------------------------------------------------- in this process
@pytest.fixture
def deterministic():
    """torch's deterministic implementations for the test: on the CPU the
    embedding's backward (``index_put_`` with accumulate) otherwise adds
    repeated ids' rows in an order that varies between threads, so even
    the unsharded step is not bitwise repeatable."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_step_is_the_unsharded_step_bitwise(arch,
                                                           deterministic):
    cfg, mesh = _cfg(arch), Mesh(1, 1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    runs = []
    for m in (None, mesh):
        model = convert.model_from_reference(_params(arch), cfg,
                                             device="cpu", trainable=True,
                                             mesh=m)
        loss, _, grads = tmodels.loss_and_grads(model, batch)
        opt, step = tmodels.make_train_step(model, lr=LR, mesh=m)
        state, losses = opt.init(dict(model.named_parameters())), []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        runs.append((loss, grads, losses,
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()}))
    (l0, g0, s0, p0), (l1, g1, s1, p1) = runs
    assert torch.equal(l0, l1) and s0 == s1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
        assert torch.equal(p0[n], p1[n]), n


def test_training_layout_is_param_specs_whole():
    """A trainable model on a mesh takes every "data" entry (FSDP); a
    serving model keeps PR 25's layout; the FSDP blocks carry their
    dimension for ``sharding.at_use``, the experts (gathered by
    weight_gather itself) do not."""
    import types

    mesh = types.SimpleNamespace(data=2, model=2, size=4, rank=0,
                                 data_rank=0, model_rank=0,
                                 shape={"data": 2, "model": 2})
    granite = _cfg(MOE_ARCH)
    train = tmodels.Transformer(granite, device="meta", trainable=True,
                                mesh=mesh)
    serve = tmodels.Transformer(granite, device="meta", mesh=mesh)
    t, s = train.leaf_specs(), serve.leaf_specs()
    assert t["layers.0.attn.wq"] == (("data", "model"), SH.CONTIGUOUS)
    assert s["layers.0.attn.wq"] == ((None, "model"), SH.CONTIGUOUS)
    assert t["layers.0.ffn.w1"] == s["layers.0.ffn.w1"] == (
        ("model", None, "data"), SH.CONTIGUOUS)
    assert train.layers[0].attn.wq.fsdp_dim == 0
    assert train.layers[0].attn.wo.fsdp_dim == 1
    assert train.embed.fsdp_dim == 1
    assert not hasattr(train.layers[0].ffn.w1, "fsdp_dim")
    assert not hasattr(train.layers[0].norm1, "fsdp_dim")
    assert not any(hasattr(p, "fsdp_dim") for p in serve.parameters())
    assert tuple(train.layers[0].attn.wq.shape) == (
        granite.d_model // 2, granite.num_heads * granite.head_dim // 2)
    assert tmodels.transformer.data_replicated(train) == [
        n for n, (spec, _) in t.items() if "data" not in spec]
    ssm = _cfg(SSM)
    spec = SH.training_spec(tmodels.param_specs(ssm, 2),
                            "layers.0.mamba.in_proj", ssm)
    assert spec == (("data", "model"), ((ssm.d_inner, True),
                                        (ssm.d_inner, True)))
    # the x/z halves are cut over model only; d is cut over data in one
    # contiguous block
    leaf = torch.arange(4 * 8.0).reshape(4, 8)
    block = SH.local_block(leaf, spec[0], types.SimpleNamespace(
        shape={"data": 2, "model": 2}, data_rank=1, model_rank=1),
        ((4, True), (4, True)))
    assert torch.equal(block, leaf[2:, [2, 3, 6, 7]])


def test_granite_bf16_gradients_are_within_the_references_own_distance():
    """The witness for granite-moe's bf16 gradients (``ROADMAP.md`` C): on
    the reference's own init and ``tests/test_torch_lm_train.py``'s batch
    (B 2 x 16), each package's bf16 gradients against its own fp32 ones.
    The port's every leaf sits within the 5e-2 max|g| bf16 bar of its
    fp32 gradient, and its worst leaf closer than the reference's own
    worst (the reference's router part by ~0.3 max|g| from its own fp32,
    which is the whole of the port-vs-reference bf16 gap). Both packages
    route every token of the bf16 forward to the same experts in the same
    order, and each (token, choice) whose expert differs from the fp32
    forward is a near tie: two experts whose fp32 probabilities lie
    within 1e-3."""
    import repro.models as jmodels
    from repro.models import moe as jmoe

    jax, jnp, jconfigs, _, jtransformer, _ = _jax()
    jcfg = {dt: dataclasses.replace(jconfigs.get_config(MOE_ARCH).reduced(),
                                    dtype=dt)
            for dt in ("float32", "bfloat16")}
    tcfg = {dt: dataclasses.replace(_cfg(MOE_ARCH), dtype=dt) for dt in jcfg}
    params = jax.tree.map(np.asarray, jmodels.init_model(
        jcfg["float32"], jax.random.PRNGKey(0)))
    b = TokenStream(tcfg["float32"].vocab_size, seed=1).batch(2, S + 1)
    batch = {"tokens": b["tokens"], "labels": b["labels"]}
    jp, jb = (jax.tree.map(jnp.asarray, t) for t in (params, batch))
    ref, port, routes = {}, {}, {}
    for dt in jcfg:
        _, g = jax.jit(jax.value_and_grad(lambda p, bb: jtransformer.loss_fn(
            p, jcfg[dt], bb), has_aux=True))(jp, jb)
        ref[dt] = _by_name(jax.tree.map(np.asarray, g))
        model = convert.model_from_reference(params, tcfg[dt], device="cpu",
                                             trainable=True)
        grads = tmodels.loss_and_grads(model, {
            k: torch.from_numpy(v) for k, v in batch.items()})[2]
        port[dt] = {n: g.float().numpy() for n, g in grads.items()}
        seen, route = [], tmodels.moe.route

        def recording(x, w, k):
            gate, idx, probs = route(x, w, k)
            seen.append((idx.numpy().copy(), probs.detach().numpy().copy()))
            return gate, idx, probs

        tmodels.moe.route = recording
        try:
            with torch.no_grad():
                tmodels.forward(model, tokens=batch["tokens"], remat=False)
        finally:
            tmodels.moe.route = route
        routes["port", dt] = seen
    seen, route = [], jmoe._route

    def recording_ref(x, w, k):
        gate, idx, probs = route(x, w, k)
        seen.append(np.asarray(idx).copy())
        return gate, idx, probs

    jmoe._route = recording_ref
    try:
        with jax.disable_jit():
            jtransformer.forward(jp, jcfg["bfloat16"],
                                 tokens=jnp.asarray(batch["tokens"]),
                                 remat=False)
    finally:
        jmoe._route = route

    def own(g):
        return {n: np.abs(g["bfloat16"][n] - w).max() / np.abs(w).max()
                for n, w in g["float32"].items()}

    port_own, ref_own = own(port), own(ref)
    assert max(port_own.values()) <= 5e-2, max(port_own.items(),
                                               key=lambda kv: kv[1])
    assert max(port_own.values()) < max(ref_own.values())
    assert ref_own["layers.1.ffn.router"] > 5e-2  # the reference's own gap
    for (i16, _), j16 in zip(routes["port", "bfloat16"], seen):
        np.testing.assert_array_equal(i16, j16)
    for (i16, _), (i32, p32) in zip(routes["port", "bfloat16"],
                                    routes["port", "float32"]):
        t, c = np.nonzero(i16 != i32)
        gaps = np.abs(p32[t, i16[t, c]] - p32[t, i32[t, c]])
        assert (gaps < 1e-3).all(), gaps
