"""What the port's LM runs on a mesh with ``model`` > 1 (``ROADMAP.md``
A12e), against the reference's UNSHARDED runs on the CPU, on the same
numpy parameters and batches: zamba2's Mamba2 split over ``model``
(serving and training), sequence parallelism (``cfg.seq_parallel``) and
``attn_shard="head_dim"``.

Reduced configs in fp32 (2 layers of each kind, narrow widths), batch 4
x 32 tokens from a seeded numpy generator, parameters drawn by the
port's ``init_model`` from one seed and handed to both packages. The
ranks run as spawned gloo worlds (``launch.mesh.run_ranks``): one of 4
ranks (2 x 2) and one of 2 that runs 1 x 2 and then 2 x 1, both started
at the module's first test and run in the background while the parent
computes the reference; a third world of 2 ranks serves on 1 x 2 the
zamba2 that the 2 x 2 world trained. The ranks' worker is this module's
:func:`_world`, so a rank imports this module: it imports no JAX at
module level.

Bars (``tests/test_torch_lm_shard.py``'s and
``tests/test_torch_lm_train.py``'s): prefill logits, the caches gathered
into the reference's layout and 4 decode steps at rtol = atol = 1e-4,
greedy tokens equal; the loss at rtol 1e-5, every gathered gradient
leaf within 1e-4 max |g_ref| + 1e-7, three AdamW steps at lr 1e-3 as
``tests/test_torch_lm_train_shard.py`` holds them. granite-moe's
``weight_gather`` on two data shards is held against the reference run
on each shard's rows alone (its own semantics). Within the port: under
``seq_parallel`` the prefill logits, the loss and every gradient but the
norm scales' bitwise those of ``seq_parallel=False`` on the same mesh
(a norm scale's gradient is summed over the rank's positions and then
over ``model``: the same sum in another order, held at the gradient
bar); the ranks of a data shard bitwise; a 1 x 1 mesh bitwise the
unsharded path; and a zamba2 trained on 2 x 2 gathered and cut again for
1 x 2 bitwise. The gated RMSNorm's sum over ``model`` and the B and C
weights' gradient sums are each shown to be needed exactly once: with
either taken zero times or twice, the 1 x 2 gradients leave the bar.
"""
import dataclasses
import functools
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import convert
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import sharding as SH
from repro_torch.models import ssm as SS
from repro_torch.models.generate import fill_caches, generate

LLAMA, SSM, MOE_ARCH, HYBRID = ("llama3.2-1b", "falcon-mamba-7b",
                                "granite-moe-1b-a400m", "zamba2-2.7b")
# the configs by key: (arch, overrides of its reduced config); llama-kvh1
# has one KV head, which no model > 1 divides
CFGS = {"llama": (LLAMA, {}), "granite": (MOE_ARCH, {}),
        "falcon": (SSM, {}), "zamba2": (HYBRID, {}),
        "llama-kvh1": (LLAMA, {"num_kv_heads": 1})}
KNOBS = {"base": {}, "sp": {"seq_parallel": True},
         "hd": {"attn_shard": "head_dim"}}
B, S, DECODE, LR, STEPS = 4, 32, 4, 1e-3, 3
TOL, LOSS_RTOL, GRAD_REL, STEP_RTOL = 1e-4, 1e-5, 1e-4, 1e-4
SP_KEYS = ("llama", "granite", "falcon", "zamba2")
HD_KEYS = ("llama", "llama-kvh1")
# what each mesh runs: zamba2 served and trained everywhere; the knobs
# on the meshes with model > 1
CASES = {(1, 2): {"zamba2": ("serve", "train"), "sp": SP_KEYS,
                  "hd": HD_KEYS, "witness": True},
         (2, 2): {"zamba2": ("serve", "train"), "sp": SP_KEYS},
         (2, 1): {"zamba2": ("serve", "train")}}
WORLDS = {4: ((2, 2),), 2: ((1, 2), (2, 1))}
MESHES = [(1, 2), (2, 2), (2, 1)]
NORM_SCALES = ("norm", "norm1", "norm2", "final_norm")


def _cfg(key, knob="base"):
    arch, over = CFGS[key]
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               dtype="float32", **over, **KNOBS[knob])


def _batch(key) -> dict:
    t = np.random.default_rng(1).integers(0, _cfg(key).vocab_size,
                                          (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _decode_tokens(key) -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, _cfg(key).vocab_size, (B, DECODE)).astype(np.int32)


def _rows(batch: dict, mesh) -> dict:
    return {k: SH.batch_rows(torch.from_numpy(v), mesh)
            for k, v in batch.items()}


def _gathered(model, tensors: dict) -> dict:
    cuts = model.leaf_specs()
    return {n: SH.gather_block(t.detach(), cuts[n][0], model.mesh,
                               cuts[n][1]).numpy()
            for n, t in tensors.items()}


# ------------------------------------------------------------- the ranks
def _serve(mesh, key, knob, params):
    """Prefill (logits, the caches gathered into the reference's layout),
    DECODE steps on _decode_tokens, greedy generate."""
    cfg = _cfg(key, knob)
    model = convert.model_from_reference(params, cfg, device="cpu",
                                         mesh=mesh)
    logits, c0 = tmodels.prefill(model, tokens=_rows(_batch(key), mesh)[
        "tokens"])
    layout = tmodels.cache_layout(cfg, True, mesh.model)
    out = {"prefill": logits.numpy(),
           "caches": {n: SH.gather_block(c, layout[n][0], mesh,
                                         layout[n][1]).numpy()
                      for n, c in c0.items()}}
    caches = fill_caches(tmodels.init_caches(
        cfg, B, S + DECODE, dtype=torch.float32, device="cpu", mesh=mesh),
        c0)
    step = tmodels.make_serve_step(model)
    dec, steps = _decode_tokens(key), []
    for i in range(DECODE):
        lg, caches = step(caches, SH.batch_rows(torch.from_numpy(dec[:, i]),
                                                mesh), S + i)
        steps.append(lg.numpy())
    out["decode"] = np.stack(steps)
    out["tokens"] = generate(model, torch.from_numpy(_batch(key)["tokens"]),
                             DECODE, temperature=0.0).numpy()
    return out


def _train(mesh, key, knob, params, steps=1):
    """The loss and every gradient (gathered), then ``steps`` - 1 more
    AdamW steps after the first update (losses, the parameters
    gathered), and the forward's logits."""
    cfg = _cfg(key, knob)
    model = convert.model_from_reference(params, cfg, device="cpu",
                                         trainable=True, mesh=mesh)
    rows = _rows(_batch(key), mesh)
    loss, (ce, aux), grads = tmodels.loss_and_grads(model, rows)
    out = {"loss": float(loss.detach()), "aux": float(aux.detach()),
           "grads": _gathered(model, grads), "losses": [float(loss)]}
    if steps > 1:
        opt, step = tmodels.make_train_step(model, lr=LR)
        params_ = dict(model.named_parameters())
        _, state = opt.apply(grads, opt.init(params_), params_)
        for _ in range(steps - 1):
            state, m = step(state, rows)
            out["losses"].append(float(m["loss"]))
        out["params"] = convert.params_to_reference(model)
    with torch.no_grad():
        out["logits"] = tmodels.forward(model, tokens=rows["tokens"])[
            0].numpy()
    return out


def _prefill(mesh, key, knob, params):
    model = convert.model_from_reference(params, _cfg(key, knob),
                                         device="cpu", mesh=mesh)
    return tmodels.prefill(model, tokens=_rows(_batch(key), mesh)["tokens"])


def _sp_pair(mesh, key, params):
    """``key`` trained without and with ``seq_parallel`` on ``mesh``: the
    leaves whose gradients differ in any bit; both prefills' logits and
    caches bitwise equal; and the S that does not divide raising."""
    base, sp = (_train(mesh, key, knob, params) for knob in ("base", "sp"))
    differ = sorted(n for n in base["grads"]
                    if not np.array_equal(base["grads"][n], sp["grads"][n]))
    (lb, cb), (ls, cs) = (_prefill(mesh, key, k, params) for k in ("base",
                                                                   "sp"))
    prefill_bitwise = torch.equal(lb, ls) and cb.keys() == cs.keys() and all(
        torch.equal(cb[n], cs[n]) for n in cb)
    model = convert.model_from_reference(params, _cfg(key, "sp"),
                                         device="cpu", mesh=mesh)
    try:
        tmodels.prefill(model, tokens=torch.zeros((B // mesh.data, S - 1),
                                                  dtype=torch.int64))
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"sp": sp, "loss_bitwise": base["loss"] == sp["loss"],
            "logits_bitwise": np.array_equal(base["logits"], sp["logits"]),
            "prefill_bitwise": prefill_bitwise,
            "differ": differ, "raised": raised,
            "grads_base": {n: base["grads"][n] for n in differ}}


def _witness(mesh, params):
    """zamba2's gradients on 1 x 2 with the gated RMSNorm's backward sum
    and the B/C weights' sums each taken zero times and twice."""
    whole, copy_to = SS._whole_cols, SS.copy_to

    def norm_sum(times):
        def fn(x, m, axis):  # the norm's sum of squares has a last dim of 1
            if x.shape[-1] != 1:
                return copy_to(x, m, axis)
            for _ in range(times):
                x = copy_to(x, m, axis)
            return x
        return fn

    patches = {
        "bc_zero": ("_whole_cols", lambda w, lo, hi, m: w),
        "bc_twice": ("_whole_cols", lambda w, lo, hi, m: whole(
            whole(w, lo, hi, m), lo, hi, m)),
        "norm_zero": ("copy_to", norm_sum(0)),
        "norm_twice": ("copy_to", norm_sum(2))}
    out = {}
    for name, (attr, fn) in patches.items():
        setattr(SS, attr, fn)
        try:
            out[name] = _train(mesh, "zamba2", "base", params)["grads"]
        finally:
            SS._whole_cols, SS.copy_to = whole, copy_to
    return out


def _world(rank, dev, shapes, params):
    """One rank of a world that runs each mesh of ``shapes`` in turn."""
    out = {}
    for shape in shapes:
        mesh, case = Mesh(*shape), CASES[shape]
        res = {"rank": rank, "data_rank": mesh.data_rank}
        if "serve" in case["zamba2"]:
            res["zamba2_serve"] = _serve(mesh, "zamba2", "base",
                                         params["zamba2"])
        res["zamba2_train"] = _train(mesh, "zamba2", "base",
                                     params["zamba2"], STEPS)
        res["sp"] = {k: _sp_pair(mesh, k, params[k])
                     for k in case.get("sp", ())}
        res["hd"] = {k: {"serve": _serve(mesh, k, "hd", params[k]),
                         "train": _train(mesh, k, "hd", params[k])}
                     for k in case.get("hd", ())}
        if case.get("witness"):
            res["witness"] = _witness(mesh, params["zamba2"])
        out[shape] = res
    return out


def _round_trip(rank, dev, trained):
    """The zamba2 trained on 2 x 2 (the reference's layout), cut as a
    serving model for 1 x 2: its leaves gathered back, its prefill."""
    mesh = Mesh(1, 2)
    model = convert.model_from_reference(trained, _cfg("zamba2"),
                                         device="cpu", mesh=mesh)
    logits, _ = tmodels.prefill(model, tokens=torch.from_numpy(
        _batch("zamba2")["tokens"]))
    return {"leaves": convert.params_to_reference(model),
            "logits": logits.numpy()}


# ------------------------------------------------------------ the parent
@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    import repro.models as jmodels
    from repro.models import transformer as jtransformer
    from repro.models.generate import generate as jgenerate
    from repro.optim import AdamW as JAdamW

    return jax, jnp, jconfigs, jmodels, jtransformer, jgenerate, JAdamW


def _jcfg(key, knob="base"):
    jconfigs = _jax()[2]
    arch, over = CFGS[key]
    return dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               dtype="float32", **over, **KNOBS[knob])


@functools.lru_cache(maxsize=None)
def _params(key):
    return convert.params_to_reference(tmodels.init_model(
        _cfg(key), torch.Generator().manual_seed(0), device="cpu",
        trainable=True))


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


@functools.lru_cache(maxsize=None)
def _ref_train(key, data=1, steps=1):
    """The reference's loss and gradients at the parameters (the mean of
    the data shards' own losses when ``data`` > 1) and, for ``steps`` >
    1, the losses and each step's gradients of ``steps`` AdamW steps and
    the parameters after them."""
    jax, jnp, _, _, jtransformer, _, JAdamW = _jax()
    jcfg, batch = _jcfg(key), _batch(key)
    shards = [{k: jnp.asarray(v) for k, v in zip(batch, parts)}
              for parts in zip(*(np.split(v, data) for v in batch.values()))]

    def f(p):
        outs = [jtransformer.loss_fn(p, jcfg, sh) for sh in shards]
        return (sum(o[0] for o in outs) / data,
                sum(o[1][1] for o in outs) / data)

    vg = jax.jit(jax.value_and_grad(f, has_aux=True))
    p = jax.tree.map(jnp.asarray, _params(key))
    opt = JAdamW(lr=LR, weight_decay=0.01)
    state, losses, step_grads = opt.init(p), [], []
    for i in range(steps):
        (loss, aux), g = vg(p)
        losses.append(float(loss))
        step_grads.append(_by_name(jax.tree.map(np.asarray, g)))
        if i == 0:
            out = {"loss": float(loss), "aux": float(aux),
                   "grads": step_grads[0]}
        if steps > 1:
            p, state = opt.apply(g, state, p)
    out.update(losses=losses, step_grads=step_grads,
               params=_by_name(jax.tree.map(np.asarray, p)))
    return out


@functools.lru_cache(maxsize=None)
def _ref_serve(key):
    """The reference's unsharded full-batch prefill, caches, decode steps
    and greedy tokens."""
    jax, jnp, _, jmodels, _, jgenerate, _ = _jax()
    jcfg = _jcfg(key)
    params = jax.tree.map(jnp.asarray, _params(key))
    toks, dec = _batch(key)["tokens"], _decode_tokens(key)
    logits, caches = jax.jit(lambda p, t: jmodels.prefill(
        p, jcfg, tokens=t))(params, jnp.asarray(toks))
    out = {"prefill": np.asarray(logits),
           "caches": {n: np.asarray(c) for n, c in caches.items()}}
    big = {n: (jnp.pad(c, [(0, 0)] * 2 + [(0, DECODE)] + [(0, 0)] *
                       (c.ndim - 3)) if n in ("k", "v") else c)
           for n, c in caches.items()}
    decode = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
        p, jcfg, c, token=t, pos=pos))
    steps = []
    for i in range(DECODE):
        lg, big = decode(params, big, jnp.asarray(dec[:, i]),
                         jnp.asarray(S + i))
        steps.append(np.asarray(lg))
    out["decode"] = np.stack(steps)
    out["tokens"] = np.asarray(jgenerate(params, jcfg, jnp.asarray(toks),
                                         DECODE, jax.random.PRNGKey(0),
                                         temperature=0.0))
    return out


@functools.lru_cache(maxsize=None)
def _worlds() -> dict:
    """The worlds, started at once in the background ({name: future}):
    the round trip starts when the 2 x 2 world is done."""
    params = {key: _params(key) for key in CFGS}
    pool = ThreadPoolExecutor(len(WORLDS) + 1)
    futures = {size: pool.submit(run_ranks, _world, size, shapes, params)
               for size, shapes in WORLDS.items()}

    def trip():
        trained = futures[4].result()[0][(2, 2)]["zamba2_train"]["params"]
        return run_ranks(_round_trip, 2, trained)

    futures["trip"] = pool.submit(trip)
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_worlds():
    _worlds()


def _ranks(shape):
    return [r[shape] for r in _worlds()[shape[0] * shape[1]].result()]


def _split(a, data, data_rank):
    return np.split(a, data)[data_rank]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _leaf_close(got: dict, want: dict, rel=GRAD_REL, absolute=1e-7):
    assert set(got) == set(want)
    for name, w in want.items():
        bar = rel * np.abs(w).max() + absolute
        err = np.abs(got[name] - w).max()
        assert err <= bar, (name, err, bar)


def _steps_close(got, ref):
    """Three AdamW steps as tests/test_torch_lm_train_shard.py holds
    them: the losses, every parameter within 2 lr n and within AdamW's
    own sensitivity to the gradient bar."""
    sens = {}
    for g in ref["step_grads"]:
        for name, a in g.items():
            err = GRAD_REL * np.abs(a).max() + 1e-7
            sens[name] = sens.get(name, 0.0) + np.minimum(
                2.0, err / np.maximum(np.abs(a), 1e-30))
    want = ref["params"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=STEP_RTOL)
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


# ------------------------------------------------------------------ zamba2
@pytest.mark.parametrize("shape", MESHES)
def test_zamba2_serving_matches_reference(shape):
    """Prefill logits, the caches (conv and ssm by the port's layout, k/v)
    gathered into the reference's layout, 4 decode steps and the greedy
    tokens against the reference's unsharded run; the ranks of a data
    shard bitwise."""
    ref = _ref_serve("zamba2")
    first = {}
    for r in _ranks(shape):
        got, d = r["zamba2_serve"], r["data_rank"]
        _close(got["prefill"], _split(ref["prefill"], shape[0], d))
        _close(got["decode"], np.stack([_split(s, shape[0], d)
                                        for s in ref["decode"]]))
        assert got["caches"].keys() == ref["caches"].keys()
        for name, c in ref["caches"].items():
            assert got["caches"][name].shape == c.shape, name
            _close(got["caches"][name], c)
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        seen = first.setdefault(d, got)
        for k in ("prefill", "decode"):
            np.testing.assert_array_equal(got[k], seen[k])


@pytest.mark.parametrize("shape", MESHES)
def test_zamba2_loss_and_grads_match_reference(shape):
    ref = _ref_train("zamba2", 1, STEPS)
    for r in _ranks(shape):
        got = r["zamba2_train"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        _leaf_close(got["grads"], ref["grads"])


@pytest.mark.parametrize("shape", MESHES)
def test_zamba2_train_steps_match_reference(shape):
    ref = _ref_train("zamba2", 1, STEPS)
    ranks = _ranks(shape)
    for r in ranks:
        _steps_close(r["zamba2_train"], ref)
        assert r["zamba2_train"]["losses"] == ranks[0]["zamba2_train"][
            "losses"]


@pytest.mark.parametrize("case", ["bc_zero", "bc_twice", "norm_zero",
                                  "norm_twice"])
def test_each_model_sum_of_mamba2_is_needed_once(case):
    """On 1 x 2, the gradients with the B/C weights' sum over ``model``
    (in_proj's B and C columns, conv_w's and conv_b's B and C channels)
    or the gated RMSNorm's backward sum taken zero times or twice leave
    the bar of the unsharded reference, in the leaves they feed; taken
    once (:func:`test_zamba2_loss_and_grads_match_reference`) every leaf
    is within it."""
    cfg = _cfg("zamba2")
    di, N = cfg.d_inner, cfg.ssm_state
    bc = {"layers.0.mamba.in_proj": np.s_[:, 2 * di:2 * di + 2 * N],
          "layers.0.mamba.conv_w": np.s_[:, di:di + 2 * N],
          "layers.0.mamba.conv_b": np.s_[di:di + 2 * N]}
    want = _ref_train("zamba2", 1, STEPS)["grads"]
    for r in _ranks((1, 2)):
        got = r["witness"][case]
        leaves = bc if case.startswith("bc") else {
            "layers.0.mamba.in_proj": np.s_[:, :2 * di]}
        for name, cols in leaves.items():
            w, g = want[name][cols], got[name][cols]
            bar = GRAD_REL * np.abs(want[name]).max() + 1e-7
            assert np.abs(g - w).max() > 10 * bar, (name, case)


def test_a_zamba2_trained_on_2x2_serves_on_1x2():
    """The zamba2 trained three steps on 2 x 2 (FSDP over data, heads over
    model), gathered into the reference's layout and cut as a serving
    model for 1 x 2: its leaves gathered back are the trained ones
    bitwise, and its prefill logits are the reference's prefill on the
    trained parameters at 1e-4."""
    jax, jnp, _, jmodels, _, _, _ = _jax()
    trained = _ranks((2, 2))[0]["zamba2_train"]["params"]
    logits, _ = jax.jit(lambda p, t: jmodels.prefill(p, _jcfg("zamba2"),
                                                     tokens=t))(
        jax.tree.map(jnp.asarray, trained),
        jnp.asarray(_batch("zamba2")["tokens"]))
    want = _by_name(trained)
    for r in _worlds()["trip"].result():
        got = _by_name(r["leaves"])
        assert got.keys() == want.keys()
        for n, a in want.items():
            np.testing.assert_array_equal(got[n], a, err_msg=n)
        _close(r["logits"], np.asarray(logits))


# ------------------------------------------------------------ seq_parallel
SP_IDS = [(shape, key) for shape in ((1, 2), (2, 2)) for key in SP_KEYS]


@pytest.mark.parametrize("shape,key", SP_IDS)
def test_seq_parallel_is_the_same_mesh_without_it(shape, key):
    """The forward's logits, prefill's logits and caches and the loss
    bitwise those of ``seq_parallel=False`` on the same mesh, every
    gradient too but the norm scales' (summed over ``model`` after each
    rank's positions), which sit within the gradient bar of them; an S
    that does not divide by ``model`` raises, naming S."""
    for r in _ranks(shape):
        got = r["sp"][key]
        assert got["logits_bitwise"] and got["loss_bitwise"]
        assert got["prefill_bitwise"]
        assert all(n.rsplit(".", 1)[-1] in NORM_SCALES
                   for n in got["differ"]), got["differ"]
        _leaf_close({n: got["sp"]["grads"][n] for n in got["differ"]},
                    got["grads_base"])
        assert got["raised"] and "S = 31" in got["raised"]


@pytest.mark.parametrize("shape,key", SP_IDS)
def test_seq_parallel_matches_reference(shape, key):
    """The loss and every gradient against the reference's unsharded run
    (granite's weight_gather on two data shards: per shard)."""
    data = shape[0] if _cfg(key).num_experts else 1
    ref = _ref_train(key, data)
    for r in _ranks(shape):
        got = r["sp"][key]["sp"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["aux"], ref["aux"], rtol=LOSS_RTOL,
                                   atol=1e-7)
        _leaf_close(got["grads"], ref["grads"])


# ---------------------------------------------------- attn_shard=head_dim
@pytest.mark.parametrize("key", HD_KEYS)
def test_head_dim_matches_reference(key):
    """llama under ``attn_shard="head_dim"`` on 1 x 2, and a llama whose
    one KV head no model > 1 divides: prefill logits, 4 decode steps,
    greedy tokens, the caches (whole on every rank), the loss and every
    gradient against the reference's unsharded run."""
    serve, train = _ref_serve(key), _ref_train(key)
    for r in _ranks((1, 2)):
        got = r["hd"][key]
        _close(got["serve"]["prefill"], serve["prefill"])
        _close(got["serve"]["decode"], serve["decode"])
        np.testing.assert_array_equal(got["serve"]["tokens"],
                                      serve["tokens"])
        for name, c in serve["caches"].items():
            _close(got["serve"]["caches"][name], c)
        np.testing.assert_allclose(got["train"]["loss"], train["loss"],
                                   rtol=LOSS_RTOL)
        _leaf_close(got["train"]["grads"], train["grads"])


# ---------------------------------------------------- in this process
@pytest.fixture
def deterministic():
    """torch's deterministic implementations (the CPU's embedding
    backward is not repeatable otherwise)."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.parametrize("knob", ["base", "sp", "hd"])
def test_one_by_one_mesh_is_the_unsharded_zamba2_bitwise(knob, deterministic):
    """zamba2 (under each knob, which a 1 x 1 mesh leaves idle) on a 1 x 1
    mesh: prefill logits and caches, a decode step, the loss, every
    gradient and the parameters after two updates bitwise the unsharded
    path's."""
    cfg, mesh = _cfg("zamba2", knob), Mesh(1, 1)
    batch = {k: torch.from_numpy(v) for k, v in _batch("zamba2").items()}
    runs = []
    for m in (None, mesh):
        model = convert.model_from_reference(_params("zamba2"), cfg,
                                             device="cpu", mesh=m)
        logits, caches = tmodels.prefill(model, tokens=batch["tokens"],
                                         mesh=m)
        step, _ = tmodels.decode_step(model, caches, token=batch["tokens"][
            :, 0], pos=S, window=True, mesh=m)
        model = convert.model_from_reference(_params("zamba2"), cfg,
                                             device="cpu", trainable=True,
                                             mesh=m)
        loss, _, grads = tmodels.loss_and_grads(model, batch)
        opt, train_step = tmodels.make_train_step(model, lr=LR, mesh=m)
        state = opt.init(dict(model.named_parameters()))
        for _ in range(2):
            state, _ = train_step(state, batch)
        runs.append((logits, caches, step, loss, grads,
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()}))
    (l0, c0, d0, s0, g0, p0), (l1, c1, d1, s1, g1, p1) = runs
    assert torch.equal(l0, l1) and torch.equal(d0, d1) and torch.equal(s0,
                                                                       s1)
    assert all(torch.equal(c0[n], c1[n]) for n in c0)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
        assert torch.equal(p0[n], p1[n]), n


def test_mamba2_layout_cuts_by_segments():
    """A rank holds [z_r | x_r | B | C | dt_r] of Mamba2's in_proj, [x_r |
    B | C] of conv_w and of the conv cache, its heads of dt_bias / A_log
    / D and of the ssm cache; gathering puts every leaf back."""
    cfg = dataclasses.replace(_cfg("zamba2"), d_model=8, ssm_expand=2,
                              ssm_headdim=4, ssm_state=2)
    di, N, nh = 16, 2, 4
    specs = tmodels.param_specs(cfg, 2)
    spec, parts = SH.serving_spec(specs, "layers.0.mamba.in_proj", cfg)
    assert spec == (None, "model") and parts == (
        (di, True), (di, True), (2 * N, False), (nh, True))
    assert SH.training_spec(specs, "layers.0.mamba.D", cfg) == (
        ("model",), SH.CONTIGUOUS)
    assert SH.serving_spec(specs, "layers.0.mamba.norm_scale", cfg) == (
        ("model",), SH.CONTIGUOUS)
    leaf = torch.arange(2 * (2 * di + 2 * N + nh)).reshape(2, -1)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, model=2,
                                 data=1, model_rank=1, data_rank=0)
    block = SH.local_block(leaf, spec, mesh, parts)
    cols = (list(range(8, 16)) + list(range(24, 32)) + list(range(32, 36))
            + [38, 39])
    assert torch.equal(block, leaf[:, cols])
    assert SH.local_shape(leaf.shape, spec, mesh.shape, parts) == (2, 22)
    layout = tmodels.cache_layout(cfg, True, 2)
    assert layout["conv"] == ((None, "data", None, "model"),
                              ((di, True), (2 * N, False)))
    assert layout["ssm"] == ((None, "data", "model", None, None),
                             SH.CONTIGUOUS)
    assert layout["k"] == ((None, "data", None, "model", None),
                           SH.CONTIGUOUS)
    hd = tmodels.cache_layout(dataclasses.replace(cfg, attn_shard="head_dim"),
                              False, 2)
    assert hd["k"] == ((None, None, None, None, None), SH.CONTIGUOUS)

    class Gathering:  # a 2-rank model axis in one process
        shape, model, data = {"data": 1, "model": 2}, 2, 1

        def __init__(self, full, spec, parts):
            self.full, self.spec, self.parts = full, spec, parts

        def gather(self, blk, axis, dim):
            return torch.cat([SH.local_block(self.full, self.spec,
                                             types.SimpleNamespace(
                                                 shape=self.shape,
                                                 model_rank=r, data_rank=0),
                                             self.parts)
                              for r in range(2)], dim)

    assert torch.equal(SH.gather_block(block, spec, Gathering(leaf, spec,
                                                              parts), parts),
                       leaf)
