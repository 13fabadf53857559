"""Placement of the LM's parameters and caches on a (data, model) mesh.

The port's counterpart of the reference's ``NamedSharding`` placement by
``param_specs`` / ``cache_specs`` (``repro/models/transformer.py``). The
reference hands GSPMD a global array and a spec; here each rank of a
:class:`~repro_torch.launch.mesh.Mesh` holds only its block of each leaf,
cut from the full leaf by the same spec (:func:`local_block`), and the
blocks go back together by exact all-gathers (:func:`gather_block`). A
spec is a tuple with one entry per dimension: ``None``, ``"data"`` or
``"model"``; a named dimension is cut into equal contiguous blocks, one
per rank of that axis, in rank order.

The layout follows whether the model trains. A trainable model takes
``param_specs`` whole (:func:`training_spec`): its ``"data"`` entries
are FSDP, so a rank holds a 1 / data slice of every such leaf and
gathers the rest at each use (:func:`at_use`, whose backward
reduce-scatters the gradient over ``data``). The serving layout
(:func:`serving_spec`) is ``param_specs`` with one departure
(``ROADMAP.md`` C): the ``"data"`` entries of the non-expert leaves are
dropped, so a serving rank holds its ``model`` block of them whole over
``data`` and gathers nothing. The expert leaves keep theirs (E over
``model``, d_ff over ``data``), because the ``token_gather`` plan is
defined by that layout.

Both layouts cut a ``model`` dimension by segments (``parts``): a
tuple of ``(size, cut)`` pairs, side by side along the dimension; a
segment with ``cut`` is cut into equal contiguous blocks, one per rank,
one without it is whole on every rank, and a rank holds its pieces side
by side. Most leaves are one segment, :data:`CONTIGUOUS`, whose size
``None`` spans the dimension; the ``data`` cut is always that. Where the
port departs from ``param_specs`` (``ROADMAP.md`` C):

  * Mamba1's ``in_proj`` (d, 2 di) holds x and z side by side: a
    contiguous cut over ``model`` would give rank 0 all of x and rank 1
    all of z, so each half is cut on its own and a rank holds [x_r |
    z_r];
  * Mamba2's ``in_proj`` (d, 2 di + 2N + nh) holds [z | x | B | C | dt]:
    a rank holds [z_r | x_r | B | C | dt_r], z_r and x_r the di / m
    channels of its nh / m heads, dt_r those heads' columns, B and C
    whole; ``conv_w`` (K, di + 2N) and ``conv_b`` take [x_r | B | C];
    ``dt_bias``, ``A_log`` and ``D`` (nh,) take the rank's heads, where
    the reference keeps them whole (``norm_scale`` and ``out_proj``'s
    rows are cut contiguously, as the reference cuts them).

The caches (:func:`cache_spec`) follow ``cache_specs`` with three
departures: the hybrid's conv states (B, K-1, di + 2N) take [x_r | B |
C], as ``conv_w`` does, and its ssm states (B, nh, p, N) the rank's
heads, where the reference cuts the conv states contiguously and keeps
the ssm states whole; under ``attn_shard="head_dim"`` the KV caches are
whole on every rank (each rank attends over every head,
``models/layers.py``), where the reference cuts head_dim. A KV head
count that does not divide by ``model`` raises under
``attn_shard="heads"`` (:func:`check_mesh`), where the reference would
cut head_dim; ``attn_shard="head_dim"`` takes such a config.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import gather_split

EXPERT_LEAVES = ("w1", "w3", "w2")
MAMBA2_HEAD_LEAVES = ("dt_bias", "A_log", "D")
ATTN_SHARDS = ("heads", "head_dim")
CONTIGUOUS = ((None, True),)  # one segment: the whole dimension, cut


def is_sharded(mesh) -> bool:
    """Whether ``mesh`` cuts anything: a mesh of more than one rank."""
    return mesh is not None and mesh.size > 1


def check_mesh(cfg: ArchConfig, data: int, model: int) -> None:
    """Refuse a (data, model) mesh the layouts cannot hold: ``ValueError``
    naming the count when H, KVH (under ``attn_shard="heads"``), H hd and
    KVH hd (under ``"head_dim"``), d_inner (Mamba1), the Mamba2 heads nh
    or E does not divide by ``model``, or naming an unknown
    ``attn_shard``. Any other leaf that does not divide raises in
    :func:`local_shape`, by name."""
    if cfg.attn_shard not in ATTN_SHARDS:
        raise ValueError(f"{cfg.name}: attn_shard = {cfg.attn_shard!r}, "
                         f"not one of {ATTN_SHARDS}")
    if model == 1:
        return
    hd = cfg.resolved_head_dim
    if cfg.attn_shard == "heads":
        counts = {"num_heads (H)": cfg.num_heads,
                  "num_kv_heads (KVH)": cfg.num_kv_heads}
    else:
        counts = {"num_heads * head_dim (H hd)": cfg.num_heads * hd,
                  "num_kv_heads * head_dim (KVH hd)": cfg.num_kv_heads * hd}
    counts["num_experts (E)"] = cfg.num_experts
    if cfg.family == "ssm":
        counts["d_inner"] = cfg.d_inner
    if cfg.family == "hybrid":
        counts["Mamba2 heads (nh)"] = cfg.d_inner // cfg.ssm_headdim
    for what, n in counts.items():
        if n and n % model:
            raise ValueError(f"{cfg.name}: {what} = {n} does not divide by "
                             f"the mesh's model = {model}")


def _spec_of(specs: dict, name: str):
    """The reference's spec of the parameter ``name`` (the port's dotted
    name, e.g. ``layers.3.attn.wq``) from the nested ``specs``
    (``param_specs``; a stacked layer leaf loses its leading L entry),
    with the path below the layer."""
    path = name.split(".")
    if path[0] == "layers":
        tree, rest, stacked = specs["layers"], path[2:], True
    elif path[0] == "shared":
        tree, rest, stacked = specs["shared"], path[1:], False
    else:
        tree, rest, stacked = specs, path, False
    for key in rest:
        tree = tree[key]
    return tuple(tree[1:] if stacked else tree), rest


def _layout(cfg: ArchConfig, rest, spec) -> tuple:
    """(spec, parts) of a leaf at path ``rest`` below its layer, from the
    reference's ``spec``: the segment cuts and Mamba2's head leaves of
    the module docstring."""
    if rest[:1] != ["mamba"]:
        return spec, CONTIGUOUS
    di, N = cfg.d_inner, cfg.ssm_state
    leaf = rest[-1]
    if cfg.family == "ssm":
        return spec, (((di, True), (di, True)) if leaf == "in_proj"
                      else CONTIGUOUS)
    if leaf == "in_proj":
        return spec, ((di, True), (di, True), (2 * N, False),
                      (di // cfg.ssm_headdim, True))
    if leaf in ("conv_w", "conv_b"):
        return spec, ((di, True), (2 * N, False))
    if leaf in MAMBA2_HEAD_LEAVES:
        return ("model",), CONTIGUOUS
    return spec, CONTIGUOUS


def is_expert(cfg: ArchConfig, name: str) -> bool:
    """Whether ``name`` is an expert leaf (w1/w3/w2 of an MoE layer),
    whose d_ff is cut over ``data`` in both layouts."""
    rest = name.split(".")
    return bool(cfg.num_experts) and "ffn" in rest \
        and rest[-1] in EXPERT_LEAVES


def training_spec(specs: dict, name: str, cfg: ArchConfig):
    """(spec, parts) of the parameter ``name`` in the training layout:
    the reference's ``param_specs`` entry whole, FSDP ``"data"`` entries
    included."""
    spec, rest = _spec_of(specs, name)
    return _layout(cfg, rest, spec)


def serving_spec(specs: dict, name: str, cfg: ArchConfig):
    """(spec, parts) of the parameter ``name`` in the serving layout: the
    training layout without the non-expert leaves' ``"data"`` entries."""
    spec, rest = _spec_of(specs, name)
    if not is_expert(cfg, name):
        spec = tuple(None if a == "data" else a for a in spec)
    return _layout(cfg, rest, spec)


def cache_spec(cfg: ArchConfig, name: str, spec) -> tuple:
    """(spec, parts) of the cache ``name`` (``conv``, ``ssm``, ``k``,
    ``v``, ``k_scale``, ``v_scale``) from the reference's ``cache_specs``
    entry ``spec``, with the module docstring's departures."""
    if cfg.family == "hybrid" and name == "conv":
        return spec, ((cfg.d_inner, True), (2 * cfg.ssm_state, False))
    if cfg.family == "hybrid" and name == "ssm":
        return spec[:2] + ("model", None, None), CONTIGUOUS
    if cfg.attn_shard == "head_dim" and name in ("k", "v", "k_scale",
                                                 "v_scale"):
        return tuple(None if a == "model" else a for a in spec), CONTIGUOUS
    return spec, CONTIGUOUS


def at_use(w: torch.Tensor, mesh) -> torch.Tensor:
    """The leaf ``w`` whole over ``data`` where it is used: a trainable
    model's FSDP block (a parameter marked with its ``fsdp_dim`` by
    ``Transformer``) gathered over ``data`` (its backward a
    reduce-scatter, :func:`~repro_torch.launch.mesh.gather_split`); any
    other leaf as it is."""
    dim = getattr(w, "fsdp_dim", None)
    if dim is None:
        return w
    return gather_split(w, mesh, "data", dim)


def _segments(size: int, axis: str, parts) -> list:
    """The (size, cut) segments along a dimension of ``size`` cut over
    ``axis``: ``parts`` over ``model``, :data:`CONTIGUOUS` over ``data``,
    a size of None spanning the dimension."""
    return [(size if n is None else n, cut)
            for n, cut in (parts if axis == "model" else CONTIGUOUS)]


def local_shape(shape, spec, mesh_shape: dict, parts=CONTIGUOUS,
                name: str = "leaf") -> tuple:
    """The block shape of a leaf of ``shape`` under ``spec`` on a mesh of
    ``mesh_shape`` ({"data": n, "model": m}); ``ValueError`` naming the
    leaf when a cut dimension does not divide (the ``model`` cut in each
    of its ``parts``, the module docstring's segments)."""
    out = list(shape)
    for dim, axis in enumerate(spec):
        n = mesh_shape[axis] if axis is not None else 1
        if n == 1:
            continue
        segs = _segments(out[dim], axis, parts)
        if sum(size for size, _ in segs) != out[dim] or any(
                cut and size % n for size, cut in segs):
            raise ValueError(
                f"{name}: dimension {dim} of {tuple(shape)} does not divide "
                f"by the mesh's {axis} = {n}" + (
                    f" in each of its parts {parts}" if len(segs) > 1
                    else ""))
        out[dim] = sum(size // n if cut else size for size, cut in segs)
    return tuple(out)


def _rank(mesh, axis: str) -> int:
    return mesh.data_rank if axis == "data" else mesh.model_rank


def local_block(leaf: torch.Tensor, spec, mesh, parts=CONTIGUOUS,
                name: str = "leaf") -> torch.Tensor:
    """This rank's block of the full ``leaf`` under ``spec``: each cut
    dimension narrowed to the rank's slice; with ``parts`` the ``model``
    dimension is segments side by side, each cut segment narrowed alike
    and each whole one kept, the rank's pieces side by side. A view where
    one piece does."""
    local_shape(leaf.shape, spec, mesh.shape, parts, name)
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n, r = mesh.shape[axis], _rank(mesh, axis)
        pieces, lo = [], 0
        for size, cut in _segments(leaf.shape[dim], axis, parts):
            b = size // n if cut else size
            pieces.append(leaf.narrow(dim, lo + (r * b if cut else 0), b))
            lo += size
        leaf = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
    return leaf


def gather_block(block: torch.Tensor, spec, mesh,
                 parts=CONTIGUOUS) -> torch.Tensor:
    """The full leaf from every rank's ``block`` (the inverse of
    :func:`local_block`), with the blocks' exact bits, on every rank: one
    :meth:`~repro_torch.launch.mesh.Mesh.gather` per cut dimension (a
    whole segment is taken from model rank 0's block). Every rank of the
    mesh must call it, in the same order."""
    for dim, axis in reversed(list(enumerate(spec))):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        full = mesh.gather(block, axis, dim)
        segs = _segments(full.shape[dim], axis, parts)
        if len(segs) > 1:
            # [a_0 w_0 | a_1 w_1 ...] -> [a_0 a_1 ... | w_0] (w whole)
            ranks = full.chunk(n, dim)
            sizes = [size // n if cut else size for size, cut in segs]
            pieces = [r.split(sizes, dim) for r in ranks]
            full = torch.cat([p for i, (_, cut) in enumerate(segs)
                              for p in ([r[i] for r in pieces] if cut
                                        else [pieces[0][i]])], dim)
        block = full
    return block


def batch_rows(x, mesh, batch_sharded: bool = True):
    """This rank's rows of a global batch ``x`` (leading axis B): its data
    shard's B / data rows when ``batch_sharded`` (``ValueError`` unless
    data divides B), else all of them."""
    if not batch_sharded or mesh is None or mesh.data == 1:
        return x
    B = x.shape[0]
    if B % mesh.data:
        raise ValueError(f"the batch of {B} rows does not divide by the "
                         f"mesh's data = {mesh.data}")
    b = B // mesh.data
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]
