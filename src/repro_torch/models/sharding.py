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
(:func:`serving_spec`) is ``param_specs`` with two departures
(``ROADMAP.md`` C):

  * the ``"data"`` entries of the non-expert leaves are dropped, so a
    serving rank holds its ``model`` block of them whole over ``data``
    and gathers nothing. The expert leaves keep theirs (E over
    ``model``, d_ff over ``data``), because the ``token_gather`` plan is
    defined by that layout;
  * a KV head count that does not divide by ``model`` raises
    (:func:`check_mesh`), where the reference would cut head_dim. Both
    layouts keep this one.

Mamba1's ``in_proj`` (d, 2 di) holds x and z side by side: a contiguous
cut over ``model`` would give rank 0 all of x and rank 1 all of z, so
each half is cut on its own (``parts=2``) and a rank holds [x_r | z_r].
``parts`` applies to the ``model`` cut only (the ``data`` cut of d is
contiguous).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import gather_split

A12E = ("ROADMAP.md A12e (zamba2's Mamba2 split over 'model', "
        "attn_shard='head_dim' and seq_parallel)")
EXPERT_LEAVES = ("w1", "w3", "w2")


def is_sharded(mesh) -> bool:
    """Whether ``mesh`` cuts anything: a mesh of more than one rank."""
    return mesh is not None and mesh.size > 1


def check_mesh(cfg: ArchConfig, data: int, model: int) -> None:
    """Refuse a (data, model) mesh the layouts cannot hold:
    ``NotImplementedError`` for what waits for A12e with ``model`` > 1
    (the hybrid's Mamba2, ``attn_shard="head_dim"``, ``seq_parallel``),
    ``ValueError`` naming the count when H, KVH, d_inner or E does not
    divide by ``model``. Any other leaf that does not divide raises in
    :func:`local_shape`, by name."""
    if model == 1:
        return
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the Mamba2 layers are not split over 'model' yet "
            f"(use a data-only mesh, model = 1); see {A12E}")
    if cfg.attn_shard != "heads" or cfg.seq_parallel:
        raise NotImplementedError(
            f"{cfg.name}: attn_shard={cfg.attn_shard!r}, seq_parallel="
            f"{cfg.seq_parallel} on a mesh with model = {model}; see {A12E}")
    counts = {"num_heads (H)": cfg.num_heads,
              "num_kv_heads (KVH)": cfg.num_kv_heads,
              "num_experts (E)": cfg.num_experts}
    if cfg.family == "ssm":
        counts["d_inner"] = cfg.d_inner
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


def _parts(cfg: ArchConfig, rest) -> int:
    return 2 if cfg.family == "ssm" and rest == ["mamba", "in_proj"] else 1


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
    return spec, _parts(cfg, rest)


def serving_spec(specs: dict, name: str, cfg: ArchConfig):
    """(spec, parts) of the parameter ``name`` in the serving layout: the
    training layout without the non-expert leaves' ``"data"`` entries."""
    spec, rest = _spec_of(specs, name)
    if not is_expert(cfg, name):
        spec = tuple(None if a == "data" else a for a in spec)
    return spec, _parts(cfg, rest)


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


def local_shape(shape, spec, mesh_shape: dict, parts: int = 1,
                name: str = "leaf") -> tuple:
    """The block shape of a leaf of ``shape`` under ``spec`` on a mesh of
    ``mesh_shape`` ({"data": n, "model": m}); ``ValueError`` naming the
    leaf when a cut dimension does not divide (the ``model`` cut in each
    of its ``parts``)."""
    out = list(shape)
    for dim, axis in enumerate(spec):
        n = mesh_shape[axis] if axis is not None else 1
        if n == 1:
            continue
        parts_here = parts if axis == "model" else 1
        if out[dim] % (n * parts_here):
            raise ValueError(f"{name}: dimension {dim} of {tuple(shape)} "
                             f"does not divide by the mesh's {axis} = {n}"
                             + (f" in each of its {parts} parts"
                                if parts_here > 1 else ""))
        out[dim] //= n
    return tuple(out)


def _rank(mesh, axis: str) -> int:
    return mesh.data_rank if axis == "data" else mesh.model_rank


def local_block(leaf: torch.Tensor, spec, mesh, parts: int = 1,
                name: str = "leaf") -> torch.Tensor:
    """This rank's block of the full ``leaf`` under ``spec``: each cut
    dimension narrowed to the rank's slice; with ``parts`` > 1 the
    ``model`` dimension is ``parts`` equal segments side by side, each cut
    alike and the rank's pieces kept side by side. A view where one piece
    does."""
    local_shape(leaf.shape, spec, mesh.shape, parts, name)
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n_parts = parts if axis == "model" else 1
        seg = leaf.shape[dim] // n_parts
        b = seg // mesh.shape[axis]
        lo = _rank(mesh, axis) * b
        pieces = [leaf.narrow(dim, p * seg + lo, b) for p in range(n_parts)]
        leaf = pieces[0] if n_parts == 1 else torch.cat(pieces, dim)
    return leaf


def gather_block(block: torch.Tensor, spec, mesh,
                 parts: int = 1) -> torch.Tensor:
    """The full leaf from every rank's ``block`` (the inverse of
    :func:`local_block`), with the blocks' exact bits, on every rank: one
    :meth:`~repro_torch.launch.mesh.Mesh.gather` per cut dimension. Every
    rank of the mesh must call it, in the same order."""
    for dim, axis in reversed(list(enumerate(spec))):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        full = mesh.gather(block, axis, dim)
        if parts > 1 and axis == "model":
            # [x_0 z_0 | x_1 z_1 ...] -> [x_0 x_1 ... | z_0 z_1 ...]
            ranks = [r.chunk(parts, dim) for r in full.chunk(n, dim)]
            full = torch.cat([r[p] for p in range(parts) for r in ranks],
                             dim)
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
