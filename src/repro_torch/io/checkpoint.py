"""Flat-npz checkpoints, in the reference's key layout.

A nested tree (dicts, lists/tuples, NamedTuples) of tensors, numpy arrays
and python scalars is flattened to ``a/b/c`` keys and written with
``np.savez`` -- the same layout as ``repro.io.checkpoint``, so a file
written by either package loads in the other. Tensors are copied to the
host first. :func:`load` restores into the structure of a ``like`` tree,
:func:`load_nested` rebuilds a nested dict from the keys alone.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = _leaf(tree)
    return out


def save(path: str, tree) -> str:
    """Write the flattened tree; returns the REAL path written
    (``np.savez`` appends ``.npz`` to paths not already ending in it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))
    return path if path.endswith(".npz") else path + ".npz"


def load(path: str, like):
    """Restore into the structure of ``like`` (dicts, lists/tuples,
    NamedTuples). A tensor leaf of ``like`` comes back as a tensor of its
    dtype on its device, a python scalar as the same python type, any
    other leaf as a numpy array. A leaf whose shape differs from ``like``'s
    raises: the file was saved under another configuration."""
    with np.load(path) as data:
        flat = dict(data.items())

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(rebuild(getattr(tree, k), f"{prefix}{k}/")
                                for k in tree._fields))
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        key = prefix.rstrip("/")
        if key not in flat:
            raise KeyError(f"checkpoint {path!r} has no leaf {key!r}")
        leaf = flat[key]
        if isinstance(tree, (bool, int, float)):
            return type(tree)(leaf.item())
        want = getattr(tree, "shape", None)
        if want is not None and tuple(leaf.shape) != tuple(want):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(leaf.shape)}, "
                f"expected {tuple(want)}: the checkpoint was saved under a "
                f"different configuration")
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(leaf).to(device=tree.device,
                                             dtype=tree.dtype)
        return leaf

    return rebuild(like)


def load_nested(path: str) -> dict:
    """Restore a checkpoint without a ``like`` tree: the flat keys split on
    ``/`` back into a nested dict of numpy leaves (list/NamedTuple
    positions come back as dict keys). Self-describing files -- serving
    artifacts, ``{"theta": ...}`` checkpoints -- need nothing more."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node, parts = out, key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return out
