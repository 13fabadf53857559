"""Flat-npz checkpoints, in the reference's key layout.

A nested tree (dicts, lists/tuples, NamedTuples) of tensors, numpy arrays
and python scalars is flattened to ``a/b/c`` keys and written with
``np.savez`` -- the same layout as ``repro.io.checkpoint``, so a file
written by either package loads in the other. Tensors are copied to the
host first.
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
