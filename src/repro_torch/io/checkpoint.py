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


# --------------------------------------------------------- stream state
# the reference's streaming checkpoint: its OWLQNState's pytree leaves
# (the L-BFGS history rolled oldest -> newest, zero slots in front) and
# the day cursor
STREAM_KEYS = ("opt/theta", "opt/history/s", "opt/history/y",
               "opt/history/rho", "opt/history/valid", "opt/history/gamma",
               "opt/prev_theta", "opt/prev_d", "opt/step", "opt/f", "day")


def save_stream(path: str, stream_state) -> str:
    """Checkpoint a streaming trainer state (Theta + OWLQN+ history + day
    cursor) in the reference's key layout (:data:`STREAM_KEYS`). The
    port's ring-buffer history is unrolled into the reference's order:
    the M slots oldest to newest, unfilled slots zero and invalid in
    front. A file written here resumes in the reference's
    ``StreamTrainer.load`` and the other way round. Returns the real path
    written."""
    opt = stream_state.opt
    h = opt.history
    m = h.memory
    slots = list(reversed(h.newest_first()))  # oldest -> newest
    lead = m - len(slots)
    s, y, rho = (np.zeros_like(_leaf(a)) for a in (h.s, h.y, h.rho))
    valid = np.zeros(m, bool)
    if slots:
        idx = torch.tensor(slots, device=h.s.device)
        s[lead:] = _leaf(h.s.index_select(0, idx))
        y[lead:] = _leaf(h.y.index_select(0, idx))
        rho[lead:] = _leaf(h.rho)[slots]
        valid[lead:] = [h.valid[i] for i in slots]
    tree = {"opt": {"theta": opt.theta,
                    "history": {"s": s, "y": y, "rho": rho, "valid": valid,
                                "gamma": h.gamma},
                    "prev_theta": opt.prev_theta, "prev_d": opt.prev_d,
                    "step": np.asarray(opt.step, np.int32),
                    "f": np.asarray(opt.f, np.float32)},
            "day": np.asarray(int(stream_state.day), np.int64)}
    return save(path, tree)


def load_stream(path: str, like):
    """Restore a streaming trainer state saved by either package's
    ``save_stream`` into the structure of ``like`` (e.g.
    ``StreamTrainer.init(theta0)``): tensors on ``like``'s device and
    dtype, the day cursor a python int. The history comes back as a full
    ring whose slots hold the file's pairs oldest to newest, so the next
    push replaces the oldest, as the reference's roll does. A shape that
    differs from ``like``'s raises: the file was saved under another
    configuration."""
    from repro_torch.optim.lbfgs import LBFGSHistory

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    missing = [k for k in STREAM_KEYS if k not in flat]
    if missing:
        raise KeyError(f"checkpoint {path!r} is not a stream state: "
                       f"missing {missing}")
    opt = like.opt
    want = {"opt/theta": tuple(opt.theta.shape),
            "opt/prev_theta": tuple(opt.theta.shape),
            "opt/prev_d": tuple(opt.theta.shape),
            "opt/history/s": tuple(opt.history.s.shape),
            "opt/history/y": tuple(opt.history.y.shape),
            "opt/history/rho": (opt.history.memory,),
            "opt/history/valid": (opt.history.memory,)}
    for key, shape in want.items():
        if tuple(flat[key].shape) != shape:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(flat[key].shape)}, "
                f"expected {shape}: the checkpoint was saved under a "
                f"different configuration")

    def tensor(key):
        return torch.from_numpy(np.array(flat[key], order="C")).to(
            device=opt.theta.device, dtype=opt.theta.dtype)

    m = opt.history.memory
    history = LBFGSHistory(
        s=tensor("opt/history/s"), y=tensor("opt/history/y"),
        rho=tensor("opt/history/rho"), gamma=tensor("opt/history/gamma"),
        valid=[bool(v) for v in flat["opt/history/valid"]], newest=m - 1)
    new_opt = type(opt)(theta=tensor("opt/theta"), history=history,
                        prev_theta=tensor("opt/prev_theta"),
                        prev_d=tensor("opt/prev_d"),
                        step=int(flat["opt/step"]), f=float(flat["opt/f"]))
    return type(like)(opt=new_opt, day=int(flat["day"]))
