"""Per-rank memory, FLOPs and traffic of a traced step.

:class:`MemTracker` is a ``TorchDispatchMode`` that watches every
operator a step runs, meant for the dry run (``launch/dryrun.py``) under
``FakeTensorMode``, where tensors have shapes and no data.

* Memory, always: the live storages on one device type. Each operator's
  outputs are looked at; a new storage (not an input's, as a view's or an
  in-place result's is) is counted once, and uncounted when it dies (a
  ``weakref.finalize`` on it). Each storage carries a category,
  ``"activations"`` until the caller :meth:`~MemTracker.tag` s it as one
  of :data:`CATEGORIES`' others (parameters, gradients, optimizer state,
  inputs and caches). The peak is found afterwards, from the allocation
  and free events, and split by the categories its storages had when
  last tagged; so a gradient tagged after the backward counts as a
  gradient at a peak inside it.
* Counts, inside :meth:`~MemTracker.counting`: the FLOPs, by
  ``torch.utils.flop_counter`` 's formulas (the ones ``FlopCounterMode``
  adds up, the port's operators' included); the device-memory bytes each
  operator must move, its tensor inputs read once and its outputs written
  once (a gather reads only what it selects; views, factories that write
  nothing and collectives move none here: the collectives are the mesh's
  to count); and the calls of the port's own operators
  (``kernels/_ops.py``), whose bytes come from their own counts
  (:data:`~repro_torch.kernels._ops.HBM_BYTES`). Eager PyTorch fuses
  nothing, so the bytes are the traffic of the step as it runs, each
  operator's operands making a round trip through device memory.

One mode does all of it: a trace runs millions of operators (on the
CPU's paths a Mamba1 layer's backward is a loop over time), and each
mode on the stack costs each of them a dispatch. A small tracker of its own, not
``torch.distributed._tools.mem_tracker``: that API is private, differs
between torch releases and refuses to track a second iteration.
"""
from __future__ import annotations

import contextlib
import weakref
from array import array
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _ops

CATEGORIES = ("parameters", "gradients", "optimizer_state", "inputs",
              "activations")
# operators that read or write no element of device memory
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "_local_scalar_dense", "set_"}
# gathers: their indices and outputs, and the elements they select
_GATHERS = {"embedding", "index_select", "index", "gather"}


def _tensors(tree, out=None) -> list:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


class MemTracker(TorchDispatchMode):
    """Live storages on devices of type ``device_type`` while active, by
    category; FLOPs, HBM bytes and the port's operators' calls inside
    :meth:`counting`. A storage made before the mode was entered (or on
    another device) is not counted unless :meth:`tag` is handed a tensor
    on it."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = torch.device(device_type).type
        # a trace can see millions of storages: one record each, in arrays
        self._live: dict[int, int] = {}  # id(storage) -> record
        self._bytes = array("q")  # record -> bytes
        self._cats = bytearray()  # record -> index into CATEGORIES
        self._events = array("q")  # +(i + 1) allocated, -(i + 1) freed
        self._counting = False
        self.flops = 0
        self.hbm_bytes = 0
        self.calls: Counter = Counter()

    # ------------------------------------------------------------- memory
    def _see(self, t: torch.Tensor, category: str = "activations") -> int:
        if t.device.type != self.device_type:
            return -1
        st = t.untyped_storage()
        key = id(st)
        i = self._live.get(key)
        if i is None:
            i = len(self._bytes)
            self._bytes.append(st.nbytes())
            self._cats.append(CATEGORIES.index(category))
            self._live[key] = i
            self._events.append(i + 1)
            weakref.finalize(st, self._free, key, i)
        return i

    def _free(self, key: int, i: int) -> None:
        if self._live.get(key) == i:
            del self._live[key]
        self._events.append(-(i + 1))

    def tag(self, tensors, category: str) -> None:
        """Count the storages of ``tensors`` (a tensor, or tuples, lists
        and dicts of them) as ``category``, from now and at any peak they
        were live at."""
        if category not in CATEGORIES:
            raise ValueError(f"category {category!r} not in {CATEGORIES}")
        for t in _tensors(tensors):
            i = self._see(t, category)
            if i >= 0:
                self._cats[i] = CATEGORIES.index(category)

    def live_bytes(self) -> dict[str, int]:
        """{category: bytes} of the storages live now."""
        return self._by_category(self._live.values())

    def _by_category(self, records) -> dict[str, int]:
        out = dict.fromkeys(CATEGORIES, 0)
        for i in records:
            out[CATEGORIES[self._cats[i]]] += self._bytes[i]
        return out

    def peak(self) -> dict:
        """``{"peak_bytes": b, "by_category": {category: bytes}}`` at the
        moment the live bytes were highest (the first such moment)."""
        live = best = 0
        at = -1
        nbytes = self._bytes
        for n, ev in enumerate(self._events):
            live += nbytes[ev - 1] if ev > 0 else -nbytes[-ev - 1]
            if live > best:
                best, at = live, n
        alive: set[int] = set()
        for ev in self._events[:at + 1]:
            if ev > 0:
                alive.add(ev - 1)
            else:
                alive.discard(-ev - 1)
        return {"peak_bytes": best, "by_category": self._by_category(alive)}

    # ------------------------------------------------------------- counts
    @contextlib.contextmanager
    def counting(self):
        """Count FLOPs, HBM bytes and calls of the operators run inside."""
        self._counting = True
        try:
            yield self
        finally:
            self._counting = False

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        name = packet.__name__
        if func.namespace == _ops.NAMESPACE:
            self.calls[name] += 1
            self.hbm_bytes += _ops.HBM_BYTES[name](*args, **kwargs)
        elif func.namespace == "aten" and not func.is_view \
                and name not in _FREE:
            if name in _GATHERS:  # the source's selected elements
                ins = [t for t in ins if t is not args[0]] + outs
            self.hbm_bytes += _ops.nbytes(*{id(t): t for t in ins}.values(),
                                          *{id(t): t for t in outs}.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = None
        if not func.is_view:  # a view lies on its input's storage
            if func._schema.is_mutable:  # an in-place result likewise
                ins = _tensors((args, kwargs))
                given = {id(t.untyped_storage()) for t in ins}
                new = [t for t in outs
                       if id(t.untyped_storage()) not in given]
            else:
                new = outs
            for t in new:
                self._see(t)
        if self._counting:
            self._count(func, args, kwargs,
                        _tensors((args, kwargs)) if ins is None else ins,
                        outs, out)
        return out
