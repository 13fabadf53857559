"""(data, model) meshes on ``torch.distributed``: the paper's workers and
parameter servers.

The port's counterpart of ``repro/launch/mesh.py``. A :class:`Mesh` names
the ranks of an initialised process group as a (data, model) grid in the
row-major order of the reference's ``jax.make_mesh((data, model), ("data",
"model"))``: rank = data_rank * model + model_rank. Each rank holds

  * one id range of Theta's rows (its ``model_rank``: a parameter server),
  * one block of sessions and samples (its ``data_rank``: a worker),

and the mesh owns the two families of subgroups the sharded path reduces
over: the ``model`` group of a rank (the ranks of its data block, which
together hold all of Theta) and its ``data`` group (the ranks holding the
same id range). A 1 x 1 mesh is the single-device path: every reduction is
the identity and no process group is needed.

Collectives. The backend is chosen by where the ranks run, never by a
flag: **NCCL when every rank has a card of its own, gloo otherwise** (ranks
on the CPU, or several ranks sharing one card; gloo all-reduces CUDA
tensors by staging them through the host). Tensors and kernels stay on
each rank's device either way. The mesh counts what it issues: the number
of all-reduces, their bytes and the host time spent in them, per group
(:meth:`Mesh.collective_counts`). Besides the in-place sum, the LM's
tensor and expert parallelism uses two built on it: :meth:`Mesh.sum_fp32`,
a bf16 partial summed in fp32 and rounded once, and :meth:`Mesh.gather`,
an exact all-gather of any dtype's bits along any dimension. Training
differentiates through them: :func:`copy_to` (the identity, its backward
a sum), :func:`sum_fp32` (its backward the identity),
:func:`gather_replicated` (its backward a slice), :func:`gather_split`
(its backward a reduce-scatter) and :func:`split_to` (a slice, its
backward a gather: sequence parallelism's scatter) are
``autograd.Function`` s whose forwards are those calls' own bits.

The roofline's hardware constants (``utils/roofline.py``) sit here under
the reference's names, for the card the port runs on.

Process start. :func:`run_ranks` starts ``data * model`` ranks with the
*spawn* start method (a card forbids fork after CUDA is initialised) and a
``FileStore`` rendezvous in a temporary directory, so concurrent runs
never contend for a TCP port; under ``torchrun`` a driver joins the world
it is given instead (:func:`init_from_env`).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

AXES = ("data", "model")

# NVIDIA H100 80GB HBM3, 700 W (SXM): dense bf16 on the tensor cores,
# fp32 accumulate, FLOP/s
PEAK_FLOPS_BF16 = 989e12
# NVIDIA H100 80GB HBM3, 700 W (SXM): device memory, bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700 W (SXM): NVLink 4, 18 links of 25 GB/s, bytes/s
# a direction (the reference's ICI_BW)
LINK_BW = 18 * 25e9


class Mesh:
    """A (data, model) grid over the current process group (or over one
    process when ``data == model == 1``)."""

    axis_names = AXES
    data_axes = ("data",)  # the axes that split the batch (no 'pod' axis)

    def __init__(self, data: int = 1, model: int = 1):
        data, model = int(data), int(model)
        if data < 1 or model < 1:
            raise ValueError(f"mesh extents must be >= 1, got ({data}, "
                             f"{model})")
        self.data, self.model = data, model
        world = data * model
        self._groups: dict[str, object] = {"data": None, "model": None}
        if world == 1:
            self.rank, self.backend = 0, None
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a ({data}, {model}) mesh needs an initialised process "
                    "group (run_ranks or torchrun)")
            if dist.get_world_size() != world:
                raise ValueError(
                    f"mesh ({data}, {model}) needs {world} ranks, the world "
                    f"has {dist.get_world_size()}")
            self.rank, self.backend = dist.get_rank(), dist.get_backend()
            # every rank creates every group, in one order
            b, j = divmod(self.rank, model)
            if model > 1:
                for row in range(data):
                    g = dist.new_group([row * model + c for c in range(model)])
                    if row == b:
                        self._groups["model"] = g
            if data > 1:
                for col in range(model):
                    g = dist.new_group([r * model + col for r in range(data)])
                    if col == j:
                        self._groups["data"] = g
        self.data_rank, self.model_rank = divmod(self.rank, model)
        self.reset_counts()

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}"
                f", backend={self.backend})")

    # ----------------------------------------------------------- collectives
    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over ``axis`` ("data" or "model"); the
        identity on an axis of extent 1. Returns ``t``."""
        if self.shape[axis] == 1:
            return t
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self._groups[axis])
        c = self._counts[axis]
        c[0] += 1
        c[1] += t.numel() * t.element_size()
        c[2] += time.perf_counter() - t0
        return t

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` as a new tensor (``t`` itself on
        an axis of extent 1)."""
        if self.shape[axis] == 1:
            return t
        return self.all_reduce_(t.clone(), axis)

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """A rank-local partial of a sum over Theta's rows -> the global
        sum (the optimizer's reductions)."""
        return self.sum(t, "model")

    def sum_fp32(self, t: torch.Tensor, *axes: str) -> torch.Tensor:
        """The row-parallel sum: the partial ``t`` widened to fp32, summed
        over each of ``axes`` in turn and rounded back to ``t``'s dtype
        once (a new tensor; ``t`` itself when every axis has extent 1)."""
        axes = [a for a in axes if self.shape[a] > 1]
        if not axes:
            return t
        acc = t.to(torch.float32)
        if acc is t:
            acc = acc.clone()
        for axis in axes:
            self.all_reduce_(acc, axis)
        return acc.to(t.dtype)

    def gather(self, block: torch.Tensor, axis: str,
               dim: int = 0) -> torch.Tensor:
        """Every ``axis`` rank's equal block, concatenated along ``dim`` in
        rank order, with the blocks' exact bits, whatever their dtype.
        Built as one all-reduce of the blocks' bit patterns, viewed as
        int32 words (bf16 pairs, or a zero pad byte at the end), into a
        zero buffer (gloo has no all-gather of CUDA tensors)."""
        n = self.shape[axis]
        if n == 1:
            return block
        block = block.contiguous()
        raw = block.reshape(-1).view(torch.uint8)
        words = -(-raw.numel() // 4)
        full = torch.zeros((n, words), dtype=torch.int32, device=block.device)
        mine = full[self.data_rank if axis == "data" else self.model_rank]
        mine.view(torch.uint8)[:raw.numel()] = raw
        self.all_reduce_(full, axis)
        parts = full.view(torch.uint8)[:, :raw.numel()].contiguous().view(
            block.dtype).reshape((n,) + tuple(block.shape))
        return torch.cat(parts.unbind(0), dim=dim)

    def gather_rows(self, block: torch.Tensor) -> torch.Tensor:
        """Every model rank's equal row block, concatenated in rank order
        (the padded layout), with the blocks' exact bits
        (:meth:`gather` over ``model`` on dim 0)."""
        return self.gather(block, "model", 0)

    def split_counts(self) -> dict[str, dict[str, int]]:
        """``{"gather": {"calls": n, "bytes": b}, "reduce_scatter": ...}``
        of :func:`gather_split` so far (FSDP's weight gathers and the
        experts' d_ff gathers, and their backwards): the bytes of the
        all-reduced buffers (a gather's int32 words of every rank's
        block, a reduce-scatter's fp32 whole). They are part of
        :meth:`collective_counts`' ``data`` numbers."""
        return {k: {"calls": c[0], "bytes": c[1]}
                for k, c in self._split.items()}

    def collective_counts(self) -> dict[str, dict[str, float]]:
        """``{axis: {"all_reduce": n, "bytes": b, "seconds": s}}`` issued
        so far; ``s`` is the host's wall time inside the calls (the wait
        for the slowest rank of the group and gloo's staging through the
        host included)."""
        return {a: {"all_reduce": c[0], "bytes": c[1], "seconds": c[2]}
                for a, c in self._counts.items()}

    def reset_counts(self) -> None:
        self._counts = {a: [0, 0, 0.0] for a in AXES}
        self._split = {"gather": [0, 0], "reduce_scatter": [0, 0]}

    def _tally(self, kind: str, nbytes: int) -> None:
        self._split[kind][0] += 1
        self._split[kind][1] += nbytes


# The differentiable collectives of the LM's tensor, expert and FSDP
# parallelism. Each forward is the non-differentiable call's own bits
# (serving runs them too); each backward depends on whether what follows
# is the same on every rank of the axis, hence one Function per case.
class _CopyTo(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over ``axis`` in
    fp32 (rounded once to its dtype): in front of a column-parallel
    input, each rank's branch gives only its share of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum_fp32(g.contiguous(), ctx.axis), None, None


def copy_to(x: torch.Tensor, mesh: Mesh | None, axis: str) -> torch.Tensor:
    """``x`` itself, entering a region split over ``axis``: the backward
    sums the ranks' cotangents (identity without a mesh or on an axis of
    extent 1)."""
    if mesh is None or mesh.shape[axis] == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


class _SumFp32(torch.autograd.Function):
    """:meth:`Mesh.sum_fp32` (the row-parallel sum, and the sharded
    LS-PLM steps' sums of fp32 partials), whose backward passes the
    cotangent through: what follows is replicated over the axes."""

    @staticmethod
    def forward(ctx, x, mesh, *axes):
        ctx.axes = len(axes)
        return mesh.sum_fp32(x, *axes)

    @staticmethod
    def backward(ctx, g):
        return (g, None) + (None,) * ctx.axes


def sum_fp32(x: torch.Tensor, mesh: Mesh | None, *axes: str) -> torch.Tensor:
    """Differentiable :meth:`Mesh.sum_fp32` over ``axes`` (``x`` itself
    without a mesh or where every axis has extent 1)."""
    if mesh is None or all(mesh.shape[a] == 1 for a in axes):
        return x
    return _SumFp32.apply(x, mesh, *axes)


def _block_of(g: torch.Tensor, mesh: Mesh, axis: str,
              dim: int) -> torch.Tensor:
    r = mesh.data_rank if axis == "data" else mesh.model_rank
    return g.chunk(mesh.shape[axis], dim)[r].contiguous()


class _GatherReplicated(torch.autograd.Function):
    """:meth:`Mesh.gather` into a result that everything downstream uses
    alike on every rank of ``axis``: each rank's cotangent of the whole is
    already the gradient, so the backward slices this rank's block (a
    sum would scale it by the axis' extent)."""

    @staticmethod
    def forward(ctx, block, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.gather(block, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block_of(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherSplit(torch.autograd.Function):
    """:meth:`Mesh.gather` into a result that the ranks of ``axis`` use
    on different data (FSDP's weight gather over ``data``): the backward
    is a reduce-scatter, built as an fp32 all-reduce of the cotangents
    followed by this rank's block (gloo has no reduce-scatter of CUDA
    tensors), rounded once to the block's dtype."""

    @staticmethod
    def forward(ctx, block, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.dtype = block.dtype
        words = -(-block.numel() * block.element_size() // 4)
        mesh._tally("gather", 4 * words * mesh.shape[axis])
        return mesh.gather(block, axis, dim)

    @staticmethod
    def backward(ctx, g):
        total = ctx.mesh.all_reduce_(g.to(torch.float32, copy=True)
                                     .contiguous(), ctx.axis)
        ctx.mesh._tally("reduce_scatter", total.numel() * 4)
        return (_block_of(total, ctx.mesh, ctx.axis, ctx.dim).to(ctx.dtype),
                None, None, None)


class _SplitTo(torch.autograd.Function):
    """This rank's block of ``x`` (the same on every rank of ``axis``)
    along ``dim``, entering a region where each rank holds its own block:
    the backward gathers the ranks' cotangent blocks exactly, so the
    whole is the cotangent of ``x`` on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block_of(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.gather(g.contiguous(), ctx.axis, ctx.dim), None,
                None, None)


def split_to(x: torch.Tensor, mesh: Mesh | None, axis: str,
             dim: int) -> torch.Tensor:
    """Differentiable slice of this rank's block of ``x`` along ``dim``
    over ``axis`` (``x`` itself without a mesh or on an axis of extent
    1); ``ValueError`` when the dimension does not divide. The backward
    is an exact gather."""
    if mesh is None or mesh.shape[axis] == 1:
        return x
    if x.shape[dim] % mesh.shape[axis]:
        raise ValueError(f"split_to: dimension {dim} of {tuple(x.shape)} "
                         f"does not divide by the mesh's {axis} = "
                         f"{mesh.shape[axis]}")
    return _SplitTo.apply(x, mesh, axis, dim % x.dim())


def gather_replicated(block: torch.Tensor, mesh: Mesh | None, axis: str,
                      dim: int) -> torch.Tensor:
    """Differentiable :meth:`Mesh.gather` whose result is used alike on
    every rank of ``axis`` (the LM head's vocab blocks over ``model``):
    the backward keeps this rank's block of the cotangent."""
    if mesh is None or mesh.shape[axis] == 1:
        return block
    return _GatherReplicated.apply(block, mesh, axis, dim % block.dim())


def gather_split(block: torch.Tensor, mesh: Mesh | None, axis: str,
                 dim: int) -> torch.Tensor:
    """Differentiable :meth:`Mesh.gather` whose result the ranks of
    ``axis`` apply to different data (FSDP's weights over ``data``, the
    experts' d_ff halves): the backward sums the cotangents over ``axis``
    and keeps this rank's block (a reduce-scatter)."""
    if mesh is None or mesh.shape[axis] == 1:
        return block
    return _GatherSplit.apply(block, mesh, axis, dim % block.dim())


def make_debug_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A (data, model) mesh over the initialised process group (its world
    must be ``data * model``); 1 x 1 needs none."""
    return Mesh(data, model)


# ----------------------------------------------------------- process start
def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of ``rank``: card ``rank % cards`` on CUDA (ranks share
    the cards round-robin), else the CPU."""
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def backend_for(device: torch.device, world: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_from_env(device: torch.device) -> tuple[int, int, torch.device]:
    """Join a world started by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment): returns ``(rank,
    world, this rank's device)``. The device is ``LOCAL_RANK``'s card."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        local_cards = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dist.init_process_group(backend_for(device, local_cards),
                                rank=rank, world_size=world)
    return rank, world, dev


def _rank_entry(rank: int, fn: Callable, world: int, store_path: str,
                device: str, out_dir: str, timeout_s: float,
                args: tuple) -> None:
    dev = rank_device(torch.device(device), rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend_for(torch.device(device), world), store=store, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, device="cpu",
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, rank_device, *args)`` on ``world`` spawned ranks of one
    process group (backend by :func:`backend_for`) and return their return
    values in rank order. ``fn`` must be importable by name (a module-level
    function) and its arguments and results picklable; a rank that raises
    ends every rank and raises here, and a collective that waits longer
    than ``timeout_s`` raises in its rank."""
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as td:
        torch.multiprocessing.start_processes(
            _rank_entry, nprocs=world, join=True, start_method="spawn",
            args=(fn, world, os.path.join(td, "store"), str(device), td,
                  float(timeout_s), args))
        out = []
        for r in range(world):
            with open(os.path.join(td, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
