"""Streaming day-by-day OWLQN+: minibatch windows with warm starts.

The port's counterpart of ``repro/stream/trainer.py``. The paper's
optimizer is full-batch: one batch, hundreds of iterations. Production
retrains as days arrive. :class:`StreamTrainer` runs that cadence over a
:class:`~repro_torch.stream.source.DayStream`: for each day t it takes the
sliding window of the last W days, re-plans it on the host and copies it
to the device (overlapped with the previous window's device steps by
:class:`~repro_torch.stream.planner.WindowPlanner`), and runs a bounded
number of OWLQN+ inner iterations warm-started from the previous
window's Theta. On a CUDA device every loss evaluation runs the fused
sparse forward (B1), every gradient the run-length scatter (B2) on the
window's plans, and every step the Eq. 9 direction (B3).

Reset-vs-carry policy (``history=``): Theta ALWAYS carries across windows.
The L-BFGS history approximates the curvature of the PREVIOUS window's
objective, which changes when the window slides:

  * ``"reset"`` (default): drop the history (and prev_theta/prev_d) at
    every window boundary. The first inner iteration of each window is
    then a pure Eq. 9 direction step, and a window that never changes
    reproduces the full-batch trajectory exactly.
  * ``"carry"``: keep the history across the boundary; OWLQN+'s PD
    safeguard (pairs with y.s <= 0 are masked) drops inconsistent pairs.
    The port's history is updated in place, so :meth:`StreamTrainer.run`
    copies it once at the start of a carry run: the state it is handed
    is never changed, and running twice from one state gives one result.

Exact zeros cross window boundaries untouched: the warm start keeps
Theta's bits and OWLQN+'s orthant algebra is sign-exact.

With a mesh (``mesh=``, a ``repro_torch.launch.mesh.Mesh``) every window
runs the paper's worker/server split: the planner routes the window and
slices its plans per (data block, id range) and keeps this rank's cell,
the loss is ``shard.step``'s and OWLQN+ reduces over the mesh. The
id-range partition is FIXED across windows (equal ranges by default), so
a rank's rows never move at a boundary. :meth:`StreamTrainer.theta`,
:meth:`~StreamTrainer.save` and :meth:`~StreamTrainer.load` see the
global unpadded Theta; the first two are collectives (every rank calls
them), and rank 0 alone writes the file.

Departures from the reference: ``jit_ahead`` and ``mode`` steer XLA's
compilation, which the port does not have, so they are gone. A window's
``step_seconds`` is its wall time up to a ``torch.cuda.synchronize``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.objective import nll_sparse, smooth_loss_and_grad
from repro_torch.device import resolve_device
from repro_torch.optim import lbfgs
from repro_torch.optim.owlqn_plus import OWLQNPlus, OWLQNState
from repro_torch.shard.partition import make_partition
from repro_torch.shard.step import make_sharded_sparse_loss
from repro_torch.stream.planner import (
    PlannerStats,
    PreparedWindow,
    WindowPlanner,
    plan_window,
    to_device,
)
from repro_torch.stream.source import DayStream


class StreamState(NamedTuple):
    """Checkpointable streaming-trainer state: the optimizer state (Theta
    + L-BFGS history + step counter) and the day cursor (the NEXT day to
    consume). Round-trips exactly through ``io.checkpoint.save_stream``
    / ``load_stream``, in the reference's key layout."""

    opt: OWLQNState
    day: int = 0


class WindowStats(NamedTuple):
    day: int                  # window end day
    days_in_window: int
    fs: tuple                 # objective after each inner iteration
    alpha: float              # last accepted step size
    nnz: int                  # non-zeros after the window
    step_seconds: float       # wall of the inner iterations, synchronised
    build_seconds: float      # host time to slide, plan and copy the window


def _no_loss(_theta):
    raise RuntimeError("template optimizer has no loss bound; "
                       "windows bind their own")


def copy_history(h: lbfgs.LBFGSHistory) -> lbfgs.LBFGSHistory:
    """A history that shares no storage with ``h``."""
    return lbfgs.LBFGSHistory(s=h.s.clone(), y=h.y.clone(),
                              rho=h.rho.clone(), gamma=h.gamma.clone(),
                              valid=list(h.valid), newest=h.newest)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _map_rows(opt: OWLQNState, fn) -> OWLQNState:
    """``opt`` with ``fn`` applied to each row-indexed (d, 2m) leaf:
    Theta, prev_theta, prev_d and every history slot."""
    h = opt.history
    hist = dataclasses.replace(
        h, s=torch.stack([fn(x) for x in h.s]),
        y=torch.stack([fn(x) for x in h.y]))
    return opt._replace(theta=fn(opt.theta), history=hist,
                        prev_theta=fn(opt.prev_theta), prev_d=fn(opt.prev_d))


class StreamTrainer:
    """Minibatch OWLQN+ over a day stream with an overlapped re-planner.

    Args:
      stream: the :class:`DayStream` (or anything with ``num_days``,
        ``num_features``, ``sessions_per_day``, ``window(t, W)``
        returning a host batch).
      lam, beta: the Eq. 4 L2,1 / L1 weights.
      window: sliding-window width W in days.
      inner_iters: OWLQN+ iterations per window (the per-window budget).
      history: ``"reset"`` or ``"carry"`` (see the module docstring).
      memory: L-BFGS pairs.
      overlap: background re-planner on/off (off = synchronous builds).
      device: where Theta lives and the windows are copied to (default
        ``cuda``, raising without a card; pass ``"cpu"`` for the plain
        versions); on a mesh, this rank's device.
      mesh: optional (data x model) mesh; the stream then trains the
        sharded path per window with a FIXED id-range partition.
      partition: that partition (default: equal ranges over ``model``).
    """

    def __init__(self, stream: DayStream, *, lam: float, beta: float,
                 window: int = 1, inner_iters: int = 5,
                 history: str = "reset", memory: int = 10,
                 mesh=None, partition=None, overlap: bool = True,
                 device=None):
        if history not in ("reset", "carry"):
            raise ValueError(f"history must be 'reset' or 'carry', "
                             f"got {history!r}")
        if window < 1 or inner_iters < 1:
            raise ValueError("window and inner_iters must be >= 1")
        self.stream = stream
        self.mesh = mesh
        self.partition = partition
        self.data_shards = 1
        if mesh is not None:
            if partition is None:
                self.partition = make_partition(stream.num_features,
                                                mesh.model)
            if self.partition.num_rows != stream.num_features:
                raise ValueError(
                    f"partition covers {self.partition.num_rows} rows, "
                    f"stream has {stream.num_features} features")
            if self.partition.num_shards != mesh.model:
                raise ValueError(
                    f"partition has {self.partition.num_shards} shards, the "
                    f"mesh's model extent is {mesh.model}")
            self.data_shards = mesh.data
            if stream.sessions_per_day % self.data_shards:
                raise ValueError(
                    f"sessions_per_day={stream.sessions_per_day} must divide "
                    f"by the mesh's data extent {self.data_shards}")
        elif partition is not None:
            raise ValueError("partition given without a mesh")
        self.lam, self.beta = float(lam), float(beta)
        self.window = int(window)
        self.inner_iters = int(inner_iters)
        self.history = history
        self.memory = int(memory)
        self.overlap = bool(overlap)
        self.device = resolve_device(device)
        self.planner_stats = PlannerStats(0, 0.0, 0.0, 0.0, 0.0)
        # template optimizer: init/state algebra only (no loss bound)
        self._template = OWLQNPlus(_no_loss, lam=self.lam, beta=self.beta,
                                   memory=self.memory)
        # the overlapped planner's H2D stream, made in run(); the
        # synchronous planner copies on the consumer's stream instead
        self._copy_stream = None

    # ------------------------------------------------------------ state mgmt
    def _block(self, theta: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (d, 2m) Theta in the padded
        layout."""
        part = self.partition
        return part.shard_rows(part.pad_rows(theta), self.mesh.model_rank)

    def _unblock(self, block: torch.Tensor) -> torch.Tensor:
        """The global unpadded (d, 2m) tensor of every rank's block
        (a collective over ``model``)."""
        return self.partition.unpad_rows(self.mesh.gather_rows(block))

    def init(self, theta0) -> StreamState:
        """Fresh stream state at day 0 from a (d, 2m) Theta0 (a tensor or
        an array), moved to the trainer's device; on a mesh, this rank's
        rows of it."""
        theta = torch.as_tensor(theta0)
        if self.mesh is not None:
            theta = self._block(theta)
        return StreamState(opt=self._template.init(theta.to(self.device)),
                           day=0)

    def theta(self, state: StreamState) -> torch.Tensor:
        """The (d, 2m) Theta of a stream state (on the trainer's device;
        on a mesh gathered from every rank, pad rows dropped)."""
        if self.mesh is None:
            return state.opt.theta
        return self._unblock(state.opt.theta)

    def save(self, path: str, state: StreamState) -> str:
        """Checkpoint the stream (Theta + OWLQN+ history + day cursor) in
        the reference's layout; returns the real path written. On a mesh
        the leaves are the global unpadded ones and rank 0 writes them."""
        from repro_torch.io import checkpoint

        if self.mesh is not None:
            state = state._replace(opt=_map_rows(state.opt, self._unblock))
            if self.mesh.rank != 0:
                return path if path.endswith(".npz") else path + ".npz"
        return checkpoint.save_stream(path, state)

    def load(self, path: str, theta_like) -> StreamState:
        """Resume a checkpointed stream (written by either package, on any
        mesh) exactly. ``theta_like`` gives the global Theta's shape and
        dtype (values ignored)."""
        from repro_torch.io import checkpoint

        if self.mesh is None:
            return checkpoint.load_stream(path, self.init(theta_like))
        from repro_torch.dist import shard_state

        like = torch.as_tensor(theta_like).cpu()
        st = checkpoint.load_stream(
            path, StreamState(opt=self._template.init(like), day=0))
        padded = _map_rows(st.opt, self.partition.pad_rows)
        return st._replace(opt=shard_state(padded, self.mesh, self.device))

    # ------------------------------------------------------------ per window
    def _prepare(self, day: int) -> PreparedWindow:
        """Build one window on the host: slide + re-plan, copy to the
        device (pinned, on the copy stream, when overlapped), and bind the
        loss. Runs on the planner's thread."""
        t0 = time.perf_counter()
        with obs.get_tracer().span("stream/plan", day=day):
            raw = self.stream.window(day, self.window)
            batch, ready = to_device(
                plan_window(raw, partition=self.partition,
                            data_shards=self.data_shards, mesh=self.mesh),
                self.device, self._copy_stream)
        plan_s = time.perf_counter() - t0
        if self.mesh is None:
            loss_and_grad, loss = ((lambda t: smooth_loss_and_grad(t, batch)),
                                   (lambda t: nll_sparse(t, batch)))
            reduce = None
        else:
            loss_and_grad, loss = make_sharded_sparse_loss(batch, self.mesh)
            reduce = self.mesh.sum_model
        opt = OWLQNPlus(loss_and_grad, lam=self.lam, beta=self.beta,
                        memory=self.memory, loss=loss, reduce=reduce)
        return PreparedWindow(day=day, batch=batch, step=opt.step,
                              plan_seconds=plan_s, ready=ready)

    def _window_start(self, opt_state: OWLQNState) -> OWLQNState:
        """Apply the reset-vs-carry policy at a window boundary. Theta
        always carries (bit-exact warm start); ``"reset"`` re-inits the
        history/prev_* around it."""
        if self.history == "carry":
            return opt_state
        return self._template.init(opt_state.theta)

    # ---------------------------------------------------------------- driver
    def run(self, state: StreamState, days: int | None = None, *,
            callback: Callable[[int, WindowStats, StreamState],
                               None] | None = None,
            ) -> tuple[StreamState, list[WindowStats]]:
        """Consume ``days`` windows starting at ``state.day`` (default: to
        the end of the stream). ``callback(day, stats, state)`` fires after
        each window with the ADVANCED state (for eval / checkpointing
        mid-stream). Returns the advanced state and per-window stats;
        ``self.planner_stats`` holds the run's overlap accounting. The
        state handed in is not changed."""
        start = int(state.day)
        if days is None:
            days = self.stream.num_days - start
        if days <= 0:
            return state, []
        if start + days > self.stream.num_days:
            raise ValueError(f"stream has {self.stream.num_days} days; "
                             f"cannot run [{start}, {start + days})")
        if self.history == "carry":  # OWLQN+ pushes into it in place
            state = state._replace(opt=state.opt._replace(
                history=copy_history(state.opt.history)))
        on_card = self.device.type == "cuda"
        if on_card and self.overlap and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        trace: list[WindowStats] = []
        planner = WindowPlanner(self._prepare, overlap=self.overlap)
        led = obs.get_ledger()
        tracer = obs.get_tracer()
        global_iter = 0  # train_iter record index across windows
        ctx = torch.cuda.device(self.device) if on_card \
            else contextlib.nullcontext()
        try:
            with ctx:
                # the FIRST window has no device work to hide behind: get()
                # builds it synchronously, so the overlap stats only count
                # windows that could overlap
                for i in range(days):
                    t = start + i
                    win = planner.get(t)
                    if i + 1 < days:  # next window builds WHILE we step
                        planner.prefetch(t + 1)
                    opt_state = self._window_start(state.opt)
                    t0 = time.perf_counter()
                    fs, iter_stats = [], []
                    with tracer.span("stream/step", day=t):
                        for j in range(self.inner_iters):
                            with tracer.step_span("train/iter",
                                                  global_iter + j, day=t):
                                opt_state, last = win.step(opt_state)
                                fs.append(last.f_new)
                            iter_stats.append(last)
                        _sync(self.device)
                    dt = time.perf_counter() - t0
                    state = StreamState(opt=opt_state, day=t + 1)
                    ws = WindowStats(
                        day=t, days_in_window=min(self.window, t + 1),
                        fs=tuple(fs), alpha=last.alpha, nnz=last.nnz,
                        step_seconds=dt, build_seconds=win.build_seconds)
                    trace.append(ws)
                    if led.enabled:
                        for j, st in enumerate(iter_stats):
                            led.emit(
                                "train_iter", step=global_iter + j, day=t,
                                window_iter=j, f=st.f, f_new=st.f_new,
                                alpha=st.alpha, ls_iters=st.ls_iters,
                                grad_norm=st.grad_norm, nnz=st.nnz)
                        led.emit(
                            "stream_window", day=t,
                            days_in_window=ws.days_in_window,
                            plan_s=win.plan_seconds,
                            compile_s=win.compile_seconds,
                            build_s=win.build_seconds,
                            wait_s=win.wait_seconds,
                            prefetched=win.prefetched, step_s=dt,
                            carry=self.history, alpha=ws.alpha, nnz=ws.nnz,
                            fs=list(ws.fs))
                    global_iter += self.inner_iters
                    if callback is not None:
                        callback(t, ws, state)
        finally:
            self.planner_stats = planner.stats
            if led.enabled:
                ps = self.planner_stats
                led.emit(
                    "stream_summary", windows=ps.windows,
                    build_seconds=ps.build_seconds,
                    wait_seconds=ps.wait_seconds,
                    prefetched_build_seconds=ps.prefetched_build_seconds,
                    prefetched_wait_seconds=ps.prefetched_wait_seconds,
                    overlap_ratio=ps.overlap_ratio)
            planner.close()
        return state, trace
