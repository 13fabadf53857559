"""Algorithm 1 (the paper's optimizer): OWLQN generalised to L1 + L2,1
non-convex objectives through directional-derivative descent directions.

The port's counterpart of ``repro/optim/owlqn_plus.py``. The reference
works on pytrees; the sparse path has exactly one leaf, the (d, 2m) Theta,
so this optimizer takes ONE tensor (feature rows are the L2,1 groups, the
last axis the within-group axis). The three changes from L-BFGS:

  1. the Eq. 9 direction d replaces the negative gradient (the
     hand-written kernel, B3, on a CUDA Theta: ``core.direction``);
  2. the update direction p = pi(H d; d) is constrained to d's orthant;
     pairs with y.s <= 0 are masked from the history, and with no valid
     pair the two-loop returns p = d;
  3. the backtracking line search projects every trial point onto the
     orthant xi of Eq. 10 (Eq. 12).

The step is a host loop. Line-search trials evaluate the loss ONLY, under
``torch.no_grad()`` (the reference computes a gradient per trial and
drops it; the result is the same), and each trial's acceptance test is one
``.item()``. The accepted Theta is a plain tensor again before the next
step, which takes the one gradient of the iteration.

Row-sharded (``reduce=``, see ``repro_torch.dist``): each rank holds its
rows of Theta and of the L-BFGS history, the loss it is given is already
the global one (``repro_torch.shard.step``), and every GLOBAL reduction
of the step goes through ``reduce``, the mesh's sum over its ``model``
group (``Mesh.sum_model``): the regulariser, the two-loop's dot
products, the history pair's y.s and y.y, ||p||^2 and ||d||^2, the line
search's sufficient-decrease gain and the non-zero count. Row-local work
(the Eq. 9 direction, B3 on the card, the orthant projections) stays
local. Every host branch reads reduced scalars, which are bitwise equal
on every rank, so no rank takes another path. (A reduction over the
whole world would count each term ``data`` times.)
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import direction as dirlib
from repro_torch.optim import lbfgs


def reg_value(theta: torch.Tensor, lam: float, beta: float) -> torch.Tensor:
    """lam * ||Theta||_{2,1} + beta * ||Theta||_1 (rows are the groups;
    a 1-D Theta is treated as (n, 1))."""
    g = theta[:, None] if theta.ndim == 1 else theta
    l21 = torch.sqrt((g * g).sum(dim=-1)).sum()
    return lam * l21 + beta * g.abs().sum()


class OWLQNState(NamedTuple):
    theta: torch.Tensor
    history: lbfgs.LBFGSHistory
    prev_theta: torch.Tensor  # Theta^{k-1} (for s^{(k)})
    prev_d: torch.Tensor  # d^{k-1} (for y^{(k)} = d^{k-1} - d^{k})
    step: int  # iteration counter
    f: float  # objective at theta (inf before the first step)


class StepStats(NamedTuple):
    f: float  # objective BEFORE the step
    f_new: float
    alpha: float  # accepted step size (0 if the line search failed)
    ls_iters: int
    grad_norm: float  # ||d|| -- the optimality measure of Eq. 4
    nnz: int  # non-zero parameter count


class OWLQNPlus:
    """Algorithm 1 on one parameter tensor.

    ``loss_and_grad(theta) -> (loss, grad)`` is the SMOOTH part (Eq. 5)
    only; the regularisers are handled here. ``loss(theta) -> loss`` is
    the same loss without a gradient, for the line search (default: the
    first output of ``loss_and_grad``). ``reduce(t) -> t`` sums a rank's
    partials over the ranks that share its samples (default: none, the
    whole Theta is here)."""

    def __init__(self, loss_and_grad: Callable, lam: float, beta: float,
                 memory: int = 10, c1: float = 1e-4, max_ls: int = 30,
                 ls_shrink: float = 0.5, loss: Callable | None = None,
                 reduce: Callable | None = None):
        self.loss_and_grad = loss_and_grad
        self.loss = loss if loss is not None else (
            lambda t: loss_and_grad(t)[0])
        self.lam = float(lam)
        self.beta = float(beta)
        self.memory = memory
        self.c1 = c1
        self.max_ls = max_ls
        self.ls_shrink = ls_shrink
        # the sum of a rank's partials of the global reductions (the
        # mesh's model-group sum); None = the whole Theta is here
        self.reduce = reduce

    def _global(self, *partials: torch.Tensor):
        """This rank's partials of global sums -> the sums, in one
        reduction (the partials themselves without a mesh)."""
        if self.reduce is None:
            return partials if len(partials) > 1 else partials[0]
        out = self.reduce(torch.stack(partials))
        return tuple(out) if len(partials) > 1 else out[0]

    def init(self, theta0: torch.Tensor) -> OWLQNState:
        theta0 = theta0.detach()
        return OWLQNState(theta=theta0.clone(),
                          history=lbfgs.init_history(theta0, self.memory),
                          prev_theta=theta0.clone(),
                          prev_d=torch.zeros_like(theta0), step=0,
                          f=float("inf"))

    def objective(self, theta: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.loss(theta) + self._global(
                reg_value(theta, self.lam, self.beta))

    def step(self, state: OWLQNState) -> tuple[OWLQNState, StepStats]:
        """One iteration of Algorithm 1. The state's history is updated in
        place (the returned state shares it)."""
        lam, beta = self.lam, self.beta
        theta = state.theta
        loss, grad = self.loss_and_grad(theta)
        red = self.reduce
        with torch.no_grad():
            f0 = loss + self._global(reg_value(theta, lam, beta))

            # (1) Eq. 9 direction
            d = dirlib.descent_direction(theta, grad, lam, beta)
            del grad

            # (5)(6) the history pair of the PREVIOUS iteration
            history = state.history
            if state.step > 0:
                lbfgs.push(history, theta - state.prev_theta,
                           state.prev_d - d, reduce=red)

            # (2) p = pi(H d; d); an empty/masked history gives p = d
            p = dirlib.project_orthant(lbfgs.two_loop(history, d, red), d)
            p_norm2, d_norm2 = self._global(lbfgs.vdot(p, p),
                                            lbfgs.vdot(d, d))
            if not bool(p_norm2 > 0):  # the projection annihilated p
                p, p_norm2 = d, d_norm2

            # (3) orthant xi (Eq. 10) + projected backtracking (Eq. 12)
            xi = dirlib.choose_orthant(theta, d)
            d_norm = torch.sqrt(d_norm2)
            if state.step == 0:
                alpha = float(1.0 / torch.clamp(torch.sqrt(p_norm2),
                                                min=1e-12))
            else:
                alpha = 1.0
            ok = False
            ls_iters = 0
            theta_t, f_t = theta, f0
            while not ok and ls_iters < self.max_ls:
                if ls_iters > 0:
                    alpha *= self.ls_shrink
                theta_t = dirlib.project_orthant(
                    torch.add(theta, p, alpha=alpha), xi)
                # OWLQN acceptance: f(x') <= f(x) + c1 * <-d, x' - x>
                reg_t, gain = self._global(reg_value(theta_t, lam, beta),
                                           -lbfgs.vdot(d, theta_t - theta))
                f_t = self.loss(theta_t) + reg_t
                ok = bool(f_t <= f0 + self.c1 * gain)
                ls_iters += 1

            if ok:
                theta_new, f_new = theta_t, f_t
            else:  # line-search failure: keep Theta
                theta_new, f_new, alpha = theta, f0, 0.0
            nnz = int(self._global(torch.count_nonzero(theta_new)))

        new_state = OWLQNState(theta=theta_new, history=history,
                               prev_theta=theta, prev_d=d,
                               step=state.step + 1, f=float(f_new))
        stats = StepStats(f=float(f0), f_new=float(f_new), alpha=float(alpha),
                          ls_iters=ls_iters, grad_norm=float(d_norm), nnz=nnz)
        return new_state, stats

    def run(self, theta0: torch.Tensor, max_iters: int = 100,
            tol: float = 1e-6,
            callback: Callable[[int, StepStats], None] | None = None,
            ledger=None, tracer=None
            ) -> tuple[torch.Tensor, list[StepStats]]:
        """Loop :meth:`step` with early stopping on ||d|| < tol, a failed
        line search (alpha = 0) and f stagnation. Each iteration runs in a
        ``train/iter`` span and, when a run ledger is active, emits one
        ``train_iter`` record."""
        led = ledger if ledger is not None else obs.get_ledger()
        tr = tracer if tracer is not None else obs.get_tracer()
        state = self.init(theta0)
        trace: list[StepStats] = []
        prev_f = None
        for k in range(max_iters):
            t0 = time.perf_counter()
            with tr.step_span("train/iter", k):
                state, stats = self.step(state)
            trace.append(stats)
            if led.enabled:
                led.emit("train_iter", step=k, f=stats.f, f_new=stats.f_new,
                         alpha=stats.alpha, ls_iters=stats.ls_iters,
                         grad_norm=stats.grad_norm, nnz=stats.nnz,
                         wall_s=time.perf_counter() - t0)
            if callback is not None:
                callback(k, stats)
            if stats.grad_norm < tol:
                break
            if stats.alpha == 0.0:  # line search failed: converged
                break
            if prev_f is not None and abs(prev_f - stats.f_new) <= tol * max(
                    1.0, abs(prev_f)):
                break
            prev_f = stats.f_new
        return state.theta, trace
