"""Streaming day-by-day LS-PLM training on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/train_sparse_streaming_torch.py
    PYTHONPATH=src python examples/train_sparse_streaming_torch.py --device cpu

The port's counterpart of ``examples/train_sparse_streaming.py``, on the
card by default. The full-batch OWLQN+ of the paper is how ONE retrain
runs; Alibaba's system retrains as new days of impressions arrive. This
example runs that loop on a synthetic drifted day stream
(``repro_torch.stream``):

  * a :class:`DayStream` yields per-day padded-COO batches whose hot id
    head ROTATES a little every day;
  * per day, the trainer re-plans the sliding window of the last W days
    on the host and copies it to the device on a side stream, OVERLAPPED
    with the previous window's device iterations (``WindowPlanner``),
    then runs a bounded budget of warm-started OWLQN+ steps (on a card:
    the fused sparse forward B1, the run-length scatter B2, the Eq. 9
    direction B3);
  * Theta carries across windows bit-exactly, the L-BFGS history resets
    at boundaries by default.

The punchline printed at the end: held-out NEXT-day NLL of the streamed
model vs a train-once model given the same total iteration budget on
day 0 — under drift, the stream wins — plus the planner's measured
overlap ratio.
"""
import argparse
import time

import numpy as np

from repro_torch.core.objective import nll_sparse
from repro_torch.data.sparse import sparse_predict
from repro_torch.device import resolve_device
from repro_torch.eval.metrics import auc
from repro_torch.stream import DayStream, StreamTrainer
from repro_torch.stream.planner import to_device

D, M = 400, 4
DAYS, WINDOW, INNER = 6, 2, 5
LAM = BETA = 0.25


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    device = resolve_device(ap.parse_args().device)
    # DAYS of training traffic + one held-out next day, sized so ids
    # repeat enough for a small demo to LEARN the drifting head
    stream = DayStream(DAYS + 1, sessions_per_day=192, num_features=D,
                       active_user=8, active_ad=5, drift=0.06,
                       head_width=0.06, head_frac=0.85, seed=11)
    theta0 = (0.01 * np.random.default_rng(0).normal(size=(D, 2 * M))
              ).astype(np.float32)
    held, _ = to_device(stream.day(DAYS), device)
    B = held.y.shape[0]

    def next_day(theta):
        p = sparse_predict(theta, held).cpu().numpy()
        return (float(nll_sparse(theta, held)) / B,
                auc(held.y.cpu().numpy(), p))

    trainer = StreamTrainer(stream, lam=LAM, beta=BETA, window=WINDOW,
                            inner_iters=INNER, device=device)
    print(f"stream: {DAYS} days x {stream.sessions_per_day} sessions, "
          f"d={D:,}, window={WINDOW} days, {INNER} OWLQN+ iters/window, "
          f"overlapped re-planner, device={device}")
    t0 = time.perf_counter()
    state, trace = trainer.run(
        trainer.init(theta0), days=DAYS,
        callback=lambda t, ws, st: print(
            f"  day {t}  window={ws.days_in_window}d f={ws.fs[-1]:9.2f} "
            f"nnz={ws.nnz:6d} plan={ws.build_seconds * 1e3:5.0f}ms "
            f"step={ws.step_seconds * 1e3:5.0f}ms"))
    dt = time.perf_counter() - t0
    ps = trainer.planner_stats
    print(f"streamed {DAYS} windows in {dt:.1f}s — host re-planning "
          f"{ps.build_seconds:.2f}s, {ps.wait_seconds:.2f}s exposed "
          f"(overlap ratio {ps.overlap_ratio:.2f})")

    # train-once baseline: the SAME total iteration budget, all on day 0
    base = StreamTrainer(stream, lam=LAM, beta=BETA, window=1,
                         inner_iters=INNER * DAYS, device=device)
    base_state, _ = base.run(base.init(theta0), days=1)

    nll_s, auc_s = next_day(trainer.theta(state))
    nll_b, auc_b = next_day(base.theta(base_state))
    print(f"\nheld-out day {DAYS} (next day after the stream):")
    print(f"  train-once on day 0 : NLL {nll_b:.4f}  AUC {auc_b:.4f}")
    print(f"  streamed (window={WINDOW}): NLL {nll_s:.4f}  AUC {auc_s:.4f}")
    print(f"  drift makes the stale model pay "
          f"{(nll_b - nll_s) / nll_s * 100:+.1f}% NLL")


if __name__ == "__main__":
    main()
