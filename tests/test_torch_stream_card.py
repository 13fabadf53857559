"""The streaming slice on a CUDA card, held against the port itself.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_stream_card.py``.
Every test needs a card and skips without one. The gates:

  * the overlapped planner (side-stream H2D copies) and the synchronous
    one give bitwise equal f traces and a bitwise equal final Theta;
  * window = the whole dataset under "reset" equals full-batch OWLQN+
    bit for bit on the card;
  * a stream checkpoint resumes exactly, and a carry run leaves the
    state it was handed unchanged;
  * the card's trajectory agrees with the CPU's plain versions at the
    repo's bars (f rtol 2e-4, Theta rtol 2e-3 / atol 2e-5, the zero
    pattern equal; 3 windows x 2 steps);
  * the ``--stream`` driver runs on the card and launches B1, B2, B3.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.objective import nll_sparse, smooth_loss_and_grad
from repro_torch.data.sparse import build_batch_plans
from repro_torch.launch import train as ttrain
from repro_torch.optim.owlqn_plus import OWLQNPlus
from repro_torch.stream import DayStream, StreamTrainer, to_device

F_RTOL, TH_RTOL, TH_ATOL = 2e-4, 2e-3, 2e-5
STREAM = dict(sessions_per_day=256, num_features=20_000, active_user=24,
              active_ad=12, drift=0.05, seed=5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _theta0(d, m=4, seed=0, stream=None):
    """0.01 N(0, 1); with ``stream``, the rows no id of its days touches
    start at exact zero (fp32 sums reassociate between the card and the
    CPU, so a row that only the regulariser moves can reach zero on one
    side only)."""
    theta = (0.01 * np.random.default_rng(seed).normal(size=(d, 2 * m))
             ).astype(np.float32)
    if stream is not None:
        seen = np.zeros(d, bool)
        for b in stream:
            for ids in (b.user_ids.numpy(), b.ad_ids.numpy()):
                seen[ids[ids < d]] = True
        theta *= seen[:, None]
    return theta


def _run(device, days=3, history="reset", overlap=True, window=2, inner=2,
         **over):
    s = DayStream(days, **{**STREAM, **over})
    tr = StreamTrainer(s, lam=0.05, beta=0.05, window=window,
                       inner_iters=inner, history=history, overlap=overlap,
                       device=device)
    state, trace = tr.run(tr.init(_theta0(s.num_features, stream=s)))
    return tr, state, trace


@pytest.mark.cuda
@pytest.mark.parametrize("history", ["reset", "carry"])
def test_overlapped_equals_synchronous_bitwise(cuda, history):
    _, s_over, t_over = _run(cuda, days=4, history=history, overlap=True)
    tr, s_sync, t_sync = _run(cuda, days=4, history=history, overlap=False)
    assert [w.fs for w in t_over] == [w.fs for w in t_sync]
    assert torch.equal(s_over.opt.theta, s_sync.opt.theta)
    assert s_over.opt.theta.is_cuda


@pytest.mark.cuda
def test_full_window_reset_equals_full_batch_bitwise(cuda):
    days, iters = 3, 4
    s = DayStream(days, **STREAM)
    theta0 = torch.from_numpy(_theta0(s.num_features)).to(cuda)
    full, _ = to_device(build_batch_plans(s.window(days - 1, days)), cuda)
    opt = OWLQNPlus(lambda th: smooth_loss_and_grad(th, full), lam=0.05,
                    beta=0.05, loss=lambda th: nll_sparse(th, full))
    st = opt.init(theta0)
    fs = []
    for _ in range(iters):
        st, stats = opt.step(st)
        fs.append(stats.f_new)
    tr = StreamTrainer(s, lam=0.05, beta=0.05, window=days,
                       inner_iters=iters, device=cuda)
    state, trace = tr.run(tr.init(theta0)._replace(day=days - 1), days=1)
    assert list(trace[0].fs) == fs
    assert torch.equal(tr.theta(state), st.theta)


@pytest.mark.cuda
def test_checkpoint_resumes_exactly_and_carry_keeps_its_input(cuda,
                                                              tmp_path):
    s = DayStream(4, **STREAM)
    tr = StreamTrainer(s, lam=0.05, beta=0.05, window=2, inner_iters=2,
                       history="carry", device=cuda)
    theta0 = _theta0(s.num_features)
    mid, _ = tr.run(tr.init(theta0), days=2)
    before = mid.opt.history.s.clone()
    back = tr.load(tr.save(str(tmp_path / "stream.npz"), mid), theta0)
    assert back.opt.theta.is_cuda and back.day == 2
    fin_a, tr_a = tr.run(mid, days=2)
    fin_b, tr_b = tr.run(back, days=2)
    assert torch.equal(mid.opt.history.s, before)
    assert [w.fs for w in tr_a] == [w.fs for w in tr_b]
    assert torch.equal(fin_a.opt.theta, fin_b.opt.theta)


@pytest.mark.cuda
@pytest.mark.parametrize("history", ["reset", "carry"])
def test_card_trajectory_matches_cpu(cuda, history):
    _, s_card, t_card = _run(cuda, history=history)
    _, s_cpu, t_cpu = _run(torch.device("cpu"), history=history)
    np.testing.assert_allclose(np.array([w.fs for w in t_card]),
                               np.array([w.fs for w in t_cpu]), rtol=F_RTOL)
    card, cpu = s_card.opt.theta.cpu().numpy(), s_cpu.opt.theta.numpy()
    np.testing.assert_allclose(card, cpu, rtol=TH_RTOL, atol=TH_ATOL)
    np.testing.assert_array_equal(card == 0, cpu == 0)


@pytest.mark.cuda
def test_to_device_copies_on_a_side_stream(cuda):
    s = DayStream(2, **STREAM)
    host = build_batch_plans(s.window(1, 2))
    side = torch.cuda.Stream(cuda)
    moved, ready = to_device(host, cuda, side)
    torch.cuda.current_stream().wait_event(ready)
    assert moved.ad_ids.is_cuda and moved.ad_plan.row_ids.is_cuda
    assert torch.equal(moved.ad_ids.cpu(), host.ad_ids)
    assert torch.equal(moved.user_plan.inv_sorted.cpu(),
                       host.user_plan.inv_sorted)
    for a, b in zip(moved.ad_plan.class_src, host.ad_plan.class_src):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_to_device_without_a_stream_copies_on_the_current_stream(cuda):
    s = DayStream(2, **STREAM)
    host = build_batch_plans(s.window(1, 2))
    moved, ready = to_device(host, cuda)
    assert ready is None
    assert moved.ad_ids.is_cuda and moved.user_plan.row_ids.is_cuda
    assert torch.equal(moved.ad_ids.cpu(), host.ad_ids)
    assert torch.equal(moved.ad_plan.inv_sorted.cpu(),
                       host.ad_plan.inv_sorted)


@pytest.mark.cuda
def test_stream_driver_launches_the_training_kernels(cuda, tmp_path):
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES as B1,
    )
    from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
        LAUNCHES as B2,
    )
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        LAUNCHES as B3,
    )

    before = (dict(B1), dict(B2), dict(B3))
    rep = ttrain.run(["--stream", "--days", "3", "--window", "2",
                      "--inner-iters", "2", "--sessions", "192",
                      "--sparse-features", "400", "--regions", "4",
                      "--lam", "0.25", "--beta", "0.25", "--drift", "0.06",
                      "--ckpt", str(tmp_path / "s.npz")])
    assert rep["device"].startswith("cuda") and rep["final_day"] == 3
    assert all(np.isfinite(w["fs"]).all() for w in rep["windows"])
    for counts, was in zip((B1, B2, B3), before):
        assert sum(counts.values()) > sum(was.values())
