"""Streaming training: the paper's production cadence, on the port.

``source``   day-sliced sparse CTR stream with id-traffic drift (host
             arrays, bit for bit the reference's)
``planner``  double-buffered host re-planner (plans + pinned H2D copies
             on a side stream, overlapped with the device steps)
``trainer``  warm-started minibatch OWLQN+ across sliding windows
"""
from repro_torch.stream.planner import (  # noqa: F401
    PlannerStats,
    PreparedWindow,
    WindowPlanner,
    plan_window,
    to_device,
)
from repro_torch.stream.source import DayStream, concat_batches  # noqa: F401
from repro_torch.stream.trainer import (  # noqa: F401
    StreamState,
    StreamTrainer,
    WindowStats,
)
