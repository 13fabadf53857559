"""The collective traffic of a step, in the reference's layout.

The port's counterpart of ``repro/utils/hlo.py`` ``collective_bytes``,
with one difference: the reference parses the compiled per-device HLO
(torch has none) and sums the result shapes of every collective op in
it; here the numbers are what a rank's
:class:`~repro_torch.launch.mesh.Mesh` counted while the step ran
(``Mesh.collective_counts``), the same on a real world (gloo, NCCL) and
on a fake one (the dry run's ``"fake"`` backend, where each collective
returns at once). Every collective the port issues is an all-reduce: its
all-gathers and reduce-scatters (``Mesh.gather``, FSDP's
``gather_split``) are built on all-reduces, so they are counted as the
all-reduces they are, with the bytes of the buffers reduced (the
volume proxy of ``hlo.py``: a buffer's bytes per device, not the wire
bytes of a ring).
"""
from __future__ import annotations

from repro_torch.launch.mesh import AXES


def collective_bytes(mesh) -> dict:
    """``{"all-reduce": {"count": n, "bytes": b}, "total_bytes": b}``
    (``hlo.collective_bytes``' layout; no entry without a collective)
    of what ``mesh`` counted, over both of its axes."""
    counts = mesh.collective_counts()
    n = sum(int(counts[a]["all_reduce"]) for a in AXES)
    b = sum(int(counts[a]["bytes"]) for a in AXES)
    out: dict = {"all-reduce": {"count": n, "bytes": b}} if n else {}
    out["total_bytes"] = b
    return out


def by_axis(mesh) -> dict:
    """``{axis: {"count": n, "bytes": b}}`` of what ``mesh`` counted, and
    under ``"gather"`` / ``"reduce_scatter"`` the calls and bytes of
    :func:`~repro_torch.launch.mesh.gather_split` among them."""
    counts = mesh.collective_counts()
    out = {a: {"count": int(counts[a]["all_reduce"]),
               "bytes": int(counts[a]["bytes"])} for a in AXES}
    for kind, c in mesh.split_counts().items():
        out[kind] = {"count": c["calls"], "bytes": c["bytes"]}
    return out
