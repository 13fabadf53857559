"""Mixture-of-Experts FFN: the router, sort-based dispatch with capacity
truncation, and the experts' SwiGLU.

The port's counterpart of ``repro/models/moe.py``:

  * :func:`route`: softmax of the router logits in fp32, the top k, the
    gates renormalised to sum to 1;
  * :func:`dispatch_plan`: a stable sort of the (token, choice)
    assignments by expert, so each expert keeps its first ``capacity``
    assignments in token order and drops the rest, the same ones as the
    reference;
  * :func:`dispatch_compute`: the experts' SwiGLU as batched products
    over experts on an (E, capacity, d) buffer, then the combine.

The reference fills its buffer with a scatter and combines with a
scatter-add (``.at[token_of].add``) in sorted order, that is, each
token's k contributions added in ascending expert id. Here the buffer is
filled by a gather (each expert slot reads the token sorted into it,
empty slots read zeros) and the combine has one writer per token: the
token's k gated contributions, gathered and added in ascending expert
id, one after the other. No atomics, so the output is bitwise
repeatable on the card.

The load-balance loss is Switch Transformer's,
aux = E * sum_e(frac_tokens_e * mean_prob_e), over the top-1 choices.

Expert parallelism (:func:`moe_ffn` with a mesh; ``models/sharding.py``
holds the layout): model rank r holds experts [r E/m, (r+1) E/m), each
with d_ff / data of its columns, and routes the tokens it sees to its own
experts only (``expert_lo = r E/m``; the others' assignments are not
kept here); the partial outputs are summed over ``model`` in fp32. The
reference's two plans:

  * ``weight_gather`` (the default): a rank routes its own rows, at the
    capacity of its B_loc * S tokens, so with drops a sharded call is a
    different function from the unsharded one (the reference's own
    semantics); the d_ff slices are all-gathered over ``data`` at each
    call; the aux loss is the shard's (the model takes the mean over
    ``data``, the reference's pmean, of the layers' sum);
  * ``token_gather``: the tokens are all-gathered over ``data`` and
    routed at the capacity of the global B * S, each rank computes its
    own d_ff slice of its experts, the partials are summed over ``model``
    and ``data``, and a rank keeps its rows: the unsharded function.

With ``batch_sharded=False`` every rank holds the whole batch, so both
plans route it at the global capacity (what the reference's
``moe_mesh=None`` computes there), ``token_gather`` without gathering.

Training runs ``weight_gather``, as the reference's training does. Its
collectives are differentiable (``launch/mesh.py``): the d_ff halves are
gathered with a reduce-scatter backward over ``data``; the tokens the
experts read and the gates that scale their outputs enter through
``copy_to("model")``, since each rank's experts give only their share of
those gradients; the router itself reads the tokens directly (it is
computed alike on every rank, so its gradient is whole on each).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import copy_to, gather_split, sum_fp32
from repro_torch.models.layers import module_device, new_weight, weight_dtype

SERVING_MODES = ("weight_gather", "token_gather")


class MoE(nn.Module):
    """The experts of one layer: router (d, E), w1 and w3 (E, d, f), w2
    (E, f, d), in ``cfg.dtype`` (``cfg.param_dtype``, with a gradient,
    when ``trainable``). Left unset, on ``device`` (``cuda`` unless
    ``"cpu"``; ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        device = module_device(device)
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        dt = weight_dtype(cfg, trainable)
        self.router = new_weight((d, E), dt, device, trainable)
        self.w1 = new_weight((E, d, f), dt, device, trainable)
        self.w3 = new_weight((E, d, f), dt, device, trainable)
        self.w2 = new_weight((E, f, d), dt, device, trainable)


def init_moe(mod: MoE, cfg: ArchConfig, generator: torch.Generator) -> None:
    """Fill ``mod`` with the reference's initialisation, N(0, 1) drawn in
    fp32 from ``generator`` in the order router, w1, w3, w2 and scaled by
    d^-0.5 (w2: f^-0.5)."""
    dev = mod.router.device
    for param, fan_in in ((mod.router, cfg.d_model), (mod.w1, cfg.d_model),
                          (mod.w3, cfg.d_model), (mod.w2, cfg.d_ff)):
        param.copy_(fan_in ** -0.5 * torch.randn(
            param.shape, generator=generator, device=dev,
            dtype=torch.float32))


def route(x_flat: torch.Tensor, router_w: torch.Tensor, k: int):
    """x (T, d) -> (gate (T, k) fp32, idx (T, k) int64, probs (T, E)
    fp32). The top k are taken by a stable descending sort, so a tie goes
    to the lower expert id, as ``jax.lax.top_k``'s does."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :k], idx[:, :k]
    return gate / torch.sum(gate, dim=-1, keepdim=True), idx, probs


def aux_loss(probs: torch.Tensor, idx: torch.Tensor,
             num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss over the token set. The top-1
    one-hot is a comparison with the expert ids (``F.one_hot`` reads its
    input's range back to the host, a sync per layer on the card)."""
    experts = torch.arange(num_experts, device=idx.device)
    assign = (idx[:, :1] == experts).to(torch.float32)
    return num_experts * torch.sum(torch.mean(assign, dim=0)
                                   * torch.mean(probs, dim=0))


def capacity_for(tokens: int, num_experts: int, top_k: int,
                 factor: float = 1.25) -> int:
    cap = int(tokens * top_k / num_experts * factor)
    return max(8, -(-cap // 8) * 8)  # round up to 8


class DispatchPlan(NamedTuple):
    """Where each assignment goes. ``source`` (E, capacity): the flat
    assignment (token * k + choice) in each expert slot, 0 in an empty
    one; ``filled`` (E, capacity) bool; ``slot`` (T, k): each
    assignment's row of the (E * capacity + 1)-row expert output, the
    last row (zeros) for one not kept; ``keep`` (T, k) bool; ``mine``
    (T, k) bool: the assignments to these E experts (all of them
    unsharded), so ``mine & ~keep`` are the dropped ones."""
    source: torch.Tensor
    filled: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    mine: torch.Tensor


def dispatch_plan(idx: torch.Tensor, num_experts: int, capacity: int,
                  expert_lo: int = 0) -> DispatchPlan:
    """The reference's dispatch for idx (T, k) to the ``num_experts``
    experts from ``expert_lo`` on: the assignments sorted by expert,
    stably (token order within an expert; another rank's assignments
    sort last and are not kept), each expert keeping its first
    ``capacity``. Each expert's first rank and count come from a search
    of the sorted ids (``bincount`` would read the ids' range back to the
    host, a sync per layer on the card)."""
    T, k = idx.shape
    local = idx.reshape(-1) - expert_lo
    mine = (local >= 0) & (local < num_experts)
    flat_e = torch.where(mine, local, num_experts)
    sorted_e, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(num_experts, device=idx.device,
                           dtype=sorted_e.dtype)
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    pos = (torch.arange(T * k, device=idx.device)
           - starts[sorted_e.clamp(max=num_experts - 1)])
    keep_sorted = (sorted_e < num_experts) & (pos < capacity)
    slot_sorted = torch.where(keep_sorted, sorted_e * capacity + pos,
                              num_experts * capacity)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted  # a permutation: one writer per element
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    p = torch.arange(capacity, device=idx.device)
    filled = p[None, :] < counts[:, None]
    rank = torch.where(filled, starts[:, None] + p[None, :], 0)
    source = order[rank.clamp(max=T * k - 1)]
    return DispatchPlan(source, filled, slot.reshape(T, k),
                        keep.reshape(T, k), mine.reshape(T, k))


def dispatch_compute(x_flat: torch.Tensor, gate: torch.Tensor,
                     idx: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                     w2: torch.Tensor, capacity: int,
                     expert_lo: int = 0) -> torch.Tensor:
    """Sort-based dispatch of x (T, d) to the E experts of w1/w3 (E, d, f)
    and w2 (E, f, d), experts ``expert_lo`` .. ``expert_lo + E - 1`` of
    the router's, at ``capacity`` slots each; gate, idx (T, k) from
    :func:`route`. Returns (T, d) in x's dtype: each token's kept
    contributions eo * gate (gate rounded to x's dtype, as the
    reference's), added in ascending expert id; a dropped assignment, or
    one to another rank's expert, adds zero."""
    T, d = x_flat.shape
    E, k = w1.shape[0], idx.shape[1]
    plan = dispatch_plan(idx, E, capacity, expert_lo)
    dt = x_flat.dtype
    eb = x_flat[plan.source.reshape(-1) // k].reshape(E, capacity, d)
    eb = torch.where(plan.filled[..., None], eb, 0)
    h = F.silu(torch.bmm(eb, w1.to(dt))) * torch.bmm(eb, w3.to(dt))
    eo = torch.bmm(h, w2.to(dt)).reshape(E * capacity, d)
    eo = torch.cat([eo, eo.new_zeros((1, d))])
    # each token's choices in ascending expert id, the reference's order
    by_expert = torch.argsort(idx, dim=1)
    slot = torch.gather(plan.slot, 1, by_expert)
    g = torch.gather(gate, 1, by_expert).to(dt)
    out = eo[slot[:, 0]] * g[:, :1]
    for j in range(1, k):
        out = out + eo[slot[:, j]] * g[:, j:j + 1]
    return out


def moe_ffn(x: torch.Tensor, mod: MoE, cfg: ArchConfig,
            capacity_factor: float = 1.25,
            serving_mode: str = "weight_gather", mesh=None,
            batch_sharded: bool = True):
    """x (B, S, d) -> (out (B, S, d), aux loss fp32 scalar). Without a
    mesh (or on a 1 x 1 one) the capacity comes from the B * S tokens of
    this call and both serving modes run the same local path, as the
    reference's does. On a mesh, x is this rank's rows (its data shard's
    when ``batch_sharded``) and ``mod`` holds its experts' blocks; the
    plans are the module docstring's; ``weight_gather``'s aux is this
    data shard's (``transformer.forward`` takes the reference's pmean
    over ``data`` once, of the layers' sum)."""
    if serving_mode not in SERVING_MODES:
        raise ValueError(f"serving_mode must be one of {SERVING_MODES}, "
                         f"got {serving_mode!r}")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    x_flat = x.reshape(-1, d)
    w1, w3, w2, lo = mod.w1, mod.w3, mod.w2, 0
    sharded = mesh is not None and mesh.size > 1
    tokens = sharded and serving_mode == "token_gather"
    if sharded:
        lo = mesh.model_rank * w1.shape[0]
        if tokens and batch_sharded:  # the whole batch, its d_ff slice
            x_flat = mesh.gather(x_flat, "data", 0)
        elif not tokens:  # its own tokens, its experts' whole d_ff
            w1, w3 = (gather_split(w, mesh, "data", 2) for w in (w1, w3))
            w2 = gather_split(w2, mesh, "data", 1)
    gate, idx, probs = route(x_flat, mod.router, k)
    cap = capacity_for(x_flat.shape[0], E, k, capacity_factor)
    if sharded:  # the experts' share of the tokens' and gates' gradients
        x_flat, gate = copy_to(x_flat, mesh, "model"), copy_to(gate, mesh,
                                                               "model")
    out = dispatch_compute(x_flat, gate, idx, w1, w3, w2, cap, expert_lo=lo)
    if sharded:
        out = sum_fp32(out, mesh, "model", *(("data",) if tokens else ()))
    if tokens and batch_sharded:
        out = out.reshape(mesh.data, B * S, d)[mesh.data_rank]
    return out.reshape(B, S, d), aux_loss(probs, idx, E)


def moe_ffn_dense_reference(x: torch.Tensor, mod: MoE, cfg: ArchConfig):
    """O(T * E) dense oracle (no capacity drops) for tests: every token
    through its top-k experts exactly."""
    B, S, d = x.shape
    x_flat = x.reshape(-1, d)
    dt = x_flat.dtype
    gate, idx, probs = route(x_flat, mod.router, cfg.top_k)
    all_out = torch.stack([
        (F.silu(x_flat @ mod.w1[e].to(dt)) * (x_flat @ mod.w3[e].to(dt)))
        @ mod.w2[e].to(dt) for e in range(cfg.num_experts)], dim=1)
    sel = torch.gather(all_out, 1, idx[..., None].expand(-1, -1, d))
    out = torch.sum(sel * gate[..., None].to(dt), dim=1)
    return out.reshape(B, S, d), aux_loss(probs, idx, cfg.num_experts)
