# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Mixture-of-Experts layer (counterpart of ``repro/models/moe.py``):
top-k routing, capacity-bounded dispatch, shared expert(s), load-balance
and router-z auxiliary losses.

Dispatch is *grouped* as in the reference: tokens split into G groups,
each routed into its own capacity slice, every gather and scatter local
to its group. The reference takes G from the data-parallel extent of the
ambient mesh; sharding is not ported yet (ROADMAP queue 1 item 5.10), so
:func:`_num_groups` returns 1, and the group axis stays in the code for
that item to set.

Rank within an expert comes from a stable sort, as in the reference.
Nothing here reads a tensor back to the host: the expert counts are an
integer ``scatter_add_`` (not ``torch.bincount``, which reads its length
from the device), the dispatch is an ``index_put_`` into an (E + 1, C)
buffer whose sentinel row E, the only one that receives duplicate
indices, is sliced off, and the top-k is a stable descending sort, so
ties go to the lowest expert as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import apply_mlp, dense_init, frozen, init_mlp, matmul


def _stack_init(gen, e: int, d_in: int, d_out: int, dtype, device):
    """E stacked (d_in, d_out) projections drawn as the reference draws
    them: one (d_in, E * d_out) fan-in draw, reshaped and transposed."""
    w = dense_init(gen, d_in, e * d_out, dtype, device=device)
    return w.reshape(d_in, e, d_out).transpose(0, 1).contiguous()


class MoE(nn.Module):
    """``router`` (d_model, E) in float32 whatever the weights' type; the
    expert stacks ``w_gate``, ``w_up`` (E, d_model, F) and ``w_down`` (E,
    F, d_model); ``shared`` (an MLP of width F * num_shared_experts) when
    the config has shared experts."""

    def __init__(self, gen, cfg: MoEConfig, d_model: int, dtype, *, device="cpu"):
        super().__init__()
        e, f = cfg.num_experts, cfg.expert_d_ff
        self.router = frozen(dense_init(gen, d_model, e, torch.float32, device=device))
        self.w_gate = frozen(_stack_init(gen, e, d_model, f, dtype, device))
        self.w_up = frozen(_stack_init(gen, e, d_model, f, dtype, device))
        self.w_down = frozen(_stack_init(gen, e, f, d_model, dtype, device))
        if cfg.num_shared_experts:
            self.shared = init_mlp(gen, d_model, f * cfg.num_shared_experts, dtype,
                                   device=device)


def init_moe(gen, cfg: MoEConfig, d_model: int, dtype, *, device="cpu") -> MoE:
    return MoE(gen, cfg, d_model, dtype, device=device)


def capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)  # pad to multiple of 8


def _num_groups(tokens: int) -> int:
    """Dispatch groups: the reference's data-parallel extent of the ambient
    mesh; 1 until sharding is ported (ROADMAP queue 1 item 5.10)."""
    return 1


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lowest index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_group(xg, router, cfg: MoEConfig, cap: int):
    """Group-local routing. xg: (G, Tg, D). Returns (logits, probs,
    gate_vals, expert_idx, pos, keep, buf_idx), each with the group axis
    leading: the reference's per-group results stacked."""
    g, tg, _ = xg.shape
    e, k = cfg.num_experts, cfg.top_k
    dev = xg.device
    logits = matmul(xg.to(torch.float32), router)                # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)                     # (G, Tg, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    flat_e = expert_idx.reshape(g, tg * k)                       # (G, Tg*k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    sorted_e = flat_e.gather(1, order)
    pos_sorted = torch.arange(tg * k, dtype=torch.int64, device=dev) - starts.gather(1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted).reshape(g, tg, k)
    keep = pos < cap

    tok_ids = torch.arange(tg, dtype=torch.int64, device=dev)[None, :, None].expand(g, tg, k)
    grp = torch.arange(g, dtype=torch.int64, device=dev)[:, None, None].expand(g, tg, k)
    scat_e = torch.where(keep, expert_idx, e)                    # e = sentinel row
    scat_c = torch.where(keep, pos, 0)
    buf = torch.full((g, e + 1, cap), tg, dtype=torch.int64, device=dev)
    buf.index_put_((grp.reshape(-1), scat_e.reshape(-1), scat_c.reshape(-1)),
                   tok_ids.reshape(-1))
    buf_idx = buf[:, :e]                                         # (G, E, C)
    return logits, probs, gate_vals, expert_idx, pos, keep, buf_idx


def moe_forward(p, x, *, cfg: MoEConfig):
    """x: (B, S, D) -> (y (B, S, D) in x's type, aux) with the scalars
    ``moe_lb_loss``, ``moe_z_loss`` and ``moe_drop_frac`` (float32 tensors
    on x's device). The reference's ``deterministic`` and ``rng`` switches
    (router jitter) are unused there too and not taken."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    groups = _num_groups(t)
    tg = t // groups
    cap = capacity(tg, cfg)

    xf = x.reshape(groups, tg, d)
    logits, probs, gate_vals, expert_idx, pos, keep, buf_idx = _route_group(
        xf, p.router, cfg, cap)
    grp = torch.arange(groups, device=x.device)[:, None]

    # group-local dispatch gather: (G, Tg + 1, D)[g, buf_idx[g]] -> (G, E, C, D)
    xpad = torch.cat([xf, xf.new_zeros((groups, 1, d))], dim=1)
    expert_in = xpad[grp, buf_idx.reshape(groups, e * cap)].reshape(groups, e, cap, d)

    # "gecd,edf->gecf": one batched product per expert
    h = nn.functional.silu(matmul(expert_in, p.w_gate)) * matmul(expert_in, p.w_up)
    expert_out = matmul(h, p.w_down)                             # (G, E, C, D)
    del expert_in, h

    # group-local combine gather
    flat_slot = (expert_idx * cap + pos).reshape(groups, tg * k)
    eo = expert_out.reshape(groups, e * cap, d)
    gathered = eo[grp, torch.where(keep.reshape(groups, tg * k), flat_slot, 0)]
    gathered = gathered.reshape(groups, tg, k, d)
    gathered = torch.where(keep[..., None], gathered, 0.0)
    # "gtkd,gtk->gtd"
    y = (gathered * gate_vals.to(gathered.dtype)[..., None]).sum(2)
    y = y.reshape(t, d)

    if hasattr(p, "shared"):
        y = y + apply_mlp(p.shared, x.reshape(t, d)).to(y.dtype)

    # aux losses (Switch-style load balance + router z-loss), global means
    me = probs.reshape(t, e).mean(0)                             # (E,)
    ce = nn.functional.one_hot(expert_idx.reshape(t, k)[:, 0], e).to(torch.float32).mean(0)
    lb_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits.reshape(t, e), dim=-1) ** 2)
    aux = {
        "moe_lb_loss": cfg.aux_loss_weight * lb_loss,
        "moe_z_loss": cfg.router_z_loss_weight * z_loss,
        "moe_drop_frac": 1.0 - keep.to(torch.float32).mean(),
    }
    return y.reshape(b, s, d).to(x.dtype), aux
