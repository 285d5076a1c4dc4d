# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Core NN layers (counterpart of ``repro/models/layers.py``).

Layers that hold weights are ``nn.Module`` parameter holders whose
attributes carry the reference's parameter names (``scale``, ``w_gate``,
...), so a reference parameter tree maps onto them name for name
(``api/convert.py``). Projections keep the reference's (d_in, d_out)
layout and go through :func:`matmul`, which promotes mixed operand types
as ``jnp``'s ``x @ W`` does (bfloat16 weights under float32 activations
compute in float32). The forward functions take the module as the
reference's functions take their parameter dict.

Initialisers draw from an explicit ``torch.Generator`` as the reference
draws from a key: truncated normal at +-2 sigma in float32, then cast. A
``generator`` of None only allocates (meta tensors for counting, or
storage that a conversion fills).
"""
from __future__ import annotations

import math

import torch
from torch import nn

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen, shape, dtype, stddev, device):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (stddev * x).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, *, scale: float = 1.0, device="cpu"):
    """Fan-in scaled init for a (d_in, d_out) projection."""
    return _normal(gen, (d_in, d_out), dtype, scale / math.sqrt(max(d_in, 1)), device)


def embed_init(gen, vocab: int, d: int, dtype, *, device="cpu"):
    return _normal(gen, (vocab, d), dtype, 1.0, device)


def frozen(t):
    return nn.Parameter(t, requires_grad=False)


def matmul(x, w):
    """``x @ w`` in ``torch.promote_types(x.dtype, w.dtype)``, as ``jnp``
    promotes a mixed product; operands of one type go in as they are."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm weights: ``scale``. LayerNorm is not ported yet."""

    def __init__(self, d: int, dtype, *, device="cpu"):
        super().__init__()
        self.scale = frozen(torch.ones(d, dtype=dtype, device=device))


def init_norm(d: int, dtype, *, device="cpu") -> Norm:
    return Norm(d, dtype, device=device)


def apply_norm(p, x, *, eps: float = 1e-5):
    """RMSNorm in float32, cast back to x's type."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


def gated_rmsnorm(scale, x, gate, *, eps: float = 1e-5):
    """Mamba2's norm: RMSNorm(x * silu(gate)) in float32 (norm before the
    gate off), cast back to x's type. Its eps is its own, not the model's
    ``norm_eps``."""
    xf = x.to(torch.float32) * nn.functional.silu(gate.to(torch.float32))
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU weights ``w_gate``, ``w_up``, ``w_down``, each (d_in, d_out).
    The GELU MLP is not ported yet."""

    def __init__(self, gen, d_model: int, d_ff: int, dtype, *, device="cpu"):
        super().__init__()
        self.w_gate = frozen(dense_init(gen, d_model, d_ff, dtype, device=device))
        self.w_up = frozen(dense_init(gen, d_model, d_ff, dtype, device=device))
        self.w_down = frozen(dense_init(gen, d_ff, d_model, dtype, device=device))


def init_mlp(gen, d_model: int, d_ff: int, dtype, *, device="cpu") -> MLP:
    return MLP(gen, d_model, d_ff, dtype, device=device)


def apply_mlp(p, x):
    return matmul(nn.functional.silu(matmul(x, p.w_gate)) * matmul(x, p.w_up), p.w_down)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, *, device="cpu"):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding: x (..., S, H, Dh) or (..., S, Dh),
    positions broadcastable to (..., S); rotates (x1, x2) = the two halves
    of the last axis to (x1 cos - x2 sin, x2 cos + x1 sin) in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)             # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, dh/2)
    if x.dim() == ang.dim() + 1:                              # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
