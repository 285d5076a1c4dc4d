# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Mamba2 / SSD (state-space duality) block, arXiv:2405.21060 (counterpart
of ``repro/models/ssm.py``).

The SSD *chunked* form: the work inside a chunk is dense masked products,
the state passes between chunks in a Python loop of S / chunk steps (the
reference's ``lax.scan``). Decode is an O(1) state update.

Layout: x (B, S, H, P) heads x head_dim; state (B, H, P, N). The B/C
projections come in G groups of H / G heads each (the reference's
``jnp.repeat`` of a group to its heads, head h reading group h // (H /
G)): the products are taken per group with the group's heads folded into
one matrix axis, the same products without materialising the repeat. The
(B, nc, L, L, H) intra-chunk tensors are built one at a time, in the
(B, nc, H, L, L) layout a batched product reads, and the three-operand
product is taken as (C.B * decay) then its product with dt * x: no
intermediate is larger than one of them.

Decode writes the layer's conv and SSD states in place into the cache it
is given (views of the model's stacked cache), as attention writes its
K/V; prefill returns them as new tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import dense_init, frozen, gated_rmsnorm, matmul

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Mamba2(nn.Module):
    """``in_proj`` (d_model, 2 d_inner + 2 G N + H), the depthwise
    ``conv_w`` (W, conv_dim) and ``conv_b``, float32 ``A_log``, ``D`` and
    ``dt_bias`` (H,) whatever the weights' type, ``norm_scale`` (d_inner,)
    and ``out_proj`` (d_inner, d_model)."""

    def __init__(self, gen, cfg: SSMConfig, d_model: int, dtype, *, device="cpu"):
        super().__init__()
        d_inner = cfg.d_inner(d_model)
        nheads = cfg.num_heads(d_model)
        g, n = cfg.ngroups, cfg.d_state
        conv_dim = d_inner + 2 * g * n
        # in_proj -> [z (d_inner), x (d_inner), B (g*n), C (g*n), dt (nheads)]
        d_in_proj = 2 * d_inner + 2 * g * n + nheads
        f32 = torch.float32
        self.in_proj = frozen(dense_init(gen, d_model, d_in_proj, dtype, device=device))
        conv_w = torch.empty((cfg.conv_width, conv_dim), dtype=f32, device=device)
        if gen is not None:
            conv_w.normal_(generator=gen).mul_(0.1)
        self.conv_w = frozen(conv_w.to(dtype))
        self.conv_b = frozen(torch.zeros(conv_dim, dtype=dtype, device=device))
        self.A_log = frozen(torch.log(torch.linspace(1.0, 16.0, nheads, dtype=f32,
                                                     device=device)))
        self.D = frozen(torch.ones(nheads, dtype=f32, device=device))
        self.dt_bias = frozen(torch.log(torch.expm1(torch.full((nheads,), 0.01, dtype=f32,
                                                               device=device))))
        self.norm_scale = frozen(torch.ones(d_inner, dtype=dtype, device=device))
        self.out_proj = frozen(dense_init(gen, d_inner, d_model, dtype, device=device))


def init_mamba2(gen, cfg: SSMConfig, d_model: int, dtype, *, device="cpu") -> Mamba2:
    return Mamba2(gen, cfg, d_model, dtype, device=device)


def init_ssm_cache(cfg: SSMConfig, d_model: int, batch: int, dtype, *, device="cpu"):
    """``conv`` (B, W - 1, conv_dim) in ``dtype`` (the compute type) and
    ``ssd`` (B, H, P, N) in float32."""
    d_inner = cfg.d_inner(d_model)
    nheads = cfg.num_heads(d_model)
    g, n = cfg.ngroups, cfg.d_state
    conv_dim = d_inner + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, nheads, cfg.head_dim, n), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _split_proj(zxbcdt, cfg: SSMConfig, d_model: int):
    """(z, x, B, C, dt) along the last axis, views of ``zxbcdt``."""
    d_inner = cfg.d_inner(d_model)
    gn = cfg.ngroups * cfg.d_state
    z, x, b_mat, c_mat, dt = torch.split(
        zxbcdt, [d_inner, d_inner, gn, gn, zxbcdt.shape[-1] - 2 * d_inner - 2 * gn], dim=-1)
    return z, x, b_mat, c_mat, dt


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv over axis 1. xbc: (B, S, Cd); conv_w: (W, Cd).
    The W taps are summed in order in float32, then the bias. Returns
    (silu(conv) in xbc's type, the last W - 1 inputs: the next state)."""
    w = conv_w.shape[0]
    if conv_state is not None:
        xbc_pad = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        xbc_pad = nn.functional.pad(xbc, (0, 0, w - 1, 0))
    s = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(w):  # width is 4: unrolled shifts, depthwise
        out = out + xbc_pad[:, i:i + s, :].to(torch.float32) * conv_w[i].to(torch.float32)
    out = out + conv_b.to(torch.float32)
    new_state = xbc_pad[:, xbc_pad.shape[1] - (w - 1):, :]
    return nn.functional.silu(out).to(xbc.dtype), new_state


def ssd_chunked(x, dt, A, b_mat, c_mat, *, chunk: int, init_state=None):
    """SSD chunked scan.

    x: (B, S, H, P) f32; dt: (B, S, H) f32 (already softplus'ed);
    A: (H,) f32 negative; b_mat/c_mat: (B, S, G, N) f32.
    Returns y (B, S, H, P) and the final state (B, H, P, N).
    """
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    rep = h // g
    L = chunk

    xc = x.reshape(bsz, nc, L, h, p)
    dtc = dt.reshape(bsz, nc, L, h)
    bc = b_mat.reshape(bsz, nc, L, g, n).permute(0, 1, 3, 2, 4)   # (B,nc,G,L,N)
    cc = c_mat.reshape(bsz, nc, L, g, n).permute(0, 1, 3, 2, 4)   # (B,nc,G,L,N)

    da = dtc * A                                          # (B,nc,L,H): log-decay per step
    cum = torch.cumsum(da, dim=2)                         # (B,nc,L,H)
    u = xc * dtc[..., None]                               # (B,nc,L,H,P): dt * x

    # intra-chunk term: y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) u_j
    cum_h = cum.permute(0, 1, 3, 2)                       # (B,nc,H,L)
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    li = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill(~mask, float("-inf"))
    cb = cc @ bc.transpose(-1, -2)                        # (B,nc,G,Li,Lj)
    m = torch.exp(li).reshape(bsz, nc, g, rep, L, L) * cb[:, :, :, None]
    del li
    u_h = u.permute(0, 1, 3, 2, 4)                        # (B,nc,H,L,P)
    y = (m.reshape(bsz, nc, h, L, L) @ u_h).permute(0, 1, 3, 2, 4)   # (B,nc,L,H,P)
    del m

    # chunk-final states: state_c = sum_l exp(cum_L - cum_l) u_l B_l^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,L,H)
    ud = (u * decay_to_end[..., None]).permute(0, 1, 3, 4, 2)      # (B,nc,H,P,L)
    state_chunks = (ud.reshape(bsz, nc, g, rep * p, L) @ bc).reshape(bsz, nc, h, p, n)

    chunk_decay = torch.exp(torch.sum(da, dim=2))         # (B,nc,H) total decay per chunk

    st = init_state if init_state is not None else torch.zeros(
        (bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):                                    # state entering each chunk
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + state_chunks[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,P,N)

    # inter-chunk term: y_l += exp(cum_l) C_l . prev_state
    s_g = prev_states.reshape(bsz, nc, g, rep * p, n).transpose(-1, -2)   # (B,nc,G,N,rep*P)
    y_inter = (cc @ s_g).reshape(bsz, nc, g, L, rep, p).permute(0, 1, 3, 2, 4, 5)
    y = y + y_inter.reshape(bsz, nc, L, h, p) * torch.exp(cum)[..., None]
    return y.reshape(bsz, s, h, p), st


def ssd_decode_step(x, dt, A, b_mat, c_mat, state):
    """One-token SSD update. x: (B, 1, H, P); dt: (B, 1, H); b/c: (B, 1, G,
    N); state: (B, H, P, N). Returns y (B, 1, H, P) and the new state."""
    h = x.shape[2]
    rep = h // b_mat.shape[2]
    da = torch.exp(dt[:, 0] * A)                          # (B,H)
    bh = torch.repeat_interleave(b_mat[:, 0], rep, dim=1)  # (B,H,N)
    ch = torch.repeat_interleave(c_mat[:, 0], rep, dim=1)  # (B,H,N)
    u = x[:, 0] * dt[:, 0, :, None]                       # (B,H,P)
    new_state = state * da[..., None, None] + u[..., None] * bh[:, :, None, :]
    y = (new_state @ ch[..., None])[..., 0]               # (B,H,P)
    return y[:, None], new_state


# ---------------------------------------------------------------------------
# full block forward
# ---------------------------------------------------------------------------


def mamba2_forward(p, x_in, *, cfg: SSMConfig, d_model: int, mode: str = "train",
                   cache: Optional[dict] = None):
    """x_in (B, S, D), the post-norm input. Returns (out (B, S, D), cache):
    prefill's new {"conv", "ssd"}, decode's ``cache`` written in place,
    None in training."""
    bsz, s, _ = x_in.shape
    d_inner = cfg.d_inner(d_model)
    nheads = cfg.num_heads(d_model)
    g, n, pdim = cfg.ngroups, cfg.d_state, cfg.head_dim

    zxbcdt = matmul(x_in, p.in_proj)
    z, _, _, _, dt = _split_proj(zxbcdt, cfg, d_model)
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * g * n]   # [x, B, C], contiguous in the projection
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")
    conv_state = cache["conv"] if mode == "decode" else None
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xr, b_mat, c_mat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)

    xh = xr.reshape(bsz, s, nheads, pdim).to(torch.float32)
    bg = b_mat.reshape(bsz, s, g, n).to(torch.float32)
    cg = c_mat.reshape(bsz, s, g, n).to(torch.float32)
    dtp = nn.functional.softplus(dt.to(torch.float32) + p.dt_bias)   # (B,S,H)
    a_neg = -torch.exp(p.A_log)                           # (H,)

    if mode == "decode":
        y, new_ssd = ssd_decode_step(xh, dtp, a_neg, bg, cg, cache["ssd"])
    else:
        pad = (-s) % cfg.chunk_size
        if pad:
            xh_p = nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
            bg = nn.functional.pad(bg, (0, 0, 0, 0, 0, pad))
            cg = nn.functional.pad(cg, (0, 0, 0, 0, 0, pad))
            dtp = nn.functional.pad(dtp, (0, 0, 0, pad))
        else:
            xh_p = xh
        y, new_ssd = ssd_chunked(xh_p, dtp, a_neg, bg, cg, chunk=cfg.chunk_size)
        y = y[:, :s]

    y = y + xh * p.D[None, None, :, None]                 # skip-connection D term
    y = y.reshape(bsz, s, d_inner).to(x_in.dtype)
    y = gated_rmsnorm(p.norm_scale, y, z)
    out = matmul(y, p.out_proj)

    if mode == "decode":
        cache["conv"].copy_(new_conv)
        cache["ssd"].copy_(new_ssd)
        return out, cache
    if mode == "prefill":
        # a copy: the slice would keep the whole padded input alive
        return out, {"conv": new_conv.to(x_in.dtype).clone(), "ssd": new_ssd}
    return out, None
