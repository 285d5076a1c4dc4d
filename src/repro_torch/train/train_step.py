# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Train, prefill and decode steps (counterpart of
``repro/train/train_step.py``).

``make_train_step(cfg)`` returns ``step(state, batch) -> (state,
metrics)``. It updates the state (``train.state``) in place and returns
it; the metrics (``loss``, ``ce``, ``ntok``, ``grad_norm``, ``lr``) stay
on the device, and a step reads nothing back to the host.

Loss: masked token cross-entropy (labels == IGNORE are excluded -- used
for multimodal prefix positions and padding) + MoE auxiliary losses + the
DeepSeek-style MTP auxiliary CE when enabled (no ported config has either
yet; the branches are the reference's).

Training runs the chunked attention path: the flash kernel is
forward-only, as the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import forward
from repro_torch.optim import constant, make_optimizer
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm, tensors,
                                          tree_unflatten)

IGNORE = -100


def cross_entropy(logits, labels, ignore=IGNORE):
    """Masked CE; logits (B, S, V), labels (B, S) int32 (may contain
    IGNORE). Returns (mean NLL over the unmasked tokens, their count as an
    int32 tensor, at least 1).

    The reference reads the gold logit through a one-hot contraction (a
    sharding choice); a gather gives the same value for finite logits,
    since every other term of that contraction is 0 * x, without the
    (B, S, V) one-hot. float32 only inside the reduction."""
    mask = labels != ignore
    safe = torch.where(mask, labels, 0).to(torch.int64)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(dtype=torch.int32), min=1)
    return nll.sum() / denom, denom


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch, deterministic=True):
        # ``deterministic`` is the reference's switch for stochastic layers;
        # no ported layer is stochastic
        logits, _, aux = forward(params, batch, cfg, mode="train")
        labels = batch["labels"]
        # logits cover (prefix + text); labels are provided full-length
        ce, ntok = cross_entropy(logits[:, -labels.shape[1]:, :], labels)
        loss = ce
        metrics = {"ce": ce, "ntok": ntok}
        for k in ("moe_lb_loss", "moe_z_loss"):
            if k in aux:
                loss = loss + aux[k]
                metrics[k] = aux[k]
        if "moe_drop_frac" in aux:
            metrics["moe_drop_frac"] = aux["moe_drop_frac"]
        if "mtp_logits" in aux:
            # MTP predicts token t+2: shift labels by one extra position
            mtp_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE)],
                                   dim=1)
            mtp_ce, _ = cross_entropy(aux["mtp_logits"], mtp_labels)
            loss = loss + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_train_step(cfg: ModelConfig, lr_schedule=None, clip_norm: float = 1.0):
    """cfg.microbatch > 1 enables gradient accumulation: the global batch is
    split on the leading axis and run one microbatch at a time, bounding
    activation memory to one microbatch. Gradients accumulate in the
    parameter's type, as the reference's (``grads + g / n``)."""
    from repro_torch.train.state import param_tree

    opt = make_optimizer(cfg.optimizer)
    loss_fn = make_loss_fn(cfg)
    lr_schedule = lr_schedule or constant(3e-4)

    def grad_fn(params, leaves, batch):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def accumulate(params, leaves, batch):
        n = cfg.microbatch
        b = batch["tokens"].shape[0]
        if n <= 1 or b % n:
            return grad_fn(params, leaves, batch)
        micro = {k: v.reshape((n, b // n) + tuple(v.shape[1:])) for k, v in batch.items()}
        grads = [torch.zeros_like(p) for p in leaves]
        loss_a, metrics_a = None, None
        for i in range(n):
            loss, metrics, g = grad_fn(params, leaves, {k: v[i] for k, v in micro.items()})
            grads = [x + y / n for x, y in zip(grads, g)]
            if metrics_a is None:
                loss_a = torch.zeros((), dtype=torch.float32, device=loss.device)
                metrics_a = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                             for k, v in metrics.items()}
            metrics_a = {k: metrics_a[k] + metrics[k] / n for k in metrics_a}
            loss_a = loss_a + loss / n
            del g
        return loss_a, metrics_a, grads

    def step(state, batch):
        ptree = param_tree(state["params"])
        leaves = tensors(ptree)
        _, metrics, grads = accumulate(state["params"], leaves, batch)
        grads, gnorm = clip_by_global_norm(tree_unflatten(ptree, grads), clip_norm)
        lr = lr_schedule(state["step"])
        with torch.no_grad():
            updates, state["opt"] = opt.update(grads, state["opt"], ptree, lr)
            del grads
            apply_updates(ptree, updates)
            state["step"].add_(1)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return state, metrics

    return step


def make_prefill_step(cfg: ModelConfig, *, use_flash_kernel: bool = False):
    """prefill(params, batch) -> (last-position logits (B, 1, V), cache).
    ``use_flash_kernel`` sends each layer's full-sequence attention through
    the flash-attention kernel where the shape qualifies."""

    @torch.no_grad()
    def prefill(params, batch):
        logits, cache, _ = forward(params, batch, cfg, mode="prefill",
                                   use_flash_kernel=use_flash_kernel)
        return logits[:, -1:, :], cache

    return prefill


def make_serve_step(cfg: ModelConfig):
    """ONE new token against a cache of cache_len entries:
    serve(params, cache, cache_index, tokens (B, 1)) -> (logits, next
    token (B,) int32 on the device, cache written in place)."""

    @torch.no_grad()
    def serve(params, cache, cache_index: int, tokens):
        logits, new_cache, _ = forward(params, {"tokens": tokens}, cfg, mode="decode",
                                       cache=cache, cache_index=cache_index)
        next_tok = logits[:, -1, :].argmax(-1).to(torch.int32)
        return logits, next_tok, new_cache

    return serve
