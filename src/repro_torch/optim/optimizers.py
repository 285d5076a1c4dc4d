# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Hand-rolled optimizers, the counterpart of ``repro/optim/optimizers.py``
(no ``torch.optim``: its AdamW keeps its moments in the parameter's type,
takes its bias corrections from a host counter and adds an unrounded
update). The same API::

    opt = adamw(...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

A tree is nested dicts, lists and tuples whose leaves are tensors, in the
reference's flattening order (dict keys sorted). The reference stacks a
segment's layers on a leading axis, one array per weight name; the port
keeps one tensor per layer. A :class:`Stacked` holds those per-layer
tensors and is one leaf of the reference's tree, of shape (L, *shape):

* ``sgd`` and ``adamw`` are elementwise, so they update each layer's
  tensor on its own (their state holds a :class:`Stacked` of per-layer
  moments, unstacked as the weights are);
* ``adafactor`` factors every leaf of two or more dims over its last two
  and clips the update's RMS over the whole leaf. On a :class:`Stacked`
  leaf it stacks the layers' gradients (and weights) into the
  reference's (L, *shape) tensor for that: a stack of (d,) RMSNorm scales
  is an (L, d) leaf whose column statistics run across layers, and the
  RMS runs over all L layers at once. Its accumulators stay stacked,
  exactly the reference's arrays.

State is float32 where the reference's is; the step counter is an int32
tensor on the parameters' device, and ``lr`` a float32 tensor there (or a
float), so an update reads nothing back to the host. ``update`` writes the
new moments into the state's tensors in place and returns that state: a
step then holds one copy of the moments, not two.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, state)


class Stacked(tuple):
    """One leaf of the reference's tree held as its L per-layer tensors."""

    @property
    def shape(self):
        return (len(self),) + tuple(self[0].shape)

    def stack(self) -> torch.Tensor:
        return torch.stack(tuple(self))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The reference's leaves in its order; a :class:`Stacked` is one leaf."""
    if isinstance(tree, Stacked) or torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the reference's leaves of ``tree``, in its order, and the
    trees of the same structure in ``rest``."""
    if isinstance(tree, Stacked) or torch.is_tensor(tree) or not isinstance(
            tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return type(tree)(tree_map(fn, sub, *(r[i] for r in rest)) for i, sub in enumerate(tree))


def tensors(tree) -> list:
    """Every tensor of ``tree``, a :class:`Stacked` leaf's layers in order."""
    return [t for leaf in tree_leaves(tree)
            for t in (leaf if isinstance(leaf, Stacked) else (leaf,))]


def tree_unflatten(like, flat):
    """``like``'s structure over the tensors of ``flat`` (in the order
    :func:`tensors` lists them)."""
    it = iter(flat)

    def take(leaf):
        if isinstance(leaf, Stacked):
            return Stacked(next(it) for _ in leaf)
        return next(it)

    return tree_map(take, like)


def _per_layer(fn):
    """Lift an elementwise leaf function over the layers of a Stacked leaf."""
    def lifted(leaf, *rest):
        if isinstance(leaf, Stacked):
            return Stacked(fn(*xs) for xs in zip(leaf, *rest))
        return fn(leaf, *rest)
    return lifted


def _zeros(dtype):
    return _per_layer(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device))


def apply_updates(params, updates):
    """``p + u`` with ``u`` cast to ``p``'s type first, as the reference
    adds it, written into the parameters' storage (without autograd);
    returns ``params``."""
    with torch.no_grad():
        for p, u in zip(tensors(params), tensors(updates)):
            p.add_(u.to(p.dtype))
    return params


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), the float32
    global norm). As in the reference, the scale is a float32 tensor, so
    a bfloat16 gradient comes back float32."""
    gnorm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in tensors(grads)))
    scale = (max_norm / (gnorm + 1e-9)).clamp(max=1.0)
    return tree_map(_per_layer(lambda g: g.to(torch.promote_types(g.dtype, torch.float32))
                               * scale), grads), gnorm


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------

def sgd(momentum: float = 0.9, weight_decay: float = 0.0, state_dtype=torch.float32):
    def init(params):
        return {"mu": tree_map(_zeros(state_dtype), params)}

    def update(grads, state, params, lr):
        def leaf(m, g, p):
            m.mul_(momentum).add_(g.to(state_dtype))
            return -lr * (m + weight_decay * p.to(state_dtype))

        upd = tree_map(_per_layer(leaf), state["mu"], grads, params)
        return upd, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype=torch.float32,
):
    def init(params):
        leaves = tensors(params)
        return {
            "m": tree_map(_zeros(state_dtype), params),
            "v": tree_map(_zeros(state_dtype), params),
            "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        }

    def update(grads, state, params, lr):
        c = state["count"].add_(1)
        cf = c.to(torch.float32)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf

        def leaf(m, v, g, p):
            g = g.to(state_dtype)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return -lr * (step + weight_decay * p.to(state_dtype))

        upd = tree_map(_per_layer(leaf), state["m"], state["v"], grads, params)
        return upd, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------

def adafactor(
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """Shazeer & Stern (2018), simplified: factored for >=2D leaves over the
    last two dims; full accumulator for 0/1-D leaves. A :class:`Stacked`
    leaf is the reference's stacked (L, *shape) leaf (module docstring)."""

    def _factored(shape):
        return len(shape) >= 2

    def _whole(leaf):
        return leaf.stack() if isinstance(leaf, Stacked) else leaf

    def init(params):
        def per_leaf(p):
            shape = tuple(p.shape)
            dev = p[0].device if isinstance(p, Stacked) else p.device
            z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
            if _factored(shape):
                return {"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
            return {"v": z(shape)}

        leaves = tensors(params)
        return {
            "acc": tree_map(per_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        }

    def update(grads, state, params, lr):
        def per_leaf(g_leaf, acc, p_leaf):
            g = _whole(g_leaf).to(torch.float32)
            g2 = g.square() + eps
            if _factored(g.shape):
                vr = acc["vr"].mul_(decay).add_((1 - decay) * g2.mean(-1))
                vc = acc["vc"].mul_(decay).add_((1 - decay) * g2.mean(-2))
                denom = (vr[..., :, None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
                upd = g * torch.rsqrt(denom + eps)
            else:
                v = acc["v"].mul_(decay).add_((1 - decay) * g2)
                upd = g * torch.rsqrt(v + eps)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(upd.square().mean() + 1e-12)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            upd = -lr * (upd + weight_decay * _whole(p_leaf).to(torch.float32))
            return Stacked(upd.unbind(0)) if isinstance(g_leaf, Stacked) else upd

        upd = tree_map(per_leaf, grads, state["acc"], params)
        state["count"].add_(1)
        return upd, state

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(**kw)
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
