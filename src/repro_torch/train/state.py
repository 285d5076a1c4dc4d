# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Training state container and constructors (counterpart of
``repro/train/state.py``).

A state is ``{"params": LM, "opt": optimizer state, "step": int32 tensor}``
on one device, the model's weights trainable. The optimizer sees the
weights through :func:`param_tree`: the reference's tree, each segment's
weight a :class:`~repro_torch.optim.Stacked` of its layers' tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.params import init_params
from repro_torch.optim import Stacked, make_optimizer


def param_tree(lm) -> dict:
    """The model's weights in the reference's tree: ``embed``,
    ``final_norm``, ``lm_head``, ``segments[i][name...]``, the last a
    :class:`Stacked` of layer j's tensor for each j of segment i, and the
    MTP head's ``mtp["proj"]`` and ``mtp["layer"][name...]``, each of the
    latter a :class:`Stacked` of its one layer (the reference's (1, ...)
    leaves)."""
    tree: dict = {}
    segments = [{} for _ in lm.segments]
    for name, p in lm.named_parameters():
        parts = name.split(".")
        if parts[0] == "segments":
            node, parts, stacked = segments[int(parts[1])], parts[3:], True
        else:
            node, stacked = tree, parts[:2] == ["mtp", "layer"]
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        if stacked:
            node.setdefault(parts[-1], []).append(p)
        else:
            node[parts[-1]] = p

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return Stacked(node)

    tree["segments"] = [stack(seg) for seg in segments]
    if "mtp" in tree:
        tree["mtp"]["layer"] = stack(tree["mtp"]["layer"])
    return tree


def make_train_state(gen, cfg: ModelConfig, *, device=DEFAULT_DEVICE) -> dict:
    """Weights drawn from ``gen`` (a torch.Generator on ``device``; None
    allocates without drawing), made trainable, with the config's
    optimizer's state and a zero step counter."""
    dev = resolve_device(device)
    params = init_params(gen, cfg, device=dev)
    params.requires_grad_(True)
    opt = make_optimizer(cfg.optimizer)
    return {
        "params": params,
        "opt": opt.init(param_tree(params)),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def train_state_shapes(cfg: ModelConfig) -> dict:
    """The full train state on the ``meta`` device (no allocation)."""
    return make_train_state(None, cfg, device="meta")
