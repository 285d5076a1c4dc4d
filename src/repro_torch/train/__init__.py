# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Counterpart of ``repro.train``: the GLM path's evaluation metrics
(:mod:`repro_torch.train.metrics`) and the LM zoo's training state and
steps (train, prefill and decode).

As in the reference, importing this package does not load the LM zoo:
the state and the steps resolve on first use (PEP 562), so ``import
repro_torch.train.metrics`` stays zoo-free."""
from importlib import import_module

from repro_torch.train.metrics import accuracy, auprc, glm_eval_fn, log_loss

_LAZY = {
    "make_train_state": "repro_torch.train.state",
    "train_state_shapes": "repro_torch.train.state",
    "IGNORE": "repro_torch.train.train_step",
    "cross_entropy": "repro_torch.train.train_step",
    "make_loss_fn": "repro_torch.train.train_step",
    "make_prefill_step": "repro_torch.train.train_step",
    "make_serve_step": "repro_torch.train.train_step",
    "make_train_step": "repro_torch.train.train_step",
}

__all__ = sorted(["accuracy", "auprc", "glm_eval_fn", "log_loss", *_LAZY])


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
