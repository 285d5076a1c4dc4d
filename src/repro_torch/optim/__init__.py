# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Optimizers and LR schedules of the port (counterpart of ``repro.optim``)."""
from repro_torch.optim.optimizers import (Optimizer, Stacked, adafactor, adamw,
                                          apply_updates, clip_by_global_norm, make_optimizer,
                                          sgd)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["Optimizer", "Stacked", "adafactor", "adamw", "apply_updates",
           "clip_by_global_norm", "constant", "make_optimizer", "sgd", "warmup_cosine"]
