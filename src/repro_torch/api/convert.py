# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Carry a fitted state from the JAX package into the port.

The reference's fitted coefficients arrive as a numpy array (the tests
pass ``np.asarray(jax_estimator.beta_)``); :func:`from_reference`
turns them into the port's estimator state, so a port estimator scores
and warm-starts from a JAX solution::

    est = LogisticL1(opts, device="cuda", **from_reference(beta, lam, device="cuda"))
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def from_reference(beta: np.ndarray, lam: float, *, device=DEFAULT_DEVICE) -> dict:
    """``{"beta_": (p,) float32 tensor on device, "lam_": float}``."""
    beta = np.asarray(beta, dtype=np.float32)
    if beta.ndim != 1:
        raise ValueError(f"beta must be (p,), got shape {beta.shape}")
    return {"beta_": torch.tensor(beta, device=resolve_device(device)),
            "lam_": float(lam)}
