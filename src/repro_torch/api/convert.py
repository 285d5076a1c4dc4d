# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Carry state from the JAX package into the port.

The reference's fitted coefficients arrive as a numpy array (the tests
pass ``np.asarray(jax_estimator.beta_)``); :func:`from_reference`
turns them into the port's estimator state, so a port estimator scores
and warm-starts from a JAX solution::

    est = LogisticL1(opts, device="cuda", **from_reference(beta, lam, device="cuda"))

:func:`lm_params_from_reference` loads an LM's reference parameter tree
(as numpy arrays: ``jax.tree.map(np.asarray, init_params(key, cfg))``)
into the port's model, unstacking each segment's leading layer axis.

:func:`path_from_reference` turns the reference's ``PathResult`` (its
arrays read as numpy) into the port's, so the two paths can be set side
by side, point by point.
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


def path_from_reference(ref, *, device=DEFAULT_DEVICE):
    """The port's :class:`~repro_torch.api.types.PathResult` holding the
    reference's: stacked betas on ``device``, per-lambda scalars, metric
    and telemetry dicts and statuses."""
    from repro_torch.api.types import PathResult

    def scalars(d):
        # allow[torch-host-sync]: a numpy scalar of the reference's telemetry, not a tensor
        return {k: (v.item() if isinstance(v, np.generic) else v) for k, v in d.items()}

    status = getattr(ref, "status", None)
    return PathResult(
        lambdas=np.asarray(ref.lambdas, np.float64),
        betas=torch.tensor(np.asarray(ref.betas, np.float32), device=resolve_device(device)),
        nnz=np.asarray(ref.nnz, np.int64),
        f=np.asarray(ref.f, np.float64),
        n_iters=np.asarray(ref.n_iters, np.int64),
        metrics=[scalars(d) for d in ref.metrics],
        screen=[scalars(d) for d in ref.screen],
        status=None if status is None else np.asarray(status, np.int64),
    )


def _as_tensor(a) -> torch.Tensor:
    a = np.array(a)                          # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_reference(params, cfg, *, device=DEFAULT_DEVICE):
    """The port's LM (``models.transformer.LM``) holding the reference's
    weights: ``params["segments"][i][...][j]`` becomes layer j of segment
    i; every other leaf maps by name. Raises on a missing, extra or
    mis-shaped leaf."""
    from repro_torch.models.transformer import LM

    lm = LM(cfg, None, device=resolve_device(device))
    used = 0
    with torch.no_grad():
        for name, p in lm.named_parameters():
            parts = name.split(".")
            node, layer = params, None
            if parts[0] == "segments":
                node, layer, parts = params["segments"][int(parts[1])], int(parts[2]), parts[3:]
            for key in parts:
                node = node[key]
            t = _as_tensor(node if layer is None else np.asarray(node)[layer])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {tuple(t.shape)}, "
                                 f"port shape {tuple(p.shape)}")
            p.copy_(t)
            used += 1

    def leaves(tree):
        if isinstance(tree, dict):
            return sum(leaves(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(leaves(v) for v in tree)
        return 1

    n_ref = leaves({k: v for k, v in params.items() if k != "segments"})
    n_ref += sum(leaves(seg) * len(lm.segments[i]) for i, seg in enumerate(params["segments"]))
    if n_ref != used:
        raise ValueError(f"the reference tree has {n_ref} per-layer leaves, the port {used}")
    return lm
