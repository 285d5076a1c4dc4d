# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Regularization path (paper Algorithm 5): the historical entry points,
the counterpart of ``repro/core/regpath.py``. Both delegate to the front
door ``repro_torch.api.LogisticL1.path``, which owns the screened,
warm-started driver; they are held bit-identical to it."""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.api.types import PathPoint, PathResult  # noqa: F401  (re-export)
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.device import DEFAULT_DEVICE


def regularization_path(
    X,
    y,
    *,
    path_len: int = 20,
    opts: DGLMNETOptions = DGLMNETOptions(),
    eval_fn: Optional[Callable] = None,
    extra_lams: Optional[List[float]] = None,
    verbose: bool = False,
    screen: bool = True,
    kkt_tol: float = 1e-3,
    max_kkt_rounds: int = 8,
    carry_working_set: bool = True,
    violation_budget: Optional[int] = 512,
    device=DEFAULT_DEVICE,
) -> PathResult:
    """Single-device path over a dense X: ``LogisticL1(opts,
    device=device).path(DenseDesign(X), y, ...)``."""
    from repro_torch.api import DenseDesign, LogisticL1

    return LogisticL1(opts=opts, device=device).path(
        DenseDesign(X), y, path_len=path_len, eval_fn=eval_fn,
        extra_lams=extra_lams, verbose=verbose, screen=screen,
        kkt_tol=kkt_tol, max_kkt_rounds=max_kkt_rounds,
        carry_working_set=carry_working_set, violation_budget=violation_budget)


def regularization_path_distributed(
    data,
    y,
    mesh,
    *,
    path_len: int = 20,
    opts: DGLMNETOptions = DGLMNETOptions(),
    eval_fn: Optional[Callable] = None,
    extra_lams: Optional[List[float]] = None,
    verbose: bool = False,
    kkt_tol: float = 1e-3,
    max_kkt_rounds: int = 8,
    carry_working_set: bool = True,
    violation_budget: Optional[int] = 512,
) -> PathResult:
    """The screened path with every restricted solve on ``mesh`` (on the
    mesh's device): ``data`` is a dense (n, p) X, a ``ByFeature``, a raw
    ``(row_idx, values)`` slab pair or ``SlabBuckets``, coerced by
    ``repro_torch.api.as_design``."""
    from repro_torch.api import LogisticL1, as_design

    design = as_design(data, n=int(len(y)), mesh=mesh, tile=opts.tile)
    return LogisticL1(opts=opts, mesh=mesh, device=mesh.device).path(
        design, y, path_len=path_len, eval_fn=eval_fn,
        extra_lams=extra_lams, verbose=verbose, screen=True,
        kkt_tol=kkt_tol, max_kkt_rounds=max_kkt_rounds,
        carry_working_set=carry_working_set, violation_budget=violation_budget)
