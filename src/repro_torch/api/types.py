# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Path result types, the counterpart of ``repro/api/types.py``:
:class:`PathPoint` (one lambda) and :class:`PathResult` (the path, its
coefficients stacked into one (L, p) tensor). Persistence
(``PathResult.save``/``load``) comes with the checkpoint slice."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class PathPoint:
    """One regularization-path point (paper Algorithm 5)."""

    lam: float
    nnz: int
    f: float
    n_iters: int
    beta: torch.Tensor
    metrics: dict = field(default_factory=dict)
    screen: dict = field(default_factory=dict)   # active-set telemetry
    # engine.STATUS_* code of the solve behind the point (0 = OK; non-OK
    # points carry the driver's degraded/skip decision in ``screen``)
    status: int = 0

    @property
    def ok(self) -> bool:
        return self.status == 0


@dataclass
class PathResult:
    """The certified regularization path: the coefficients as one stacked
    ``(L, p)`` tensor, per-lambda scalars as numpy arrays, and the
    per-lambda metric and telemetry dicts. Iterating, ``len`` and integer
    or slice indexing give :class:`PathPoint` views."""

    lambdas: np.ndarray          # (L,) descending lambda grid
    betas: torch.Tensor          # (L, p) stacked coefficients
    nnz: np.ndarray              # (L,) int64
    f: np.ndarray                # (L,) float64 objective values
    n_iters: np.ndarray          # (L,) int64
    metrics: List[dict] = field(default_factory=list)
    screen: List[dict] = field(default_factory=list)
    status: Optional[np.ndarray] = None          # (L,) int64; None = all OK

    @property
    def statuses(self) -> np.ndarray:
        """Per-point status codes (all OK when ``status`` is None)."""
        if self.status is None:
            return np.zeros(len(self), np.int64)
        return self.status

    @property
    def all_ok(self) -> bool:
        return bool(np.all(self.statuses == 0))

    @classmethod
    def from_points(cls, points: Sequence[PathPoint]) -> "PathResult":
        """Stack a list of per-lambda points into one result."""
        pts = list(points)
        return cls(
            lambdas=np.asarray([p.lam for p in pts], np.float64),
            betas=(torch.stack([p.beta for p in pts]) if pts
                   else torch.zeros((0, 0), dtype=torch.float32)),
            nnz=np.asarray([p.nnz for p in pts], np.int64),
            f=np.asarray([p.f for p in pts], np.float64),
            n_iters=np.asarray([p.n_iters for p in pts], np.int64),
            metrics=[dict(p.metrics) for p in pts],
            screen=[dict(p.screen) for p in pts],
            status=np.asarray([p.status for p in pts], np.int64),
        )

    def __len__(self) -> int:
        return int(self.lambdas.shape[0])

    def point(self, i: int) -> PathPoint:
        """The ``i``-th point as a :class:`PathPoint` view (its beta is a
        row of the stacked tensor)."""
        return PathPoint(
            lam=float(self.lambdas[i]), nnz=int(self.nnz[i]),
            f=float(self.f[i]), n_iters=int(self.n_iters[i]),
            beta=self.betas[i],
            metrics=self.metrics[i] if self.metrics else {},
            screen=self.screen[i] if self.screen else {},
            status=int(self.statuses[i]),
        )

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.point(j) for j in range(len(self))[i]]
        n = len(self)
        if i < -n or i >= n:
            raise IndexError(f"path index {i} out of range for {n} points")
        return self.point(i % n)

    def __iter__(self) -> Iterator[PathPoint]:
        for i in range(len(self)):
            yield self.point(i)

    def index_of(self, lam: float) -> int:
        """The index of the stored lambda nearest to ``lam`` in log space
        (the grid is geometric)."""
        if len(self) == 0:
            raise ValueError("empty path")
        lams = np.maximum(np.asarray(self.lambdas, np.float64), 1e-300)
        return int(np.argmin(np.abs(np.log(lams) - np.log(max(lam, 1e-300)))))

    def save(self, directory: str) -> str:
        raise NotImplementedError(
            "PathResult.save is not ported yet (ROADMAP queue 1 item 5)")

    @classmethod
    def load(cls, directory: str, **kw) -> "PathResult":
        raise NotImplementedError(
            "PathResult.load is not ported yet (ROADMAP queue 1 item 5)")
