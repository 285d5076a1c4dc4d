# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Path result types, the counterpart of ``repro/api/types.py``:
:class:`PathPoint` (one lambda) and :class:`PathResult` (the path, its
coefficients stacked into one (L, p) tensor), with
:meth:`PathResult.save` / :meth:`PathResult.load` in the reference's
checkpoint format, so a path saved by either package serves from the
other (fit once, serve many)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


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

    # -- persistence (fit once, serve many) ---------------------------------

    def save(self, directory: str) -> str:
        """Persist through ``checkpoint.save_pytree``: the stacked betas as
        the array payload (leaf ``['betas']``), everything else (lambdas,
        per-lambda scalars, metric and telemetry dicts) in the manifest's
        JSON meta, so a serving process can load the path without the
        training code or data. The files are the reference's."""
        from repro_torch.checkpoint import save_pytree

        meta = {
            "kind": "PathResult",
            "lambdas": [float(v) for v in self.lambdas],
            "nnz": [int(v) for v in self.nnz],
            "f": [float(v) for v in self.f],
            "n_iters": [int(v) for v in self.n_iters],
            "metrics": [_jsonable(d) for d in self.metrics],
            "screen": [_jsonable(d) for d in self.screen],
            "status": [int(v) for v in self.statuses],
            "p": int(self.betas.shape[1]) if self.betas.dim() == 2 else 0,
            "dtype": str(self.betas.dtype).replace("torch.", ""),
        }
        return save_pytree({"betas": self.betas}, directory, meta=meta)

    @classmethod
    def load(cls, directory: str, *, device=DEFAULT_DEVICE) -> "PathResult":
        """Inverse of :meth:`save` (and of the reference's
        ``PathResult.save``): the stacked betas land on ``device``
        (default ``"cuda"``, raising without a card)."""
        from repro_torch.checkpoint import load_pytree, read_meta

        dev = resolve_device(device)
        meta = read_meta(directory)
        if meta is None or meta.get("kind") != "PathResult":
            raise ValueError(
                f"{directory} is not a PathResult checkpoint (missing or "
                f"mismatched manifest meta)")
        like = {"betas": torch.empty((len(meta["lambdas"]), meta["p"]),
                                     dtype=getattr(torch, meta["dtype"]))}
        tree = load_pytree(directory, like, device=dev)
        return cls(
            lambdas=np.asarray(meta["lambdas"], np.float64),
            betas=tree["betas"],
            nnz=np.asarray(meta["nnz"], np.int64),
            f=np.asarray(meta["f"], np.float64),
            n_iters=np.asarray(meta["n_iters"], np.int64),
            metrics=list(meta["metrics"]),
            screen=list(meta["screen"]),
            # checkpoints without statuses load as status=None (all OK)
            status=(np.asarray(meta["status"], np.int64) if "status" in meta else None),
        )


def _jsonable(d: Optional[dict]) -> dict:
    """Per-lambda dicts hold numpy and tensor scalars: coerce them for JSON."""
    out = {}
    for k, v in (d or {}).items():
        if torch.is_tensor(v) and v.dim() == 0:
            # allow[torch-host-sync]: JSON coercion of a saved path's telemetry, after the path, not on a solve's path
            v = v.item()
        if isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out
