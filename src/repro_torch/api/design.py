# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Designs: what the solver asks of the data, the counterpart of
``repro/api/design.py``. Only :class:`DenseDesign` is ported; the slab,
bucketed and sharded layouts come with the sparse and multi-GPU slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Tuple

import torch


@dataclass(eq=False)
class DenseDesign:
    """Dense (n, p) design matrix -- the paper's epsilon/gisette regime."""

    X: torch.Tensor
    layout: ClassVar[str] = "dense"

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(self.X.shape[0]), int(self.X.shape[1]))

    def margins(self, beta):
        return self.X @ beta

    def correlation(self, v):
        return self.X.T @ v

    def gram_tile(self, w, r, start: int, width: int):
        Xf = self.X[:, start:start + width]
        wXf = w[:, None] * Xf
        return Xf.T @ wXf, wXf.T @ r
