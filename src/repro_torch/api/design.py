# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Designs: what the solver asks of the data, the counterpart of
``repro/api/design.py``. A design answers ``margins(beta)`` (X @ beta),
``correlation(v)`` (X^T v), ``gram_tile(w, r, start, width)`` and
``shape``/``layout``, on the original feature axis.

* :class:`DenseDesign` -- a dense (n, p) tensor;
* :class:`SlabDesign` -- by-feature (p, DP, K) slabs with local row
  indices (sentinel n_loc), the paper's Table-1 layout;
* :class:`ShardedDesign` -- a design on a (1, M) mesh
  (``repro_torch.launch.mesh``): the M feature blocks of the by-feature
  solve; it answers ``shape``/``layout`` and ``margins`` (through
  ``core.distributed.make_slab_margins``);
* :func:`as_design` -- coerces arrays, :class:`ByFeature` and raw
  ``(row_idx, values)`` slabs into designs.

The bucketed layout (``SlabBuckets``), the active-set gather/scatter and
mesh residency come with the path, residency and multi-GPU slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.byfeature import ByFeature, to_slabs


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

    def to(self, device) -> "DenseDesign":
        return DenseDesign(self.X.to(device=device, dtype=torch.float32))


# ---------------------------------------------------------------------------
# SlabDesign
# ---------------------------------------------------------------------------

def _slab_front_packed(row_idx, n_loc: int) -> bool:
    """Whether every slab's K axis is front-packed (live slots first). A
    one-off host read at the entry point, counted by the engine."""
    from repro_torch.core import engine

    valid = row_idx < n_loc
    return bool(engine.host_read(torch.all(valid[..., 1:] <= valid[..., :-1])))


@dataclass(eq=False)
class SlabDesign:
    """By-feature (p, DP, K) slabs with local row indices (sentinel
    ``n_loc``), the paper's Table-1 layout keyed for DP example shards;
    DP = 1 is the plain by-feature form."""

    row_idx: torch.Tensor        # (p, DP, K) int32
    values: torch.Tensor         # (p, DP, K) float32
    n: int                       # global example count (= DP * n_loc)
    front_packed: bool = True
    layout: ClassVar[str] = "slab"

    @classmethod
    def from_by_feature(cls, bf: ByFeature, dp: int = 1) -> "SlabDesign":
        row_idx, values, _ = to_slabs(bf, dp)
        return cls(row_idx, values, bf.n, front_packed=True)

    @classmethod
    def from_dense(cls, X, dp: int = 1) -> "SlabDesign":
        from repro_torch.data.byfeature import to_by_feature

        return cls.from_by_feature(to_by_feature(X), dp)

    @property
    def dp(self) -> int:
        return int(self.row_idx.shape[1])

    @property
    def n_loc(self) -> int:
        return self.n // max(self.dp, 1)

    @property
    def k(self) -> int:
        return int(self.row_idx.shape[2])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, int(self.row_idx.shape[0]))

    def to(self, device) -> "SlabDesign":
        return SlabDesign(self.row_idx.to(device=device, dtype=torch.int32),
                          self.values.to(device=device, dtype=torch.float32),
                          self.n, front_packed=self.front_packed)

    def _shard(self, v, s: int):
        return v[s * self.n_loc:(s + 1) * self.n_loc]

    def margins(self, beta):
        """X @ beta (n,), per example shard through ``kernels.slab_spmv``."""
        from repro_torch.kernels.ops import slab_spmv

        parts = [slab_spmv(self.row_idx[:, s], self.values[:, s], beta,
                           n_loc=self.n_loc)
                 for s in range(self.dp)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def correlation(self, v):
        """X^T v (p,), through ``kernels.slab_corr``, summed over shards."""
        from repro_torch.kernels.ops import slab_corr

        g = None
        for s in range(self.dp):
            gs = slab_corr(self.row_idx[:, s], self.values[:, s], self._shard(v, s))
            g = gs if g is None else g + gs
        return g

    def gram_tile(self, w, r, start: int, width: int):
        """(G, c) of features [start, start + width) through
        ``kernels.slab_gram``, summed over shards."""
        from repro_torch.kernels.ops import slab_gram

        G = c = None
        for s in range(self.dp):
            rows = self.row_idx[start:start + width, s]
            vals = self.values[start:start + width, s]
            Gs, cs = slab_gram(rows, vals, self._shard(w, s), self._shard(r, s))
            G = Gs if G is None else G + Gs
            c = cs if c is None else c + cs
        return G, c

    def k_per_feature(self) -> np.ndarray:
        """Host (p,) max live slots per feature over shards."""
        live = (self.row_idx < self.n_loc).sum(dim=-1).amax(dim=-1)
        return live.cpu().numpy()

    def densify(self):
        """Dense (n, p): per example shard the plain scatter of
        ``kernels.ref._densify_slab`` (the one definition of the sentinel
        and duplicate-row semantics), shards stacked in order. Cached: a
        local solve densifies once per design."""
        dense = getattr(self, "_dense_cache", None)
        if dense is None:
            from repro_torch.kernels.ref import _densify_slab

            parts = [_densify_slab(self.row_idx[:, s], self.values[:, s], self.n_loc)
                     for s in range(self.dp)]
            dense = parts[0] if len(parts) == 1 else torch.cat(parts)
            object.__setattr__(self, "_dense_cache", dense)
        return dense


# ---------------------------------------------------------------------------
# ShardedDesign
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class ShardedDesign:
    """A design on a (1, M) mesh: the M feature blocks of the by-feature
    solve run as one batch on the mesh's device. ``tile`` aligns the
    feature padding (to M * tile) with the solver's Gram tile; results do
    not depend on it. Margins of slab layouts go through
    ``core.distributed.make_slab_margins`` (one ``slab_spmv`` launch for
    all M blocks, summed over M in a fixed order)."""

    inner: object
    mesh: object                 # repro_torch.launch.mesh.DevMesh
    tile: int = 128

    def __post_init__(self):
        if isinstance(self.inner, ShardedDesign):
            raise TypeError("cannot wrap a ShardedDesign in a ShardedDesign")
        if "model" not in self.mesh.axis_names:
            raise ValueError(
                f"mesh axes {self.mesh.axis_names} lack the 'model' axis the "
                f"feature blocks map onto -- build meshes with "
                f"repro_torch.launch.mesh.make_dev_mesh")

    @property
    def layout(self) -> str:
        return self.inner.layout

    @property
    def shape(self) -> Tuple[int, int]:
        return self.inner.shape

    @property
    def mdim(self) -> int:
        return self.mesh.shape["model"]

    def to(self, device) -> "ShardedDesign":
        return ShardedDesign(self.inner.to(device), self.mesh, tile=self.tile)

    def margins(self, beta):
        if self.layout == "dense":
            return self.inner.margins(beta)
        from repro_torch.core.distributed import (
            check_slab_shapes, make_slab_margins, pad_features)

        n, p = self.shape
        n_loc = check_slab_shapes(self.inner.row_idx, self.inner.values, self.mesh, n)
        rows, vals, beta, _ = pad_features(self.inner.row_idx, self.inner.values,
                                           beta, n_loc, self.mdim * self.tile)
        return make_slab_margins(self.mesh, n_loc)(rows, vals, beta)


# ---------------------------------------------------------------------------
# coercion
# ---------------------------------------------------------------------------

_DESIGN_TYPES = (DenseDesign, SlabDesign, ShardedDesign)


def as_design(data, *, n: Optional[int] = None, mesh=None,
              tile: int = 128):
    """Coerce an entry-point operand into a design.

    ``data`` may be a design (passed through), a dense (n, p) array or
    tensor, a :class:`ByFeature`, or a raw ``(row_idx, values)`` slab pair
    (front-packing is detected, so hand-built slabs may interleave
    sentinel and live slots). ``n`` is required for the raw pair. With
    ``mesh``, the result is wrapped in a :class:`ShardedDesign`. The
    bucketed ``SlabBuckets`` layout is not ported yet.
    """
    if isinstance(data, _DESIGN_TYPES):
        d = data
    elif isinstance(data, ByFeature):
        if n is not None and data.n != n:
            raise ValueError(f"ByFeature has n={data.n} but len(y)={n}")
        d = SlabDesign.from_by_feature(data, 1)
    elif type(data).__name__ == "SlabBuckets":
        raise TypeError(
            "SlabBuckets (the nnz-bucketed slab layout) is not ported yet "
            "(ROADMAP queue 1, items 8 and 10): pass flat (row_idx, values) "
            "slabs, a ByFeature or a SlabDesign")
    elif isinstance(data, tuple) and len(data) == 2:
        row_idx, values = (torch.as_tensor(a) for a in data)
        if n is None:
            raise ValueError("raw (row_idx, values) slabs need n= (len(y))")
        if mesh is not None:
            n_loc = n
        else:
            dp = int(row_idx.shape[1]) if row_idx.dim() == 3 else 1
            n_loc = n // max(dp, 1)
        if row_idx.dim() == 2:
            row_idx = row_idx[:, None, :]
            values = values[:, None, :]
        d = SlabDesign(row_idx.to(torch.int32), values.to(torch.float32), n,
                       front_packed=_slab_front_packed(row_idx, n_loc))
    elif hasattr(data, "ndim") and data.ndim == 2:
        d = DenseDesign(torch.as_tensor(data, dtype=torch.float32))
    else:
        raise TypeError(
            f"cannot build a design from {type(data).__name__}: expected a "
            f"dense (n, p) array, ByFeature, (row_idx, values) slabs, or a "
            f"design")
    if mesh is not None and not isinstance(d, ShardedDesign):
        d = ShardedDesign(d, mesh, tile=tile)
    return d
