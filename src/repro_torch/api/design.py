# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Designs: what the solver asks of the data, the counterpart of
``repro/api/design.py``. A design answers ``margins(beta)`` (X @ beta),
``correlation(v)`` (X^T v), ``gram_tile(w, r, start, width)``,
``gather(beta, mask, cap)`` / ``scatter(beta_sub, idx)`` (the screened
path's working-set restriction and its inverse) and ``shape``/``layout``,
all on the original feature axis.

* :class:`DenseDesign` -- a dense (n, p) tensor;
* :class:`SlabDesign` -- by-feature (p, DP, K) slabs with local row
  indices (sentinel n_loc), the paper's Table-1 layout;
* :class:`BucketedSlabDesign` -- the nnz-bucketed slabs
  (:class:`~repro_torch.data.byfeature.SlabBuckets`);
* :class:`ShardedDesign` -- a design on a (1, M) mesh
  (``repro_torch.launch.mesh``): the M feature blocks of the by-feature
  solve. Slab layouts live there as mesh-padded work buckets
  (``data.residency``): on the device once, or, under a
  ``device_budget_bytes`` below their bytes, streamed from pinned host
  memory through every pass; margins, correlation and the path's screen
  and gathers run per bucket;
* :class:`Design` -- the protocol every layout above satisfies;
* :func:`as_design` -- coerces arrays, :class:`ByFeature`,
  ``SlabBuckets`` and raw ``(row_idx, values)`` slabs into designs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core.screening import (gather_columns, pack_indices, scatter_columns,
                                        scatter_set, take_fill)
from repro_torch.data.byfeature import (ByFeature, SlabBuckets, gather_features,
                                        gather_features_buckets, scatter_features,
                                        take_buckets_iter, take_features_buckets, to_slabs)
from repro_torch.data.residency import BucketResidencyManager


def _on(t, device) -> bool:
    """Whether ``t`` lies on ``device`` ("cuda" names the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return t.device.type == "cuda" and t.device.index == torch.cuda.current_device()
    return t.device == dev


@runtime_checkable
class Design(Protocol):
    """What every data layout answers (see the module docstring); the
    counterpart of ``repro.api.Design``."""

    layout: str

    @property
    def shape(self) -> Tuple[int, int]: ...          # (n, p)

    def margins(self, beta): ...                     # X @ beta -> (n,)

    def correlation(self, v): ...                    # X^T v -> (p,)

    def gram_tile(self, w, r, start: int, width: int): ...  # (G, c)

    def gather(self, beta, mask, cap: int, *, k_cap: Optional[int] = None):
        ...                                          # (sub design, beta_sub, idx)

    def scatter(self, beta_sub, idx): ...            # -> full beta (p,)


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

    def gather(self, beta, mask, cap: int, *, k_cap: Optional[int] = None):
        X_sub, beta_sub, idx = gather_columns(self.X, beta, mask, cap)
        return DenseDesign(X_sub), beta_sub, idx

    def scatter(self, beta_sub, idx):
        return scatter_columns(beta_sub, idx, self.shape[1])

    def to(self, device) -> "DenseDesign":
        if torch.is_tensor(self.X) and _on(self.X, device) and self.X.dtype == torch.float32:
            return self
        return DenseDesign(torch.as_tensor(self.X).to(device=device, dtype=torch.float32))


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
        if (_on(self.row_idx, device) and self.row_idx.dtype == torch.int32
                and self.values.dtype == torch.float32):
            return self
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

    def gather(self, beta, mask, cap: int, *, k_cap: Optional[int] = None):
        rows_sub, vals_sub, beta_sub, idx = gather_features(
            self.row_idx, self.values, beta, mask, cap, sentinel=self.n_loc, k_cap=k_cap)
        sub = SlabDesign(rows_sub, vals_sub, self.n, front_packed=self.front_packed)
        return sub, beta_sub, idx

    def scatter(self, beta_sub, idx):
        return scatter_features(beta_sub, idx, self.shape[1])

    def k_per_feature(self) -> np.ndarray:
        """Host (p,) max live slots per feature over shards."""
        live = (self.row_idx < self.n_loc).sum(dim=-1).amax(dim=-1)
        # allow[torch-host-sync]: host bookkeeping of the K classes for the layout tests; no solve calls it
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
# BucketedSlabDesign
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class BucketedSlabDesign:
    """nnz-bucketed slab layout (:class:`SlabBuckets`): features grouped
    into power-of-two K classes, storage about O(nnz). Public methods speak
    the original feature order; the bucket permutation is private."""

    slabs: SlabBuckets
    n: int
    front_packed: bool = True
    layout: ClassVar[str] = "bucketed"

    @classmethod
    def from_by_feature(cls, bf: ByFeature, dp: int = 1, **kw) -> "BucketedSlabDesign":
        from repro_torch.data.byfeature import to_slab_buckets

        return cls(to_slab_buckets(bf, dp, **kw), bf.n, front_packed=True)

    @property
    def dp(self) -> int:
        return int(self.slabs.buckets[0][0].shape[1])

    @property
    def n_loc(self) -> int:
        return self.slabs.n_loc

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.slabs.p)

    @property
    def device(self) -> torch.device:
        return self.slabs.buckets[0][0].device

    @property
    def feat_order(self) -> np.ndarray:
        return self.slabs.feat_order

    @property
    def inv_perm(self) -> np.ndarray:
        inv = np.empty(self.slabs.p, np.int64)
        inv[self.feat_order] = np.arange(self.slabs.p)
        return inv

    def _perm(self):
        """(feat_order, inv_perm) as int64 tensors on the slabs' device,
        made once."""
        perm = getattr(self, "_perm_cache", None)
        if perm is None:
            perm = tuple(torch.from_numpy(a).to(self.device)
                         for a in (self.feat_order, self.inv_perm))
            object.__setattr__(self, "_perm_cache", perm)
        return perm

    def to(self, device) -> "BucketedSlabDesign":
        if all(_on(r, device) and r.dtype == torch.int32 and v.dtype == torch.float32
               for r, v, _ in self.slabs.buckets):
            return self
        buckets = tuple((r.to(device=device, dtype=torch.int32),
                         v.to(device=device, dtype=torch.float32), f)
                        for r, v, f in self.slabs.buckets)
        return BucketedSlabDesign(SlabBuckets(buckets, self.slabs.n_loc, self.slabs.p),
                                  self.n, front_packed=self.front_packed)

    def _flat(self) -> SlabDesign:
        """Work-order flat slab view at the largest K class (the bucket
        itself when there is one)."""
        flat = getattr(self, "_flat_cache", None)
        if flat is None:
            if len(self.slabs.buckets) == 1:
                r_b, v_b, _ = self.slabs.buckets[0]
            else:
                idx = torch.arange(self.slabs.p, device=self.device)
                r_b, v_b = take_features_buckets(self.slabs, idx, max(self.slabs.k_classes))
            flat = SlabDesign(r_b, v_b, self.n, front_packed=self.front_packed)
            object.__setattr__(self, "_flat_cache", flat)
        return flat

    def margins(self, beta):
        return self._flat().margins(beta[self._perm()[0]])

    def correlation(self, v):
        return self._flat().correlation(v)[self._perm()[1]]

    def gram_tile(self, w, r, start: int, width: int):
        idx = self._perm()[1][start:start + width]
        rows, vals = take_features_buckets(self.slabs, idx, max(self.slabs.k_classes))
        return SlabDesign(rows, vals, self.n).gram_tile(w, r, 0, width)

    def gather(self, beta, mask, cap: int, *, k_cap: Optional[int] = None):
        order = self._perm()[0]
        if k_cap is None:
            k_cap = max(self.slabs.k_classes)
        rows_sub, vals_sub, beta_sub, idx = gather_features_buckets(
            self.slabs, beta[order], mask[order], cap, k_cap)
        sub = SlabDesign(rows_sub, vals_sub, self.n, front_packed=self.front_packed)
        return sub, beta_sub, idx

    def scatter(self, beta_sub, idx):
        return scatter_features(beta_sub, idx, self.slabs.p)[self._perm()[1]]

    def k_per_feature(self) -> np.ndarray:
        """Host (p,) per-feature max live slots, in work (bucket) order."""
        # allow[torch-host-sync]: host bookkeeping of the K classes for the layout tests; no solve calls it
        parts = [(r_b < self.n_loc).sum(-1).amax(-1).cpu().numpy()
                 for r_b, _, _ in self.slabs.buckets]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def densify(self):
        """Dense (n, p) in the original feature order, cached."""
        dense = getattr(self, "_dense_cache", None)
        if dense is None:
            dense = self._flat().densify()[:, self._perm()[1]]
            object.__setattr__(self, "_dense_cache", dense)
        return dense


# ---------------------------------------------------------------------------
# ShardedDesign
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class _MeshSlabState:
    """Per-(design, tile) mesh residency: the padded work buckets (on the
    device, or streamed from the host under a budget) and the work-axis
    bookkeeping of the screened path, on the mesh's device. Built once,
    cached on the owning :class:`ShardedDesign`."""

    residency: BucketResidencyManager
    feat_map: torch.Tensor       # (p_work,) int64 original id per work position, sentinel p
    k_arr: torch.Tensor          # (p_work,) per-feature max live slots
    k_max: int
    p_work: int
    n_loc: int
    cap_tile: int
    max_row: torch.Tensor        # the buckets' largest row index (a device scalar)
    checked: bool = False        # max_row read and checked against n_loc

    def iter_buckets(self):
        """(row_idx, values, feat_idx) device buckets in work order."""
        return self.residency.iter_buckets()


@dataclass(eq=False)
class ShardedDesign:
    """A design on a (1, M) mesh: the M feature blocks of the by-feature
    solve run as one batch on the mesh's device. ``tile`` aligns the
    feature padding (to M * tile) with the solver's Gram tile; results do
    not depend on it.

    Slab layouts (flat or bucketed) live as mesh-padded work buckets
    (:meth:`_mesh_state`): margins go through
    ``core.distributed.make_slab_margins`` (one ``slab_spmv`` launch per
    bucket for all M blocks), correlation through
    ``core.screening.make_sparse_corr``. The buckets' largest row index is
    read and checked once per residency (one counted host read), or by
    the path driver together with lambda_max.

    ``device_budget_bytes`` caps the padded slab-bucket bytes resident on
    the device at once: below :meth:`slab_nbytes` the residency manager
    streams the buckets from pinned host memory through every pass
    instead of keeping them all resident (bit-identical results). With a
    budget the slabs stay on the host (:meth:`to` leaves them there); set
    it before the first residency build (:meth:`_mesh_state`)."""

    inner: object
    mesh: object                 # repro_torch.launch.mesh.DevMesh
    tile: int = 128
    device_budget_bytes: Optional[int] = None
    _states: dict = field(default_factory=dict, init=False, repr=False)

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

    @property
    def ddim(self) -> int:
        return self.mesh.shape["data"]

    def to(self, device) -> "ShardedDesign":
        if self.device_budget_bytes is not None and self.layout != "dense":
            # the residency manager places (or streams) the slabs itself
            return self
        inner = self.inner.to(device)
        if inner is self.inner:
            return self
        return ShardedDesign(inner, self.mesh, tile=self.tile,
                             device_budget_bytes=self.device_budget_bytes)

    # -- mesh residency (slab layouts) ------------------------------------

    def _as_buckets(self) -> SlabBuckets:
        n = self.shape[0]
        if isinstance(self.inner, SlabDesign):
            # a flat slab pair is a one-bucket layout
            p = self.inner.shape[1]
            fid = torch.arange(p, device=self.inner.row_idx.device)
            return SlabBuckets(buckets=((self.inner.row_idx, self.inner.values, fid),),
                               n_loc=n // max(self.ddim, 1), p=p)
        if isinstance(self.inner, BucketedSlabDesign):
            return self.inner.slabs
        raise TypeError(f"no slab form for layout {self.layout!r}")

    def _mesh_state(self, tile: Optional[int] = None) -> _MeshSlabState:
        from repro_torch.core.distributed import pad_features, slab_dims

        if tile is None:
            # public methods reuse whatever residency exists
            if self._states:
                return next(iter(self._states.values()))
            tile = self.tile
        st = self._states.get(tile)
        if st is not None:
            return st
        n, p = self.shape
        cap_tile = self.mdim * tile
        slabs = self._as_buckets()
        n_loc = slabs.n_loc
        budget = self.device_budget_bytes
        padded, feat_parts, k_parts, max_rows = [], [], [], []
        for r_b, v_b, fid in slabs.buckets:
            if slab_dims(r_b, v_b, self.mesh, n) != n_loc:
                raise ValueError("bucket n_loc inconsistent with mesh/n")
            if budget is not None:
                # the manager's sources live on the host: under a budget
                # the bookkeeping below is made there too, then moved
                # allow[torch-host-sync]: under a budget the buckets' sources live on the host (a card source is copied there once, when the residency is built, before any solve)
                r_b, v_b = r_b.cpu(), v_b.cpu()
            dev = r_b.device
            # pad each bucket to the mesh quantum: the screen and every
            # capacity stay mesh-aligned; all-sentinel slabs have zero
            # gradient and are never admitted
            r_b, v_b, _, pad_b = pad_features(r_b, v_b, None, n_loc, cap_tile)
            fid = (fid.to(device=dev, dtype=torch.int64) if torch.is_tensor(fid)
                   else torch.from_numpy(np.asarray(fid, np.int64)).to(dev, non_blocking=True))
            feat_parts.append(torch.cat([fid, fid.new_full((pad_b,), p)]))
            k_parts.append((r_b < n_loc).sum(-1).amax(-1))
            max_rows.append(r_b.max())
            padded.append((r_b, v_b, fid))
        mesh_dev = self.mesh.device

        def on_dev(t):
            return t.to(mesh_dev, non_blocking=True)

        st = _MeshSlabState(
            residency=BucketResidencyManager(tuple(padded), device=mesh_dev,
                                             budget_bytes=budget),
            feat_map=on_dev(torch.cat(feat_parts)),
            k_arr=on_dev(torch.cat(k_parts)),
            k_max=max(int(b[0].shape[-1]) for b in padded),
            p_work=sum(int(b[0].shape[0]) for b in padded),
            n_loc=n_loc,
            cap_tile=cap_tile,
            max_row=on_dev(torch.stack(max_rows).max()),
        )
        # mirror the manager's counters onto an active metrics registry (a
        # lazy callback; residency_stats() stays the source of truth)
        st.residency.register_metrics(name=f"residency.tile{st.cap_tile}")
        self._states[tile] = st
        return st

    def _check_rows(self, st: _MeshSlabState, max_row: int) -> None:
        """Check the buckets' largest row index (read by the caller)."""
        from repro_torch.core.distributed import check_rows

        check_rows(max_row, st.n_loc, self.shape[0], self.ddim)
        st.checked = True

    def _checked_state(self) -> _MeshSlabState:
        """The residency, its row bound read and checked on first use."""
        from repro_torch.core import engine

        st = self._mesh_state()
        if not st.checked:
            self._check_rows(st, int(engine.host_read(st.max_row)))
        return st

    def slab_bucket_nbytes(self, tile: Optional[int] = None) -> Tuple[int, ...]:
        """Per-bucket padded device bytes at ``tile`` alignment, from the
        shapes alone."""
        cap_tile = self.mdim * (self.tile if tile is None else tile)
        out = []
        for r_b, v_b, _ in self._as_buckets().buckets:
            p_b, dp, k_b = r_b.shape
            p_pad = p_b + (-p_b) % cap_tile
            out.append(p_pad * dp * k_b * (r_b.element_size() + v_b.element_size()))
        return tuple(out)

    def slab_nbytes(self, tile: Optional[int] = None) -> int:
        """Total padded slab bytes (the sum of :meth:`slab_bucket_nbytes`);
        a ``device_budget_bytes`` below this streams the buckets."""
        return sum(self.slab_bucket_nbytes(tile))

    def residency_stats(self) -> dict:
        """Per-tile residency counters of every built mesh state."""
        return {t: st.residency.stats() for t, st in self._states.items()}

    # -- Design protocol ---------------------------------------------------

    def margins(self, beta):
        if self.layout == "dense":
            return self.inner.margins(beta)
        from repro_torch.core.distributed import make_slab_margins

        st = self._checked_state()
        beta_work = take_fill(beta.to(torch.float32), st.feat_map, 0.0)
        margins = make_slab_margins(self.mesh, st.n_loc)
        m, off = None, 0
        for r_b, v_b, _ in st.iter_buckets():
            p_b = r_b.shape[0]
            m_b = margins(r_b, v_b, beta_work[off:off + p_b])
            m = m_b if m is None else m + m_b
            off += p_b
        return m

    def correlation(self, v):
        if self.layout == "dense":
            return self.inner.correlation(v)
        from repro_torch.core.screening import make_sparse_corr

        st = self._checked_state()
        corr = make_sparse_corr(self.mesh, st.n_loc, st.cap_tile // self.mdim)
        g_work = torch.cat([corr(r_b, v_b, v) for r_b, v_b, _ in st.iter_buckets()])
        return scatter_set(g_work, st.feat_map, self.shape[1])

    def gram_tile(self, w, r, start: int, width: int):
        return self.inner.gram_tile(w, r, start, width)

    # -- the work axis (estimator-internal) ---------------------------------
    #
    # The screened path runs in work (bucket-permuted, mesh-padded) order,
    # so every per-lambda pass is one screen per bucket with no order
    # conversion; these three are the estimator's bridge to it.

    def _screen_abs_work(self, y, m, tile: Optional[int] = None):
        """|X^T v(m, y)| in work order (p_work,), per bucket.

        ``tile`` (default: the design's own) must match the state the
        caller's masks live on."""
        from repro_torch.core.screening import make_sparse_screen

        st = self._mesh_state(tile)
        screen = make_sparse_screen(self.mesh, st.n_loc, st.cap_tile // self.mdim)
        return torch.cat([screen(r_b, v_b, y, m) for r_b, v_b, _ in st.iter_buckets()])

    def _gather_work(self, beta_work, mask_work, cap: int, k_cap: int,
                     tile: Optional[int] = None):
        """Work-order working-set gather into a flat restricted design of
        ``cap`` features at slab capacity ``k_cap``."""
        st = self._mesh_state(tile)
        idx = pack_indices(mask_work, cap)
        beta_sub = take_fill(beta_work, idx, 0.0)
        rows_sub, vals_sub = take_buckets_iter(st.iter_buckets(), st.n_loc, idx, k_cap)
        front = getattr(self.inner, "front_packed", True)
        sub = ShardedDesign(SlabDesign(rows_sub, vals_sub, self.shape[0], front_packed=front),
                            self.mesh, tile=self.tile if tile is None else tile)
        return sub, beta_sub, idx

    def _work_to_original(self, beta_work, tile: Optional[int] = None):
        """Work-order coefficients -> original feature ids (the mesh
        padding dropped)."""
        return scatter_set(beta_work, self._mesh_state(tile).feat_map, self.shape[1])

    def gather(self, beta, mask, cap: int, *, k_cap: Optional[int] = None):
        if self.layout == "dense":
            sub, beta_sub, idx = self.inner.gather(beta, mask, cap)
            return ShardedDesign(sub, self.mesh, tile=self.tile), beta_sub, idx
        st = self._checked_state()
        mask_work = take_fill(mask, st.feat_map, False)
        beta_work = take_fill(beta.to(torch.float32), st.feat_map, 0.0)
        return self._gather_work(beta_work, mask_work, cap,
                                 st.k_max if k_cap is None else k_cap)

    def scatter(self, beta_sub, idx):
        if self.layout == "dense":
            return self.inner.scatter(beta_sub, idx)
        st = self._mesh_state()
        return self._work_to_original(scatter_features(beta_sub, idx, st.p_work))


# ---------------------------------------------------------------------------
# coercion
# ---------------------------------------------------------------------------

_DESIGN_TYPES = (DenseDesign, SlabDesign, BucketedSlabDesign, ShardedDesign)


def as_design(data, *, n: Optional[int] = None, mesh=None,
              tile: int = 128, device_budget_bytes: Optional[int] = None):
    """Coerce an entry-point operand into a design.

    ``data`` may be a design (passed through), a dense (n, p) array or
    tensor, a :class:`ByFeature`, a :class:`SlabBuckets`, or a raw
    ``(row_idx, values)`` slab pair (front-packing is detected, so
    hand-built slabs may interleave sentinel and live slots). ``n`` is
    required for the raw pair. With ``mesh``, the result is wrapped in a
    :class:`ShardedDesign`; ``device_budget_bytes`` (mesh wrapping only)
    is its residency budget, which streams the slab passes when it is
    below the padded slab bytes.
    """
    if isinstance(data, _DESIGN_TYPES):
        d = data
    elif isinstance(data, ByFeature):
        if n is not None and data.n != n:
            raise ValueError(f"ByFeature has n={data.n} but len(y)={n}")
        d = SlabDesign.from_by_feature(data, 1)
    elif isinstance(data, SlabBuckets):
        dp = int(data.buckets[0][0].shape[1]) if data.buckets else 1
        d = BucketedSlabDesign(data, n=data.n_loc * dp, front_packed=True)
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
            f"dense (n, p) array, ByFeature, (row_idx, values) slabs, "
            f"SlabBuckets, or a design")
    if mesh is not None and not isinstance(d, ShardedDesign):
        d = ShardedDesign(d, mesh, tile=tile, device_budget_bytes=device_budget_bytes)
    return d
