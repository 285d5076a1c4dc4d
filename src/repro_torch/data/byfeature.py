# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The paper's "by feature" data layout (section 3, Table 1), the
counterpart of ``repro/data/byfeature.py``.

Machine m stores X_m = {L_j | j in S_m}, L_j = {(i, x_ij) | x_ij != 0}:

* :func:`to_by_feature` -- dense (n, p) -> padded CSC arrays (row_idx
  (p, K), values (p, K)), K = max nnz per feature, sentinel row = n;
* :func:`densify_tile` / :func:`densify` -- scatter features back to a
  dense block (the oracle and interop utility);
* :func:`write_table1` / :func:`read_table1` -- the paper's Table-1 text
  lines ``feature_id (example_id:value) (example_id:value) ...``;
* :func:`partition_features` -- contiguous feature blocks S_1..S_M;
* :func:`to_slabs` -- re-key for ``dp`` example shards: (p, dp, K')
  slabs with local row indices (sentinel n_loc), front-packed;
* :class:`SlabBuckets` / :func:`to_slab_buckets` -- the nnz-bucketed
  form, features grouped into power-of-two K classes (:func:`k_class`);
* :func:`gather_features`, :func:`take_buckets_iter`,
  :func:`gather_features_buckets` and :func:`scatter_features` -- the
  screened path's working-set gather into slab form and its inverse,
  on the slabs' device with no host read.

The layout transforms run on the host (numpy) and return CPU tensors;
an entry point moves them to its device once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, TextIO, Tuple

import numpy as np
import torch


@dataclass
class ByFeature:
    row_idx: torch.Tensor    # (p, K) int32, sentinel = n for padding
    values: torch.Tensor     # (p, K) float32
    n: int                   # number of examples

    @property
    def p(self) -> int:
        return int(self.row_idx.shape[0])

    @property
    def nnz(self) -> int:
        return int((self.row_idx < self.n).sum())

    def gather(self, beta, mask, cap: int):
        """Screened working set as a restricted ByFeature (see
        :func:`gather_features`). Returns ``(bf_sub, beta_sub, idx)``."""
        r, v, b, idx = gather_features(self.row_idx, self.values, beta, mask, cap,
                                       sentinel=self.n)
        return ByFeature(r, v, self.n), b, idx


def _host(t) -> np.ndarray:
    # allow[torch-host-sync]: layout preparation on the host before any solve (Table-1 by-feature build)
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def to_by_feature(X) -> ByFeature:
    """Dense (n, p) -> by-feature padded CSC (the Reduce step of paper
    section 3)."""
    Xn = _host(X)
    n, p = Xn.shape
    cols = [np.nonzero(Xn[:, j])[0] for j in range(p)]
    k = max((len(c) for c in cols), default=1) or 1
    row_idx = np.full((p, k), n, np.int32)
    values = np.zeros((p, k), np.float32)
    for j, c in enumerate(cols):
        row_idx[j, : len(c)] = c
        values[j, : len(c)] = Xn[c, j]
    return ByFeature(torch.from_numpy(row_idx), torch.from_numpy(values), n)


def densify_tile(bf: ByFeature, start: int, width: int) -> torch.Tensor:
    """Features [start, start+width) -> dense (n, width) block via
    scatter (duplicate rows sum; sentinel slots land in a dropped row)."""
    rows = bf.row_idx[start:start + width].long()
    vals = bf.values[start:start + width].to(torch.float32)
    out = torch.zeros(bf.n + 1, width, dtype=torch.float32, device=rows.device)
    cols = torch.arange(width, device=rows.device)[:, None].expand_as(rows)
    out.index_put_((rows.clamp_max(bf.n).reshape(-1), cols.reshape(-1)),
                   vals.reshape(-1), accumulate=True)
    return out[: bf.n]


def densify(bf: ByFeature) -> torch.Tensor:
    return densify_tile(bf, 0, bf.p)


# ---------------------------------------------------------------------------
# Table-1 text format
# ---------------------------------------------------------------------------

def write_table1(bf: ByFeature, fh: TextIO) -> None:
    ri = _host(bf.row_idx)
    vv = _host(bf.values)
    for j in range(bf.p):
        live = ri[j] < bf.n
        cells = " ".join(f"({int(i)}:{float(v):.9g})" for i, v in zip(ri[j][live], vv[j][live]))
        fh.write(f"{j} {cells}\n".rstrip() + "\n")


def read_table1(fh: TextIO, n: int) -> ByFeature:
    """Parse the Table-1 format honoring the leading feature id: lines may
    come in any order, ids absent from the file become empty
    (all-sentinel) features, and a repeated id keeps its last line."""
    feats = {}
    for line in fh:
        parts = line.split()
        if not parts:
            continue
        j = int(parts[0])
        entries = [p.strip("()").split(":") for p in parts[1:]]
        feats[j] = ([int(i) for i, _ in entries], [float(v) for _, v in entries])
    p = max(feats) + 1 if feats else 0
    k = max((len(r) for r, _ in feats.values()), default=1) or 1
    row_idx = np.full((p, k), n, np.int32)
    values = np.zeros((p, k), np.float32)
    for j, (r, v) in feats.items():
        row_idx[j, : len(r)] = r
        values[j, : len(v)] = v
    return ByFeature(torch.from_numpy(row_idx), torch.from_numpy(values), n)


def partition_features(p: int, num_machines: int) -> Tuple[np.ndarray, ...]:
    """Contiguous feature blocks S_1..S_M (the Reduce-side partitioning)."""
    bounds = np.linspace(0, p, num_machines + 1).astype(int)
    return tuple(np.arange(bounds[i], bounds[i + 1]) for i in range(num_machines))


# ---------------------------------------------------------------------------
# slabs: the (p, DP, K) layout the by-feature solve consumes
# ---------------------------------------------------------------------------

@dataclass
class SlabBuckets:
    """nnz-bucketed slabs: ``buckets[i] = (row_idx (p_i, DP, K_i), values,
    feat_idx (p_i,) numpy int64)`` with per-bucket K_i on a power-of-two
    ladder, so storage is about O(nnz) instead of O(p K_max). ``feat_idx``
    maps each bucket row to its original feature; the concatenated
    bucket order is the permuted feature axis the screened path works in.

    Invariant: every slab's K axis is front-packed (live slots first), as
    :func:`to_slab_buckets` makes it: consumers trim K positionally.
    """

    buckets: tuple                 # of (row_idx, values, feat_idx)
    n_loc: int
    p: int                         # original feature count

    @property
    def k_classes(self):
        return tuple(int(b[0].shape[-1]) for b in self.buckets)

    @property
    def feat_order(self) -> np.ndarray:
        """Original feature ids in concatenated bucket order."""
        return np.concatenate([np.asarray(b[2]) for b in self.buckets])

    @property
    def bucket_nbytes(self) -> Tuple[int, ...]:
        """Per-bucket slab payload bytes (row_idx + values)."""
        return tuple(r.numel() * r.element_size() + v.numel() * v.element_size()
                     for r, v, _ in self.buckets)

    @property
    def nbytes(self) -> int:
        return sum(self.bucket_nbytes)

def _regroup_slabs(bf: ByFeature, dp: int):
    """Global rows -> per-shard local rows + per-(feature, shard) nnz
    counts, vectorized: flatten the live entries, key them by (feature,
    shard), and rank each entry within its group from the stable sort of
    the keys."""
    n_loc = bf.n // dp
    ri = _host(bf.row_idx)
    vv = _host(bf.values)
    p = bf.p
    j_idx, k_idx = np.nonzero(ri < bf.n)
    rows = ri[j_idx, k_idx]
    vals = vv[j_idx, k_idx]
    shard = rows // max(n_loc, 1)
    group = j_idx * dp + shard
    counts = np.bincount(group, minlength=p * dp)
    order = np.argsort(group, kind="stable")
    group_sorted = group[order]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(len(group_sorted)) - starts[group_sorted]
    jj, ss = group_sorted // dp, group_sorted % dp
    loc_rows = (rows - shard * n_loc)[order]
    loc_vals = vals[order]
    return jj, ss, rank, loc_rows, loc_vals, counts.reshape(p, dp), n_loc


def to_slabs(bf: ByFeature, dp: int):
    """Re-key a by-feature layout for ``dp`` example shards of n_loc = n/dp
    contiguous rows: every feature's entries regrouped per shard with
    local row indices (sentinel n_loc), front-packed along K (live slots
    first). Returns ``(row_idx (p, dp, K'), values (p, dp, K'), n_loc)``.
    """
    if bf.n % dp:
        raise ValueError(
            f"data shard count {dp} must divide n={bf.n} (trim or pad upstream)"
        )
    jj, ss, rank, loc_rows, loc_vals, counts, n_loc = _regroup_slabs(bf, dp)
    p = bf.p
    k = max(1, int(counts.max()) if counts.size else 1)
    row_idx = np.full((p, dp, k), n_loc, np.int32)
    values = np.zeros((p, dp, k), np.float32)
    row_idx[jj, ss, rank] = loc_rows
    values[jj, ss, rank] = loc_vals
    return torch.from_numpy(row_idx), torch.from_numpy(values), n_loc


def k_class(k_need: int, k_max: int, *, k_min: int = 8) -> int:
    """Round a slab capacity up to its power-of-two class (min ``k_min``,
    capped at ``k_max``): O(log K_max) slab shapes; the feature-axis twin
    is ``core.screening.capacity_bucket``."""
    cap = max(k_min, 1)
    while cap < min(k_need, k_max):
        cap *= 2
    return min(cap, max(k_max, 1))


def to_slab_buckets(bf: ByFeature, dp: int, *, k_min: int = 8) -> SlabBuckets:
    """:func:`to_slabs` with nnz-bucketed capacities: features grouped by
    their per-shard max nnz into power-of-two classes, each class its own
    (p_i, dp, K_i) slab pair padded only to K_i."""
    if bf.n % dp:
        raise ValueError(
            f"data shard count {dp} must divide n={bf.n} (trim or pad upstream)"
        )
    jj, ss, rank, loc_rows, loc_vals, counts, n_loc = _regroup_slabs(bf, dp)
    p = bf.p
    k_feat = counts.max(axis=1) if p else np.zeros(0, np.int64)
    k_max = max(1, int(k_feat.max()) if p else 1)
    classes = sorted({k_class(int(k), k_max, k_min=k_min) for k in k_feat})
    if not classes:
        classes = [k_class(1, 1, k_min=k_min)]
    # every feature in the smallest class that holds it
    feat_class = np.searchsorted(np.asarray(classes), k_feat)
    buckets = []
    pos_of_feat = np.zeros(p, np.int64)
    for ci, kc in enumerate(classes):
        feats = np.flatnonzero(feat_class == ci)
        if feats.size == 0:
            continue
        pos_of_feat[feats] = np.arange(feats.size)
        row_idx = np.full((feats.size, dp, kc), n_loc, np.int32)
        values = np.zeros((feats.size, dp, kc), np.float32)
        sel = feat_class[jj] == ci
        row_idx[pos_of_feat[jj[sel]], ss[sel], rank[sel]] = loc_rows[sel]
        values[pos_of_feat[jj[sel]], ss[sel], rank[sel]] = loc_vals[sel]
        buckets.append((torch.from_numpy(row_idx), torch.from_numpy(values),
                        feats.astype(np.int64)))
    return SlabBuckets(buckets=tuple(buckets), n_loc=n_loc, p=p)


# ---------------------------------------------------------------------------
# the screened path's working-set gathers (on the slabs' device)
# ---------------------------------------------------------------------------

def _trim_k(t, k_cap: int, fill):
    """Slice (or pad with ``fill``) the trailing slab-capacity axis to
    ``k_cap``; exact on front-packed slabs (live slots first)."""
    k = t.shape[-1]
    if k_cap >= k:
        if k_cap == k:
            return t
        return torch.nn.functional.pad(t, (0, k_cap - k), value=fill)
    return t[..., :k_cap]


def gather_features(row_idx, values, beta, mask, cap: int, *, sentinel: int,
                    k_cap: Optional[int] = None):
    """Feature-axis gather of the working set into slab form.

    ``row_idx``/``values`` are feature-major, (p, K) or (p, DP, K).
    Returns ``(row_idx_sub, values_sub, beta_sub, idx)``, ``idx`` (cap,)
    with sentinel p at the padding, whose slabs are all-sentinel (their
    coordinates stay at zero). ``k_cap`` also trims K to the working
    set's class (front-packed slabs only)."""
    from repro_torch.core.screening import pack_indices, take_fill

    idx = pack_indices(mask, cap)
    rows_sub = take_fill(row_idx, idx, sentinel)
    vals_sub = take_fill(values, idx, 0.0)
    beta_sub = take_fill(beta, idx, 0.0)
    if k_cap is not None:
        rows_sub = _trim_k(rows_sub, k_cap, sentinel)
        vals_sub = _trim_k(vals_sub, k_cap, 0.0)
    return rows_sub, vals_sub, beta_sub, idx


def take_buckets_iter(buckets, n_loc: int, idx, k_cap: int):
    """:func:`take_features_buckets` over any iterable of ``(row_idx,
    values, ...)`` buckets: each bucket taken at the indices that fall in
    its range of the concatenated axis (the rest read as all-sentinel),
    trimmed or padded to ``k_cap``, and the pieces combined with
    ``where``. Returns the (len(idx), DP, k_cap) slab pair."""
    from repro_torch.core.screening import take_fill

    rows_sub = vals_sub = None
    off = 0
    for bucket in buckets:
        r_b, v_b = bucket[0], bucket[1]
        p_b = r_b.shape[0]
        ok = torch.logical_and(idx >= off, idx < off + p_b)
        li = torch.where(ok, idx - off, p_b)
        rb = _trim_k(take_fill(r_b, li, n_loc), k_cap, n_loc)
        vb = _trim_k(take_fill(v_b, li, 0.0), k_cap, 0.0)
        if rows_sub is None:
            rows_sub, vals_sub = rb, vb
        else:
            sel = ok[:, None, None]
            rows_sub = torch.where(sel, rb, rows_sub)
            vals_sub = torch.where(sel, vb, vals_sub)
        off += p_b
    return rows_sub, vals_sub


def take_features_buckets(slabs: SlabBuckets, idx, k_cap: int):
    """Explicit-index feature take over a bucketed layout: ``idx`` holds
    concatenated-bucket positions (sentinel >= the extent for padding)."""
    return take_buckets_iter(slabs.buckets, slabs.n_loc, idx, k_cap)


def gather_features_buckets(slabs: SlabBuckets, beta, mask, cap: int, k_cap: int):
    """:func:`gather_features` over a bucketed layout: ``mask``/``beta``
    on the concatenated (bucket-permuted) feature axis."""
    from repro_torch.core.screening import pack_indices, take_fill

    idx = pack_indices(mask, cap)
    rows_sub, vals_sub = take_features_buckets(slabs, idx, k_cap)
    return rows_sub, vals_sub, take_fill(beta, idx, 0.0), idx


def scatter_features(beta_sub, idx, p: int):
    """Inverse of :func:`gather_features`: restricted solution -> (p,)
    beta; the coefficient scatter is the dense column scatter."""
    from repro_torch.core.screening import scatter_columns

    return scatter_columns(beta_sub, idx, p)
