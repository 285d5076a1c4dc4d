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
  slabs with local row indices (sentinel n_loc), front-packed.

The layout transforms run on the host (numpy) and return CPU tensors;
an entry point moves them to its device once. The bucketed layout, the
active-set gathers and the scatter come with the path and residency
slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TextIO, Tuple

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


def _host(t) -> np.ndarray:
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
