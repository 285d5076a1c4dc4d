# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Hashed sparse-feature ingestion: live requests -> by-feature slabs, the
port's copy of ``repro/serve/ingest.py`` (numpy only; the arrays are
bit-equal to the reference's).

Requests arrive as sparse token -> value maps over an unbounded
vocabulary; the fitted model lives on a fixed ``p``-wide feature axis.
The bridge is the hashing trick, made deterministic so that a request
scores the same across processes and restarts:

* :func:`hash_token` is CRC-32 (not Python's per-process salted
  ``hash``);
* colliding tokens have their values summed in sorted-token order
  (:func:`encode_request`), so the sum does not depend on the caller's
  insertion order;
* exact-zero values are dropped, so an all-zero request packs as an
  empty one (all-sentinel slabs that score 0).

:func:`pack_requests` packs a batch of encoded requests into the
by-feature ``(p, DP, K)`` slab layout (paper Table 1, request rows
playing the example axis), the layout the training kernels consume, so
that scoring a batch is one ``kernels.ops.slab_path_spmv`` launch. Shapes
are quantised (power-of-two K classes, fixed batch capacities).
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence, Tuple, Union

import numpy as np

Request = Union[Mapping[str, float], Iterable[Tuple[str, float]]]


class InvalidRequest(ValueError):
    """A request that can never score correctly: non-finite feature
    values, or hashed indices outside the store's feature axis."""


def hash_token(token: str, p: int) -> int:
    """Deterministic token -> feature index in [0, p): the CRC-32 of the
    UTF-8 bytes, reduced mod ``p``."""
    return zlib.crc32(token.encode("utf-8")) % p


def encode_request(request: Request, p: int) -> Tuple[np.ndarray, np.ndarray]:
    """One request -> sorted ``(idx, val)`` arrays on the hashed axis.

    Colliding tokens sum in sorted-token order; exact-zero sums are
    dropped, so empty and all-zero requests encode alike (no live
    slots)."""
    items = request.items() if isinstance(request, Mapping) else request
    acc: dict = {}
    for token, value in sorted(items, key=lambda kv: kv[0]):
        v = float(value)
        if not math.isfinite(v):
            raise InvalidRequest(
                f"non-finite value {v!r} for token {token!r}: refusing to "
                f"encode (a single NaN would poison the whole scoring batch)")
        j = hash_token(token, p)
        acc[j] = acc.get(j, 0.0) + v
    idx = np.asarray(sorted(j for j in acc if acc[j] != 0.0), np.int64)
    val = np.asarray([acc[j] for j in idx], np.float32)
    return idx, val


def k_capacity(k_need: int, *, k_min: int = 8) -> int:
    """Power-of-two slab-capacity class (``data.byfeature.k_class`` with
    no global K ceiling): O(log K) distinct scoring shapes."""
    cap = max(k_min, 1)
    while cap < k_need:
        cap *= 2
    return cap


@dataclass(frozen=True)
class PackedBatch:
    """A request batch in slab form.

    ``row_idx``/``values`` are ``(p_pad, DP, K)`` by-feature slabs whose
    examples are the batch's request rows, in ``DP`` contiguous shards of
    ``n_loc = batch_cap // DP`` local rows (sentinel ``n_loc``). Rows >=
    ``n_live`` are padding (all-sentinel; they score 0 and are trimmed
    before scores leave the scorer)."""

    row_idx: np.ndarray          # (p_pad, DP, K) int32
    values: np.ndarray           # (p_pad, DP, K) float32
    n_live: int                  # real requests in the batch
    batch_cap: int               # padded batch extent (= DP * n_loc)
    p: int                       # original (unpadded) feature count

    @property
    def dp(self) -> int:
        return int(self.row_idx.shape[1])

    @property
    def n_loc(self) -> int:
        return self.batch_cap // max(self.dp, 1)

    @property
    def p_pad(self) -> int:
        return int(self.row_idx.shape[0])


def pack_requests(
    encoded: Sequence[Tuple[np.ndarray, np.ndarray]],
    p: int,
    *,
    batch_cap: int = None,
    dp: int = 1,
    pad_p_to: int = 1,
    k_min: int = 8,
) -> PackedBatch:
    """Pack encoded requests into a :class:`PackedBatch`.

    ``batch_cap`` (default: the batch size rounded up to ``dp``) fixes
    the padded request extent; ``pad_p_to`` rounds the feature axis up
    (mesh stores pass ``M * tile``, so the slab's feature blocks line up
    with the store's); ``k_min`` floors the power-of-two K class. Slabs
    are front-packed (live slots first, rows ascending within a feature),
    the training layout's invariant."""
    b = len(encoded)
    if batch_cap is None:
        batch_cap = max(b, 1)
    batch_cap += (-batch_cap) % max(dp, 1)
    if b > batch_cap:
        raise ValueError(f"{b} requests exceed batch_cap={batch_cap}")
    if batch_cap % dp:
        raise ValueError(f"dp={dp} must divide batch_cap={batch_cap}")
    n_loc = batch_cap // dp
    p_pad = p + (-p) % max(pad_p_to, 1)

    if b:
        feats = np.concatenate([idx for idx, _ in encoded])
        vals = np.concatenate([val for _, val in encoded])
        rows = np.concatenate([
            np.full(len(idx), i, np.int64) for i, (idx, _) in enumerate(encoded)])
    else:
        feats = rows = np.zeros(0, np.int64)
        vals = np.zeros(0, np.float32)
    if feats.size and (feats.min() < 0 or feats.max() >= p):
        raise InvalidRequest(f"hashed index out of range [0, {p})")

    shard = rows // max(n_loc, 1)
    loc = rows - shard * n_loc
    # rank of each entry within its (feature, shard) group: the stable
    # sort of data.byfeature._regroup_slabs, so the packed slabs carry the
    # training layout's front-packing
    group = feats * dp + shard
    counts = np.bincount(group, minlength=p * dp)
    order = np.argsort(group, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(order.size) - starts[group[order]]

    k = k_capacity(int(counts.max()) if counts.size else 1, k_min=k_min)
    row_idx = np.full((p_pad, dp, k), n_loc, np.int32)
    values = np.zeros((p_pad, dp, k), np.float32)
    g = group[order]
    row_idx[g // dp, g % dp, rank] = loc[order]
    values[g // dp, g % dp, rank] = vals[order]
    return PackedBatch(row_idx=row_idx, values=values, n_live=b,
                       batch_cap=batch_cap, p=p)
