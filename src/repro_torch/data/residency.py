# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Bucket residency, the resident half of ``repro/data/residency.py``.

:class:`BucketResidencyManager` places the mesh-padded slab work buckets
that ``api.design.ShardedDesign._mesh_state`` builds on the device, each
once, and keeps them for the design's lifetime; every pass over the
slabs goes through :meth:`BucketResidencyManager.iter_buckets`, in
bucket order. :func:`put_slab` is the door for slab placements outside
the managed buckets (restricted-solve operands).

The streamed mode (a device budget below the slab bytes, buckets
double-buffered from the host through each pass) is not ported yet
(ROADMAP queue 1 item 4): a budget below the slab bytes raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch


def put_slab(row_idx, values, device):
    """One transient slab pair on ``device`` (no copy if it is there)."""
    return row_idx.to(device), values.to(device)


@dataclass
class ResidencyCounters:
    """Telemetry for one manager (all monotone), as the reference counts."""

    hits: int = 0          # get() served from the device
    misses: int = 0        # get() had to bring the bucket in
    evictions: int = 0     # budget drops (none while resident)
    puts: int = 0          # host->device bucket placements
    retries: int = 0       # failed placements retried (none: no retry here)
    bytes_h2d: int = 0     # payload bytes placed (counted per put)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class BucketResidencyManager:
    """Resident placement of padded slab work buckets.

    ``buckets`` is the tuple of ``(row_idx, values, feat_idx)`` triples;
    each pair goes to ``device`` once, here. ``budget_bytes`` below the
    buckets' total would select the streamed mode, which is not ported
    yet and raises."""

    def __init__(self, buckets, *, device, budget_bytes: Optional[int] = None):
        self.n_buckets = len(buckets)
        self.bucket_bytes: Tuple[int, ...] = tuple(
            _nbytes(r) + _nbytes(v) for r, v, _ in buckets)
        self.total_bytes = sum(self.bucket_bytes)
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        if self.budget_bytes is not None and self.budget_bytes < self.total_bytes:
            raise NotImplementedError(
                f"device_budget_bytes={self.budget_bytes} is below the slab bytes "
                f"({self.total_bytes}): streamed residency is not ported yet "
                f"(ROADMAP queue 1 item 4)")
        self.streamed = False
        self.counters = ResidencyCounters()
        self._feat = tuple(b[2] for b in buckets)
        self._resident = {}
        device = torch.device(device)
        for i, (r, v, _) in enumerate(buckets):
            self._resident[i] = put_slab(r, v, device)
            self.counters.puts += 1
            self.counters.bytes_h2d += self.bucket_bytes[i]

    def get(self, i: int):
        """The device ``(row_idx, values)`` pair of bucket ``i``."""
        if not 0 <= i < self.n_buckets:
            raise IndexError(f"bucket {i} out of range [0, {self.n_buckets})")
        self.counters.hits += 1
        return self._resident[i]

    def iter_buckets(self) -> Iterator[tuple]:
        """``(row_idx, values, feat_idx)`` in bucket order."""
        for i in range(self.n_buckets):
            r, v = self.get(i)
            yield r, v, self._feat[i]

    def stats(self) -> dict:
        c = self.counters
        access = c.hits + c.misses
        return {
            "streamed": self.streamed,
            "n_buckets": self.n_buckets,
            "budget_bytes": self.budget_bytes,
            "total_bytes": self.total_bytes,
            "resident_bytes": self.total_bytes,
            "hits": c.hits,
            "misses": c.misses,
            "evictions": c.evictions,
            "puts": c.puts,
            "retries": c.retries,
            "bytes_h2d": c.bytes_h2d,
            "hit_rate": (c.hits / access) if access else 0.0,
        }
