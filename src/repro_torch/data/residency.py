# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Bucket residency: budgeted device placement of the slab work buckets,
the counterpart of ``repro/data/residency.py``.

:class:`BucketResidencyManager` owns the mesh-padded work buckets that
``api.design.ShardedDesign._mesh_state`` builds:

* **resident** (no budget, or a budget covering the buckets' bytes):
  every bucket goes to the device once, at construction, and stays there
  for the design's lifetime;
* **streamed** (a budget below the buckets' bytes): the buckets live on
  the host, in pinned memory, and are double-buffered through each pass:
  bucket t+1's copy is dispatched before bucket t is yielded to its
  work, and a least-recently-used policy evicts cold buckets to keep the
  resident bytes within the budget.

Both modes run the same operations in the same bucket order; the manager
only changes where a bucket lives, so streamed solves are bit-identical
to resident ones.

On a card the streamed copies run on a side stream, from pinned memory,
without blocking the host. Torch's caching allocator does not wait for
work that other streams queued on a block before it reuses the block, so
every device bucket handed out (:meth:`BucketResidencyManager.get`,
:meth:`~BucketResidencyManager.iter_buckets`) first makes the current
stream wait for its copy's event, and is then marked with
``record_stream`` on that stream: an evicted bucket's memory is reused
only after the work that read it has run. Without that, eviction would
corrupt a bucket still being read, silently.

Every put runs under ``resilience.retry_call`` (``RuntimeError`` retried
with backoff, exhaustion raised as ``RetriesExhausted``). Each attempt
first consults ``resilience.take_prefetch_failure()`` (the lost-bucket
drill), so a failed attempt enqueues no copy and records no event, and a
retry starts clean. The budget is a
high-water mark for the managed buckets: copies in flight and unmanaged
operands (restricted-solve working sets) can briefly exceed it.
:func:`put_slab` is the door for slab placements outside the managed
buckets (serve request slabs).

Observability (``repro_torch.obs``): each miss's eviction and put run in
a ``bucket_stream(bucket=)`` span, and :meth:`BucketResidencyManager.
register_metrics` mirrors :meth:`~BucketResidencyManager.stats` onto a
metrics registry as a lazy, read-only callback; the counters stay the
source of truth.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience.inject import InjectedFault, take_prefetch_failure
from repro_torch.resilience.retry import retry_call


def put_slab(row_idx, values, device):
    """One slab pair on ``device`` (no copy if it is there). From the host
    to a card the copy is made from pinned memory (the pair is pinned here
    if it is not) and does not block the host; it is ordered on the
    current stream."""
    dev = torch.device(device)
    if dev.type == "cuda" and row_idx.device.type == "cpu":
        pair = (t if t.is_pinned() else t.pin_memory() for t in (row_idx, values))
        return tuple(t.to(dev, non_blocking=True) for t in pair)
    return row_idx.to(dev), values.to(dev)


@dataclass
class ResidencyCounters:
    """Telemetry for one manager (all monotone), as the reference counts."""

    hits: int = 0          # a bucket access served from the device
    misses: int = 0        # a bucket access that had to stream the bucket in
    evictions: int = 0     # LRU drops under budget pressure
    puts: int = 0          # successful host->device bucket puts
    retries: int = 0       # put attempts that failed and were retried
    bytes_h2d: int = 0     # payload bytes moved host->device


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class BucketResidencyManager:
    """Budgeted LRU residency over padded slab work buckets.

    ``buckets`` is the tuple of ``(row_idx, values, feat_idx)`` triples
    (never mutated); ``device`` is where the bucket copies live;
    ``budget_bytes=None``, or a budget covering ``total_bytes``, selects
    resident mode.

    Streamed mode needs room to double-buffer: the budget must cover the
    largest adjacent pair of buckets (:attr:`min_budget_bytes`), else
    construction raises with the number to raise the budget to.
    """

    def __init__(self, buckets, *, device, budget_bytes: Optional[int] = None,
                 retry_attempts: int = 3, retry_base_s: float = 0.05):
        self.device = torch.device(device)
        self.n_buckets = len(buckets)
        self.bucket_bytes: Tuple[int, ...] = tuple(
            _nbytes(r) + _nbytes(v) for r, v, _ in buckets)
        self.total_bytes = sum(self.bucket_bytes)
        pairs = [self.bucket_bytes[i] + self.bucket_bytes[i + 1]
                 for i in range(self.n_buckets - 1)]
        self.min_budget_bytes = max(pairs) if pairs else (
            self.bucket_bytes[0] if self.n_buckets else 0)
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        self.streamed = (self.budget_bytes is not None
                         and self.budget_bytes < self.total_bytes)
        self.counters = ResidencyCounters()
        self._feat = tuple(b[2] for b in buckets)
        self._retry_attempts = retry_attempts
        self._retry_base_s = retry_base_s
        # bucket id -> (row_idx, values, copy event or None), LRU order
        self._resident: "OrderedDict[int, tuple]" = OrderedDict()
        self._resident_bytes = 0
        self._pinned: set = set()
        self._iterating = False
        self._stream = None
        if self.streamed:
            if self.budget_bytes < self.min_budget_bytes:
                raise ValueError(
                    f"device_budget_bytes={self.budget_bytes} cannot "
                    f"double-buffer these work buckets: the largest "
                    f"adjacent bucket pair is {self.min_budget_bytes} bytes "
                    f"(of {self.total_bytes} total over {self.n_buckets} "
                    f"buckets) -- raise the budget to >= "
                    f"{self.min_budget_bytes}, or drop it to run resident")
            card = self.device.type == "cuda"
            # host copies, pinned once, so that every later copy is
            # asynchronous; a side stream carries them
            # allow[torch-host-sync]: the streamed buckets' pinned host copies, made once at construction, before any pass
            self._host = tuple(tuple(self._pin(t.cpu()) if card else t.cpu() for t in (r, v))
                               for r, v, _ in buckets)
            if card:
                self._stream = torch.cuda.Stream(self.device)
        else:
            # resident: one put per bucket, kept for the manager's lifetime
            self._host = None
            for i, (r, v, _) in enumerate(buckets):
                self._admit(i, self._put(i, r, v))

    @staticmethod
    def _pin(t):
        return t if t.is_pinned() else t.pin_memory()

    # -- device placement --------------------------------------------------

    def _put(self, i: int, r, v):
        """One counted, retried host->device put of bucket ``i``: on the
        side stream when streaming to a card (with the event the copy
        records), else on the current stream."""
        def attempt():
            if take_prefetch_failure():
                raise InjectedFault(f"injected prefetch failure (bucket {i})")
            if self._stream is None:
                return (*put_slab(r, v, self.device), None)
            with torch.cuda.stream(self._stream):
                r_d, v_d = put_slab(r, v, self.device)
                event = torch.cuda.Event()
                event.record(self._stream)
            return r_d, v_d, event

        def count_retry(_k, _err):
            self.counters.retries += 1

        entry = retry_call(attempt, attempts=self._retry_attempts,
                           base_delay_s=self._retry_base_s,
                           retry_on=(RuntimeError,), on_retry=count_retry)
        self.counters.puts += 1
        self.counters.bytes_h2d += self.bucket_bytes[i]
        return entry

    def _admit(self, i: int, entry) -> None:
        self._resident[i] = entry
        self._resident_bytes += self.bucket_bytes[i]

    def _ensure_room(self, need: int, keep) -> None:
        if not self.streamed:
            return
        while self._resident_bytes + need > self.budget_bytes:
            victim = next((j for j in self._resident
                           if j not in self._pinned and j not in keep), None)
            if victim is None:
                raise RuntimeError(
                    f"residency budget {self.budget_bytes} exhausted with "
                    f"every resident bucket pinned -- min_budget_bytes="
                    f"{self.min_budget_bytes} should have prevented this")
            # dropping the references is the eviction; record_stream at
            # hand-out keeps the memory from reuse until its readers ran
            self._resident.pop(victim)
            self._resident_bytes -= self.bucket_bytes[victim]
            self.counters.evictions += 1

    def _fetch(self, i: int):
        """Bucket ``i``'s entry, streamed in (evicting LRU cold buckets)
        on a miss; counts the access.

        A miss's eviction and put run in a ``bucket_stream(bucket=i)`` span
        (the reference's). On a card the put only issues an asynchronous
        copy on the side stream, so the span times the host's part of a
        miss (pinning, issuing the copy, evicting); the copy itself runs
        behind the work and is timed with CUDA events (``chip_smoke.py``
        phase 8a)."""
        if not 0 <= i < self.n_buckets:
            raise IndexError(f"bucket {i} out of range [0, {self.n_buckets})")
        entry = self._resident.get(i)
        if entry is not None:
            self._resident.move_to_end(i)
            self.counters.hits += 1
            return entry
        self.counters.misses += 1
        with obs_trace.span("bucket_stream", bucket=i):
            self._ensure_room(self.bucket_bytes[i], keep={i})
            entry = self._put(i, *self._host[i])
        self._admit(i, entry)
        return entry

    def _hand_out(self, entry):
        """The device pair of an entry, safe to use on the current stream:
        the stream waits for the copy, and the pair is marked as in use
        there."""
        r, v, event = entry
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            r.record_stream(stream)
            v.record_stream(stream)
        return r, v

    # -- access ------------------------------------------------------------

    def get(self, i: int):
        """The device ``(row_idx, values)`` pair of bucket ``i``, streaming
        it in (and evicting LRU cold buckets) on a miss."""
        return self._hand_out(self._fetch(i))

    def iter_buckets(self) -> Iterator[tuple]:
        """``(row_idx, values, feat_idx)`` in bucket order, with bucket
        t+1's put dispatched before bucket t is yielded to its work (the
        double buffer that hides the copy behind the work). Not reentrant:
        every pass consumes its iteration before the next starts."""
        if self._iterating:
            raise RuntimeError(
                "bucket iteration is not reentrant -- consume the previous "
                "pass before starting another")
        self._iterating = True
        try:
            for i in range(self.n_buckets):
                self._pinned = {i, i + 1} if i + 1 < self.n_buckets else {i}
                entry = self._fetch(i)
                if i + 1 < self.n_buckets:
                    self._fetch(i + 1)        # prefetch ahead of the work
                r, v = self._hand_out(entry)
                yield r, v, self._feat[i]
        finally:
            self._pinned = set()
            self._iterating = False

    # -- telemetry ---------------------------------------------------------

    def register_metrics(self, registry=None, *, name: str = "residency") -> None:
        """Mirror :meth:`stats` onto a ``repro_torch.obs`` metrics registry
        (``registry``, or the active one) as a lazy read-only callback under
        ``name``; the counters stay the single source of truth. No-op when
        no registry is given or active."""
        reg = obs_registry.get_registry() if registry is None else registry
        if reg is None:
            return
        reg.register_callback(name, self.stats)

    # -- introspection -----------------------------------------------------

    def resident_indices(self) -> Tuple[int, ...]:
        """Resident bucket ids in LRU order (least recent first)."""
        return tuple(self._resident)

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    def stats(self) -> dict:
        c = self.counters
        access = c.hits + c.misses
        return {
            "streamed": self.streamed,
            "n_buckets": self.n_buckets,
            "budget_bytes": self.budget_bytes,
            "total_bytes": self.total_bytes,
            "resident_bytes": self._resident_bytes,
            "hits": c.hits,
            "misses": c.misses,
            "evictions": c.evictions,
            "puts": c.puts,
            "retries": c.retries,
            "bytes_h2d": c.bytes_h2d,
            "hit_rate": (c.hits / access) if access else 0.0,
        }
