# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Request batching for the serving loop, the counterpart of
``repro/serve/batcher.py`` (host-side Python, no tensors).

:class:`RequestBatcher` accumulates live requests (hashed-token feature
maps and a requested lambda each) and drains them as one
:class:`~repro_torch.serve.ingest.PackedBatch` per scoring launch:

* the batch extent is quantised to power-of-two capacity classes
  (:func:`batch_capacity`) up to ``max_batch``, like the slab K classes
  of :func:`~repro_torch.serve.ingest.k_capacity`;
* hashing and encoding happen at ``submit`` (spreading the host work over
  arrivals), packing at ``drain`` (one vectorised pass).

The queue is bounded: ``max_pending`` caps admission (``submit`` raises
:class:`Overloaded` rather than grow without limit behind a stalled
drainer), and each request carries an optional deadline on an injectable
monotonic clock; expired requests are shed at drain rather than scored
late. Rejections and sheds are counted in :attr:`RequestBatcher.stats`.
The submit timestamps of each drained batch wait for
:meth:`RequestBatcher.mark_scored`, which observes each request's submit
-> score latency into the ``serve.latency_s`` histogram of the active
``repro_torch.obs`` registry. ``submit`` runs its hashing in an
``encode`` span, ``drain`` is a ``drain`` span, both set the
``serve.queue_depth`` gauge, and :meth:`RequestBatcher.register_metrics`
mirrors :attr:`~RequestBatcher.stats` and the queue depth onto the
registry read-only (the dict stays the source of truth).

Lambdas stay raw floats until scoring: ``PathScorer`` resolves them
against the snapshot it scores with.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.ingest import (InvalidRequest, PackedBatch, Request,
                                      encode_request, pack_requests)


class Overloaded(RuntimeError):
    """The batcher's pending queue is at ``max_pending``: shed the request
    (count it, tell the client to retry)."""


def _check_pow2(name: str, value: int) -> None:
    if value < 1 or (value & (value - 1)):
        raise ValueError(
            f"{name} must be a power of two >= 1 (capacity classes are "
            f"power-of-two so the distinct shape count stays O(log "
            f"max_batch)), got {value}")


def batch_capacity(b: int, *, b_min: int = 8, b_max: int = 4096) -> int:
    """Power-of-two batch capacity class covering ``b`` rows, clamped to
    ``[b_min, b_max]``; both bounds must be powers of two."""
    _check_pow2("b_min", b_min)
    _check_pow2("b_max", b_max)
    if b_min > b_max:
        raise ValueError(f"b_min={b_min} exceeds b_max={b_max}")
    cap = b_min
    while cap < min(b, b_max):
        cap *= 2
    return cap


class RequestBatcher:
    """Thread-safe accumulate/drain bridge between request arrival and the
    batched scoring launch.

    ``dp``/``pad_p_to`` fix the packed slab geometry (pass the store's
    ``pad_p_to``; the defaults are the local geometry). ``max_batch``
    caps one drain; leftover requests wait for the next. ``max_pending``
    is the admission cap, ``default_ttl_s`` the deadline of a request
    submitted without ``deadline_s`` (None: none), ``clock`` the
    monotonic time source (injectable, so tests expire requests
    deterministically)."""

    def __init__(self, p: int, *, max_batch: int = 256, dp: int = 1,
                 pad_p_to: int = 1, k_min: int = 8, max_pending: int = 4096,
                 default_ttl_s: Optional[float] = None, clock=time.monotonic):
        _check_pow2("max_batch", max_batch)
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.p = p
        self.max_batch = max_batch
        self.dp = dp
        self.pad_p_to = pad_p_to
        self.k_min = k_min
        self.max_pending = max_pending
        self.default_ttl_s = default_ttl_s
        self.clock = clock
        self._lock = threading.Lock()
        # (encoded, lam, expiry on self.clock or None, submit time) per request
        self._pending: List[Tuple[Tuple[np.ndarray, np.ndarray], float,
                                  Optional[float], float]] = []
        self._stats = {"submitted": 0, "rejected_overload": 0,
                       "rejected_invalid": 0, "shed_expired": 0, "drained": 0}
        # submit times of the last drain, until the loop marks it scored
        self._last_drained_ts: List[float] = []
        self.register_metrics()

    def submit(self, request: Request, lam: float, *,
               deadline_s: Optional[float] = None) -> None:
        """Enqueue one request (hashed and encoded at once).

        ``deadline_s`` is a time-to-live on the batcher's clock (default
        ``default_ttl_s``); a request still queued past it is shed at the
        next drain. Raises :class:`~repro_torch.serve.ingest.InvalidRequest`
        on garbage input and :class:`Overloaded` when the queue is at
        ``max_pending``, each counted first."""
        try:
            with obs_trace.span("encode"):
                enc = encode_request(request, self.p)
            idx = enc[0]
            if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= self.p):
                raise InvalidRequest(f"hashed index out of range [0, {self.p})")
        except InvalidRequest:
            with self._lock:
                self._stats["rejected_invalid"] += 1
            raise
        now = self.clock()
        ttl = self.default_ttl_s if deadline_s is None else deadline_s
        expiry = None if ttl is None else now + float(ttl)
        with self._lock:
            if len(self._pending) >= self.max_pending:
                self._stats["rejected_overload"] += 1
                raise Overloaded(
                    f"pending queue full ({self.max_pending} requests): drain is "
                    f"not keeping up -- shed and retry with backoff")
            self._pending.append((enc, float(lam), expiry, now))
            self._stats["submitted"] += 1
            depth = len(self._pending)
        obs_registry.gauge("serve.queue_depth").set(depth)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def stats(self) -> dict:
        """Counter snapshot: submitted, rejected_overload,
        rejected_invalid, shed_expired, drained."""
        with self._lock:
            return dict(self._stats)

    def drain(self) -> Tuple[PackedBatch, np.ndarray]:
        """Pack up to ``max_batch`` queued requests into one batch.

        Expired requests are shed first (counted, never packed). Returns
        ``(batch, lams)``; ``lams[i]`` belongs to batch row i. An empty
        queue drains to an all-padding batch (``n_live == 0``)."""
        with obs_trace.span("drain") as sp:
            now = self.clock()
            with self._lock:
                live = [e for e in self._pending if e[2] is None or e[2] > now]
                self._stats["shed_expired"] += len(self._pending) - len(live)
                take, self._pending = live[:self.max_batch], live[self.max_batch:]
                self._stats["drained"] += len(take)
                self._last_drained_ts = [e[3] for e in take]
                depth = len(self._pending)
            obs_registry.gauge("serve.queue_depth").set(depth)
            encoded = [e[0] for e in take]
            lams = np.asarray([e[1] for e in take], np.float64)
            cap = batch_capacity(max(len(encoded), 1), b_max=self.max_batch)
            cap += (-cap) % max(self.dp, 1)
            batch = pack_requests(encoded, self.p, batch_cap=cap, dp=self.dp,
                                  pad_p_to=self.pad_p_to, k_min=self.k_min)
            sp.set(drained=len(take))
        return batch, lams

    def mark_scored(self) -> int:
        """Mark the last drained batch scored (the serve loop calls this
        right after the scorer returns host scores): each of its requests'
        submit -> score latency goes into the ``serve.latency_s`` histogram
        of the active metrics registry (one clock read per batch; with no
        registry, nothing is recorded). Returns how many requests it
        marked; a second call without a new drain marks 0."""
        with self._lock:
            ts, self._last_drained_ts = self._last_drained_ts, []
        if not ts:
            return 0
        hist = obs_registry.histogram("serve.latency_s")
        now = self.clock()
        for t in ts:
            hist.observe(now - t)
        return len(ts)

    def register_metrics(self, registry=None) -> None:
        """Mirror :attr:`stats` and the live queue depth onto a
        ``repro_torch.obs`` metrics registry (``registry``, or the active
        one) as lazy read-only callbacks (``serve.batcher``,
        ``serve.queue``); ``_stats`` stays the source of truth, bit for bit
        the same with a registry or without. Called at construction (a
        no-op with no registry active); call again to attach to a registry
        activated later."""
        reg = obs_registry.get_registry() if registry is None else registry
        if reg is None:
            return
        reg.register_callback("serve.batcher", lambda: self.stats)
        reg.register_callback("serve.queue", lambda: {"depth": len(self)})
