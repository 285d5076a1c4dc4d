# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Bounded exponential-backoff retry, the port's copy of
``repro/resilience/retry.py`` ``retry_call`` and ``RetriesExhausted``.

The residency manager's bucket puts, ``PathStore.swap`` and
``PathStore.from_checkpoint`` cross a boundary that can fail transiently
(a device allocation, a checkpoint directory mid-rotation); wrapping
them here keeps the failure typed and bounded.

The sleep is injectable so tests run at full speed. When a metrics
registry is active (``repro_torch.obs``), each retried failure bumps the
process-wide ``retry.retries`` counter and each give-up bumps
``retry.exhausted``; ``on_retry`` remains the per-call-site hook for
legacy counters.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from repro_torch.obs import registry as _metrics

T = TypeVar("T")


class RetriesExhausted(RuntimeError):
    """All attempts failed; ``__cause__`` is the last underlying error."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"gave up after {attempts} attempts: "
            f"{type(last).__name__}: {last}")
        self.attempts = attempts
        self.last = last


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 1.0,
    retry_on: Tuple[Type[BaseException], ...] = (RuntimeError, OSError),
    sleep: Optional[Callable[[float], None]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> T:
    """Call ``fn()`` with up to ``attempts`` tries and exponential backoff.

    Delays run ``base_delay_s * 2**k`` capped at ``max_delay_s``. Only
    exceptions in ``retry_on`` are retried; anything else propagates at
    once (a typed rejection such as ``Overloaded`` must not be retried
    into a success). ``sleep`` replaces ``time.sleep`` for the backoff.
    ``on_retry(attempt_index, error)`` fires before each backoff sleep.
    Raises :class:`RetriesExhausted` (chaining the last error) when every
    attempt fails.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    do_sleep = time.sleep if sleep is None else sleep
    last: Optional[BaseException] = None
    for k in range(attempts):
        try:
            return fn()
        except retry_on as err:
            last = err
            if k + 1 >= attempts:
                break
            if on_retry is not None:
                on_retry(k, err)
            _metrics.counter("retry.retries").inc()
            do_sleep(min(base_delay_s * (2.0 ** k), max_delay_s))
    _metrics.counter("retry.exhausted").inc()
    raise RetriesExhausted(attempts, last) from last
