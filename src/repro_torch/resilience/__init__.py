# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Resilience, the counterpart of ``repro.resilience``: so far only the
bounded retry (:mod:`repro_torch.resilience.retry`) that the residency
puts, ``PathStore.swap`` and ``PathStore.from_checkpoint`` run under."""
from repro_torch.resilience.retry import RetriesExhausted, retry_call

__all__ = ["RetriesExhausted", "retry_call"]
