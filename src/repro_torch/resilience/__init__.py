# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Resilience, the counterpart of ``repro.resilience``: fault injection,
recovery and the progress store behind resumable paths.

* :mod:`~repro_torch.resilience.inject` -- a deterministic, seeded
  fault-injection harness (NaN/Inf poisoning of the margins or working
  statistics at a chosen outer iteration, a forced line-search stall,
  checkpoint corruption, kill-after-N-path-points, lost slab buckets,
  serve latency and swap/load failures), driven by the tests and by
  ``python -m repro_torch.launch.chaos_glm``;
* :mod:`~repro_torch.resilience.retry` -- bounded exponential-backoff
  retry for the residency puts and the serve loop's swap and load;
* :mod:`~repro_torch.resilience.progress` -- the per-lambda progress
  store behind ``LogisticL1.path(checkpoint_every=, resume_from=)``:
  rotated slots, an atomic pointer, roll-back to the last good slot.

The numerical guardrails themselves live in the solver loop
(``core.engine``: the ``status`` code).
"""
from repro_torch.resilience.inject import (
    EngineFault,
    FaultPlan,
    InjectedFault,
    InjectedKill,
    active_plan,
    arm_engine_fault,
    corrupt_checkpoint,
    inject_faults,
    maybe_kill,
    serve_delay,
    take_load_failure,
    take_prefetch_failure,
    take_swap_failure,
)
from repro_torch.resilience.progress import PathProgress, foreign_layout, rank_directory
from repro_torch.resilience.retry import RetriesExhausted, retry_call

__all__ = ["EngineFault", "FaultPlan", "InjectedFault", "InjectedKill", "PathProgress",
           "RetriesExhausted", "active_plan", "arm_engine_fault", "corrupt_checkpoint",
           "foreign_layout", "inject_faults", "maybe_kill", "rank_directory", "retry_call",
           "serve_delay", "take_load_failure", "take_prefetch_failure", "take_swap_failure"]
