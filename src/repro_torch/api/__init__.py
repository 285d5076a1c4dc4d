# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The port's front door (counterpart of ``repro.api``): one estimator,
one design per data layout (dense, by-feature slabs, and either on a
(1, M) mesh)."""
from repro_torch.api.convert import from_reference, lm_params_from_reference
from repro_torch.api.design import DenseDesign, ShardedDesign, SlabDesign, as_design
from repro_torch.api.estimator import LogisticL1, lambda_max_design
from repro_torch.api.strategy import Strategy, resolve

__all__ = ["DenseDesign", "LogisticL1", "ShardedDesign", "SlabDesign", "Strategy",
           "as_design", "from_reference", "lambda_max_design", "lm_params_from_reference",
           "resolve"]
