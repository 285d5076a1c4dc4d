# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The port's front door (counterpart of ``repro.api``): one estimator,
one design per data layout (dense only so far)."""
from repro_torch.api.convert import from_reference
from repro_torch.api.design import DenseDesign
from repro_torch.api.estimator import LogisticL1
from repro_torch.api.strategy import Strategy, resolve

__all__ = ["DenseDesign", "LogisticL1", "Strategy", "from_reference", "resolve"]
