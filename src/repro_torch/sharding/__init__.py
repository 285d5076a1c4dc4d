# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Mesh collection helpers (counterpart of ``repro.sharding``): the
feature- and example-axis collection of pieces held by the ranks of a
``launch.mesh`` mesh."""
from repro_torch.sharding.collect import concat_replicated, replicate

__all__ = ["concat_replicated", "replicate"]
