# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""PyTorch port of the d-GLMNET package ``repro`` for one NVIDIA H100.

Importing the package applies the process-wide float32 precision policy
(:mod:`repro_torch.device`). The front door mirrors ``repro.api``::

    from repro_torch.api import DenseDesign, LogisticL1
    LogisticL1(opts, device="cuda").fit(DenseDesign(X), y, lam)

Entry points run on the card; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the host.
"""
from repro_torch.device import apply_precision_policy, resolve_device

apply_precision_policy()

__all__ = ["apply_precision_policy", "resolve_device"]
