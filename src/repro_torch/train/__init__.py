# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Counterpart of ``repro.train``: the LM zoo's steps (prefill and decode
so far; the training step is not ported yet) and the GLM path's
evaluation metrics (:mod:`repro_torch.train.metrics`)."""
from repro_torch.train.train_step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
