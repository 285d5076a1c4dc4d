# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Steps of the LM zoo (counterpart of ``repro.train``): prefill and
decode so far; the training step is not ported yet."""
from repro_torch.train.train_step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
