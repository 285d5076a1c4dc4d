# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Device and precision policy for the port.

* Entry points take an explicit ``device=`` and default to ``"cuda"``.
  Without a card they raise unless the caller asked for ``"cpu"``: a
  solve never drops to the host by itself.
* Float32 products stay float32: TF32 is off for matmuls and cuDNN, and
  the matmul precision is ``"highest"`` (the reference's XLA products
  are full float32, and TF32 keeps about three decimal digits).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def apply_precision_policy() -> None:
    """Pin float32 matmuls and convolutions to full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device
    when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and none is available; "
            f"pass device='cpu' to run the plain PyTorch versions on the host")
    return dev
