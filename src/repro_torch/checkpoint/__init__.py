# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Checkpoints in the reference's on-disk format (``repro.checkpoint``):
a path saved by either package loads in the other."""
from repro_torch.checkpoint.checkpointer import (CheckpointCorruption, load_pytree,
                                                 read_meta, save_pytree, verify_payload)

__all__ = ["CheckpointCorruption", "load_pytree", "read_meta", "save_pytree",
           "verify_payload"]
