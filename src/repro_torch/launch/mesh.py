# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The port's mesh description, the counterpart of ``repro/launch/mesh.py``
``make_dev_mesh``.

The reference's mesh has a ``data`` axis (example shards) and a
``model`` axis (feature blocks, the paper's M machines). On one card the
``model`` axis is the leading batch axis the port already runs the M
blocks on (``core.subproblem.layout_blocks``), so a mesh here is only a
description: its shape, its axis names and the device the solve runs on.
A ``data`` extent above 1 needs example shards on several cards and
collectives, which the multi-GPU slice adds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

AXIS_NAMES: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class DevMesh:
    """A (data, model) mesh on one device; ``data`` is 1."""

    data: int
    model: int
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, str]:
        return AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_dev_mesh(data: int = 1, model: int = 4, *,
                  device=DEFAULT_DEVICE) -> DevMesh:
    """A (data, model) mesh on ``device`` (raises for ``"cuda"`` without a
    card). ``model`` feature blocks run as one batch on the device."""
    if model < 1:
        raise ValueError(f"model extent must be >= 1, got {model}")
    if data != 1:
        raise ValueError(
            f"data extent {data} needs example shards across cards and "
            f"collectives: not ported yet (ROADMAP queue 1, item 9); use "
            f"make_dev_mesh(1, model)")
    return DevMesh(data=1, model=int(model), device=resolve_device(device))
