# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Configurations of the port (counterpart of ``repro.configs``):
``get_config("<id>")`` for the GLM workloads and for the LM architectures
the port can run (``MODEL_CONFIGS``: tinyllama-1.1b so far)."""
from repro_torch.configs.glm import GLM_CONFIGS
from repro_torch.configs.tinyllama_1p1b import CONFIG as _TINYLLAMA

MODEL_CONFIGS = {c.name: c for c in (_TINYLLAMA,)}


def get_config(name: str):
    """Look up a registered config (LM architecture or GLM workload)."""
    for table in (MODEL_CONFIGS, GLM_CONFIGS):
        if name in table:
            return table[name]
    raise KeyError(f"unknown arch {name!r}; have {sorted(MODEL_CONFIGS) + sorted(GLM_CONFIGS)}")
