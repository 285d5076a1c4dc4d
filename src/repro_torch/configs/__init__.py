# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Configurations of the port (counterpart of ``repro.configs``):
``get_config("<id>")`` for the GLM workloads and for the LM architectures
the port can run (``MODEL_CONFIGS``: the dense tinyllama-1.1b, qwen2.5-3b,
qwen1.5-4b (QKV bias) and internlm2-1.8b, the MoE llama4-scout-17b-a16e
and deepseek-v3-671b (MLA, MTP), and the SSD mamba2-2.7b so far), and
the reference's config classes and id tables. The input shapes
(``SHAPES``, ``InputShape``, ``get_shape``) come with
``configs/shapes.py`` (ROADMAP queue 1 item 5.11)."""
from repro_torch.configs.base import (ARCH_TYPES, AttentionConfig, EncDecConfig, FrontendStub,
                                      GLMConfig, HybridConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.configs.deepseek_v3_671b import CONFIG as _DEEPSEEK_V3
from repro_torch.configs.glm import GLM_CONFIGS
from repro_torch.configs.internlm2_1p8b import CONFIG as _INTERNLM2
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _LLAMA4_SCOUT
from repro_torch.configs.mamba2_2p7b import CONFIG as _MAMBA2
from repro_torch.configs.qwen1_5_4b import CONFIG as _QWEN1_5
from repro_torch.configs.qwen2_5_3b import CONFIG as _QWEN2_5
from repro_torch.configs.tinyllama_1p1b import CONFIG as _TINYLLAMA

MODEL_CONFIGS = {c.name: c for c in (_TINYLLAMA, _LLAMA4_SCOUT, _MAMBA2, _QWEN2_5, _QWEN1_5,
                                     _INTERNLM2, _DEEPSEEK_V3)}
ALL_CONFIGS = {**MODEL_CONFIGS, **GLM_CONFIGS}
ARCH_IDS = tuple(MODEL_CONFIGS)
GLM_IDS = tuple(GLM_CONFIGS)

__all__ = ["ALL_CONFIGS", "ARCH_IDS", "ARCH_TYPES", "AttentionConfig", "EncDecConfig",
           "FrontendStub", "GLMConfig", "GLM_CONFIGS", "GLM_IDS", "HybridConfig",
           "MODEL_CONFIGS", "ModelConfig", "MoEConfig", "SSMConfig", "get_config"]


def get_config(name: str):
    """Look up a registered config (LM architecture or GLM workload)."""
    if name in ALL_CONFIGS:
        return ALL_CONFIGS[name]
    raise KeyError(f"unknown arch {name!r}; have {sorted(MODEL_CONFIGS) + sorted(GLM_CONFIGS)}")
