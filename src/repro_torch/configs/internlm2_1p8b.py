# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""internlm2-1.8b [dense] -- GQA [arXiv:2403.17297], as
``repro/configs/internlm2_1p8b.py``."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    citation="arXiv:2403.17297 (InternLM2)",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92544,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000.0,
    ),
    norm="rmsnorm",
    act="silu",
    optimizer="adamw",
    long_context_mode="sliding_window",
)
