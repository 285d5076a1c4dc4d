# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""qwen2.5-3b [dense] -- GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B family], as
``repro/configs/qwen2_5_3b.py``."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    citation="hf:Qwen/Qwen2.5-0.5B (family card); assignment table",
    num_layers=36,
    d_model=2048,
    d_ff=11008,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=2,
        head_dim=128,
        qkv_bias=True,           # Qwen2.5 uses Q/K/V bias
        rope_theta=1_000_000.0,
    ),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    optimizer="adamw",
    long_context_mode="sliding_window",
)
