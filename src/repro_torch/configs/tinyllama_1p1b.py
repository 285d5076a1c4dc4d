# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""tinyllama-1.1b [dense] -- llama2-arch small [arXiv:2401.02385], as
``repro/configs/tinyllama_1p1b.py``."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    citation="arXiv:2401.02385 (TinyLlama)",
    num_layers=22,
    d_model=2048,
    d_ff=5632,
    vocab_size=32000,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,             # 2048 / 32
        rope_theta=10000.0,
    ),
    norm="rmsnorm",
    act="silu",
    optimizer="adamw",
    long_context_mode="sliding_window",
)
