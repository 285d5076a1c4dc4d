# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""qwen1.5-4b [dense] -- QKV bias, MHA-style GQA (kv == H)
[hf:Qwen/Qwen1.5-0.5B family], as ``repro/configs/qwen1_5_4b.py``.

20 heads do not divide a 16-way model axis: the reference shards its
attention on the d_model input dim instead of heads (its sharding rules'
fallback).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    citation="hf:Qwen/Qwen1.5-0.5B (family card); assignment table",
    num_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    optimizer="adamw",
    long_context_mode="sliding_window",
)
