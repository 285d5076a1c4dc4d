# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""llama4-scout-17b-a16e [moe] -- 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E], as
``repro/configs/llama4_scout_17b_a16e.py``.

"Early fusion" refers to interleaved multimodal tokens; the text path is
what runs here (the vision tower is outside this entry's scope).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E model card",
    num_layers=48,
    d_model=5120,
    d_ff=8192,                   # shared-expert / dense width
    vocab_size=202048,
    attention=AttentionConfig(
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500_000.0,
        sliding_window=0,        # full attention
    ),
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        num_shared_experts=1,
        expert_d_ff=8192,
        capacity_factor=1.25,
    ),
    norm="rmsnorm",
    act="silu",
    microbatch=4,
    optimizer="adamw",
    long_context_mode="sliding_window",
)
