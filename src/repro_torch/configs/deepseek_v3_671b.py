# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""deepseek-v3-671b [moe] -- MLA, 1 shared + 256 routed top-8 experts, MTP
[arXiv:2412.19437], as ``repro/configs/deepseek_v3_671b.py``.

The optimizer is Adafactor, as the reference's: AdamW's two moments for
671B parameters would not fit the reference's mesh even fully sharded.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    citation="arXiv:2412.19437 (DeepSeek-V3)",
    num_layers=61,
    d_model=7168,
    d_ff=18432,                  # dense-MLP width for the first dense layers
    vocab_size=129280,
    attention=AttentionConfig(
        num_heads=128,
        num_kv_heads=128,        # MLA: latent cache, head count for Q/compute
        head_dim=128,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        rope_theta=10000.0,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        num_shared_experts=1,
        expert_d_ff=2048,        # assignment table d_ff=2048 = per-expert width
        capacity_factor=1.25,
        aux_loss_weight=0.0001,  # DSv3 uses aux-loss-free balancing; keep tiny aux
    ),
    first_dense_layers=3,        # DeepSeek-V3 keeps the first 3 layers dense
    mtp_depth=1,                 # one MTP head (DeepSeek-V3 MTP)
    norm="rmsnorm",
    act="silu",
    microbatch=16,
    optimizer="adafactor",
    long_context_mode="sliding_window",
)
