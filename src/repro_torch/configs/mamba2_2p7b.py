# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""mamba2-2.7b [ssm] -- SSD (state-space duality) [arXiv:2405.21060], as
``repro/configs/mamba2_2p7b.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    citation="arXiv:2405.21060 (Mamba-2 / SSD), mamba2-2.7b card",
    num_layers=64,
    d_model=2560,
    d_ff=0,                      # attention-free, no separate MLP: Mamba2 blocks only
    vocab_size=50280,            # padded to 50432 for 16-way vocab sharding
    ssm=SSMConfig(
        d_state=128,
        head_dim=64,             # -> 80 SSD heads (d_inner = 5120)
        expand=2,
        conv_width=4,
        chunk_size=256,
    ),
    norm="rmsnorm",
    tie_embeddings=True,
    optimizer="adamw",
    long_context_mode="native",  # O(1)-state decode
)
