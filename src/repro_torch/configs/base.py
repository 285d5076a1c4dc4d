# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Model and problem configurations, the counterpart of
``repro/configs/base.py``: the LM zoo's :class:`ModelConfig` with its
sub-configs (plain data; the port runs the dense attention with or
without QKV bias, MLA, MoE, multi-token prediction and Mamba2 SSD
architectures so far) and the paper's :class:`GLMConfig`."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# architecture type tags (as the reference's)
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"
GLM = "glm"
ARCH_TYPES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO, GLM)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard/Mixtral-style capacity routing)."""

    num_experts: int = 0
    top_k: int = 1
    num_shared_experts: int = 0      # DeepSeek-style always-on shared expert(s)
    expert_d_ff: int = 0             # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01    # load-balance loss
    router_z_loss_weight: float = 1e-3

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD sub-config (arXiv:2405.21060)."""

    d_state: int = 128
    head_dim: int = 64               # SSD "P"
    expand: int = 2                  # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256            # SSD chunked scan length
    ngroups: int = 1                 # B/C groups (GVA-style)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False           # Qwen-style
    rope_theta: float = 10000.0
    use_mrope: bool = False          # Qwen2-VL M-RoPE (3 rotary sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: int = 0          # 0 -> full attention
    # MLA (DeepSeek-V3, arXiv:2412.19437)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    def resolved_head_dim(self, d_model: int) -> int:
        if self.head_dim:
            return self.head_dim
        return d_model // max(self.num_heads, 1)


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: mostly-Mamba2 stack with a *shared* attention
    block applied at a fixed period (arXiv:2411.15242)."""

    attn_every: int = 6              # apply shared attention block each k layers
    shared_attn: bool = True         # one set of attention weights, reused


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (seamless-m4t, arXiv:2308.11596)."""

    enabled: bool = False
    encoder_seq_len: int = 4096      # frame-embedding memory length (stubbed frontend)


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend carve-out: precomputed patch/frame embeddings of
    this shape instead of raw pixels/waveform."""

    kind: str = "none"               # none | vision_patches | audio_frames
    tokens_per_item: int = 0         # e.g. ViT patches per image / frames per utterance
    embed_dim: int = 0               # frontend output dim (projector maps -> d_model)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    arch_type: str = DENSE
    citation: str = ""

    num_layers: int = 0
    d_model: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    max_seq_len: int = 532_480

    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: Optional[HybridConfig] = None
    encdec: EncDecConfig = field(default_factory=EncDecConfig)
    frontend: FrontendStub = field(default_factory=FrontendStub)

    first_dense_layers: int = 0      # MoE archs: leading layers with dense MLP
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "silu"                # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    mtp_depth: int = 0               # DeepSeek-V3 multi-token prediction heads

    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    optimizer: str = "adamw"         # adamw | adafactor | sgd
    microbatch: int = 1              # gradient-accumulation steps (train)

    # long-context policy
    long_context_mode: str = "sliding_window"   # native | sliding_window | skip
    long_context_window: int = 8192

    vocab_pad_to: int = 256

    # ----- derived -----------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def is_encdec(self) -> bool:
        return self.encdec.enabled

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'moe' | 'ssm' | 'hybrid_attn'."""
        if self.arch_type == SSM:
            return tuple("ssm" for _ in range(self.num_layers))
        if self.arch_type == HYBRID and self.hybrid is not None:
            k = self.hybrid.attn_every
            return tuple(
                "hybrid_attn" if (i % k) == (k - 1) else "ssm"
                for i in range(self.num_layers)
            )
        if self.moe.enabled:
            nd = self.first_dense_layers
            return tuple(
                "attn" if i < nd else "moe" for i in range(self.num_layers)
            )
        return tuple("attn" for _ in range(self.num_layers))

    def num_params(self) -> int:
        """Parameter count from the port's own shapes (meta tensors)."""
        from repro_torch.models.params import count_params_analytic

        return count_params_analytic(self)

    def num_active_params(self) -> int:
        """Parameters a token passes through: the routed expert stacks
        weighted by top_k / num_experts."""
        from repro_torch.models.params import count_params_analytic

        return count_params_analytic(self, active_only=True)

    # ----- reduced variants ---------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant: <=2 layers, d_model<=256, <=4 experts,
        float32; preserves every structural feature (GQA ratio, MLA, MoE
        routing, SSD, hybrid pattern, enc-dec, biases)."""
        d_model = min(self.d_model, 256)
        attn = self.attention
        if attn.num_heads:
            heads = min(attn.num_heads, 4)
            ratio = max(1, attn.num_heads // max(attn.num_kv_heads, 1))
            kv = max(1, heads // ratio)
            smoke_dh = 64 if attn.head_dim else 0
            half = (smoke_dh or (d_model // heads)) // 2
            sections = (half // 4, (3 * half) // 8, half - half // 4 - (3 * half) // 8)
            attn = replace(
                attn,
                num_heads=heads,
                num_kv_heads=kv,
                head_dim=smoke_dh,
                mrope_sections=sections if attn.use_mrope else attn.mrope_sections,
                q_lora_rank=min(attn.q_lora_rank, 64) if attn.q_lora_rank else 0,
                kv_lora_rank=min(attn.kv_lora_rank, 32) if attn.kv_lora_rank else 0,
                qk_rope_head_dim=min(attn.qk_rope_head_dim, 16) if attn.use_mla else attn.qk_rope_head_dim,
                qk_nope_head_dim=min(attn.qk_nope_head_dim, 32) if attn.use_mla else attn.qk_nope_head_dim,
                v_head_dim=min(attn.v_head_dim, 32) if attn.use_mla else attn.v_head_dim,
                sliding_window=min(attn.sliding_window, 64) if attn.sliding_window else 0,
            )
        moe = self.moe
        if moe.enabled:
            moe = replace(
                moe,
                num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2),
                num_shared_experts=min(moe.num_shared_experts, 1),
                expert_d_ff=min(moe.expert_d_ff or 128, 128),
            )
        ssm = replace(self.ssm, d_state=min(self.ssm.d_state, 16),
                      head_dim=min(self.ssm.head_dim, 32), chunk_size=32)
        hybrid = self.hybrid
        nl = min(self.num_layers, 2)
        if hybrid is not None:
            hybrid = replace(hybrid, attn_every=2)
        frontend = self.frontend
        if frontend.kind != "none":
            frontend = replace(frontend, tokens_per_item=min(frontend.tokens_per_item, 16),
                               embed_dim=min(frontend.embed_dim or 128, 128))
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=nl,
            d_model=d_model,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            attention=attn,
            moe=moe,
            ssm=ssm,
            hybrid=hybrid,
            frontend=frontend,
            first_dense_layers=min(self.first_dense_layers, nl - 1),
            max_seq_len=4096,
            long_context_window=64,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            mtp_depth=min(self.mtp_depth, 1),
        )


@dataclass(frozen=True)
class GLMConfig:
    """The paper's own problem: L1-regularized logistic regression.

    A synthetic twin of each Table-2 dataset; dims match the paper.
    """

    name: str = "glm"
    arch_type: str = GLM
    citation: str = "Trofimov & Genkin 2014, Table 2"
    num_examples: int = 0
    num_features: int = 0
    avg_nnz_per_example: int = 0     # density hint for synthetic twin
    density: float = 1.0             # fraction of nonzero entries
    lam_path_len: int = 20           # Algorithm 5: lambda_max * 2^{-i}

    # tiling for the Gram-CD solver
    feature_tile: int = 256

    def smoke(self) -> "GLMConfig":
        return replace(self, name=self.name + "-smoke",
                       num_examples=min(self.num_examples, 2048),
                       num_features=min(self.num_features, 128),
                       lam_path_len=4, feature_tile=32)
