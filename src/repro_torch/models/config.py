"""Model configuration: one dataclass drives every architecture family
(dense, MoE, ssm, hybrid) plus the ``cache_*`` block.

The port's own copy of ``repro.models.config.ModelConfig``, with the same
fields and defaults.  The paper's technique (compressed KV cache) is a
config block, so a model flips between raw / kivi / packed / huffman caches
without touching model code.  ``dtype`` is the training parameters' dtype
(``train.trainer``); serving takes whatever parameters it is given.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    # mlp
    d_ff: int = 0
    # structure
    encoder_only: bool = False
    causal: bool = True
    tie_embeddings: bool = False
    input_mode: str = "tokens"  # tokens | embeddings (audio/vlm frontend stub)
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # hybrid (Zamba2-style): every ``hybrid_period``-th block is a SHARED
    # attention+MLP block; the rest are Mamba2 blocks.
    hybrid_period: int = 0
    # KV-cache compression (the paper's technique): ``cache_layout`` names a
    # registered repro_torch.core.layouts.CacheLayout; ``cache_overrides``
    # is a tuple of repro_torch.core.policy.LayerOverride.
    cache_layout: str = "packed"
    cache_block: int = 64
    rel_scale_k: float = 0.05
    rel_scale_v: float = 0.15
    kivi_bits: int = 2
    cache_overrides: tuple = ()
    cache_mode: str = "dense"  # "dense" | "paged" (repro_torch.core.pool)
    # Decode-attention backend (repro_torch.kernels.ops registry): "auto"
    # runs the fused Fetch kernel for CUDA tensors and the blockwise scan on
    # the CPU; "xla"/"fused" pin a path.
    attn_backend: str = "auto"
    # Blockwise-scan knobs (None = REPRO_BLOCKWISE_* env / module default;
    # repro_torch.core.cache.blockwise_knobs).
    cache_span_tokens: int | None = None
    cache_unroll_max: int | None = None
    # numerics
    dtype: str = "bfloat16"

    def compression_policy(self):
        """The cache_* fields + overrides as one CompressionPolicy."""
        from repro_torch.core.policy import CompressionPolicy, TensorPolicy

        return CompressionPolicy(
            layout=self.cache_layout,
            block_size=self.cache_block,
            k=TensorPolicy(rel_scale=self.rel_scale_k),
            v=TensorPolicy(rel_scale=self.rel_scale_v),
            kivi_bits=self.kivi_bits,
            attn_backend=self.attn_backend,
            mode=self.cache_mode,
            span_tokens=self.cache_span_tokens,
            unroll_max=self.cache_unroll_max,
            overrides=tuple(self.cache_overrides),
        )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "hybrid")

    @property
    def supports_long_context_decode(self) -> bool:
        """Sub-quadratic long decode: ssm and hybrid natively, a sliding
        window by its cap."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count of the four families."""
        d, v = self.d_model, self.vocab_size
        dh = self.resolved_head_dim if self.n_heads else 0
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        mlp = 3 * d * self.d_ff
        if self.family == "dense":
            return emb + self.n_layers * (attn + mlp + 2 * d) + d
        if self.family == "moe":
            moe = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            return emb + self.n_layers * (attn + moe + 2 * d) + d
        di, N, G, H = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
        mamba = (d * (2 * di + 2 * G * N + H) + (di + 2 * G * N) * self.ssm_conv
                 + di * d + 2 * H + di + d)
        if self.family == "ssm":
            return emb + self.n_layers * mamba + d
        if self.family == "hybrid":
            n_mamba = self.n_layers - self.n_layers // self.hybrid_period
            return emb + n_mamba * mamba + (attn + mlp + 2 * d) + d  # ONE shared block
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        per_expert = self.n_layers * 3 * self.d_model * self.d_ff_expert
        return self.param_count() - (self.n_experts - self.top_k) * per_expert


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-size variant of the same family (CPU-runnable); the same
    cut as the reference's ``reduced``."""
    base = dict(
        n_layers=2,
        d_model=64,
        vocab_size=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16 if cfg.ssm_state else 128,
        sliding_window=64 if cfg.sliding_window else None,
        hybrid_period=3 if cfg.hybrid_period else 0,
        cache_block=8,
        name=cfg.name + "-smoke",
    )
    if cfg.hybrid_period:
        base["n_layers"] = 7  # 2 periods of 3 + 1 remainder
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
