"""Model configuration: the decoder families' fields plus the ``cache_*``
block.

The port's own copy of ``repro.models.config.ModelConfig`` (same field names
and defaults) restricted to what the port serves: the dense and MoE decoder
families (the ssm and hybrid families, and the encoder-only options, belong
to a later slice).  The paper's technique (compressed KV cache) is a config
block, so a model flips between raw / kivi / packed / huffman caches without
touching model code.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" (ssm and hybrid are a later slice)
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
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
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
            overrides=tuple(self.cache_overrides),
        )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count of the dense and MoE families."""
        d, v, dh = self.d_model, self.vocab_size, self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        if self.family == "dense":
            ffn = 3 * d * self.d_ff
        elif self.family == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
        else:
            raise ValueError(self.family)
        return emb + self.n_layers * (attn + ffn + 2 * d) + d

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
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        sliding_window=64 if cfg.sliding_window else None,
        cache_block=8,
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
