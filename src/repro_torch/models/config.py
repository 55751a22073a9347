"""Model configuration: the dense-family fields plus the ``cache_*`` block.

The port's own copy of ``repro.models.config.ModelConfig`` (same field names
and defaults) restricted to what this slice serves: the dense decoder family.
The paper's technique (compressed KV cache) is a config block, so a model
flips between raw / kivi / packed caches without touching model code.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" is served by this slice of the port
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
        """Analytic parameter count of the dense family."""
        d, v, dh = self.d_model, self.vocab_size, self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return emb + self.n_layers * per_layer + d


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
        d_ff=128,
        sliding_window=64 if cfg.sliding_window else None,
        cache_block=8,
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
