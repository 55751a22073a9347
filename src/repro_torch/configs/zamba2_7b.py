"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 backbone with SHARED
attention blocks every 6th position (81 blocks: 13×(5 mamba + 1 shared attn)
+ 3 tail mamba).  Attention layers carry compressed KV caches; mamba layers
carry constant-size state → hybrid long_500k runs."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    hybrid_period=6,
    rope_theta=1e4,
)
