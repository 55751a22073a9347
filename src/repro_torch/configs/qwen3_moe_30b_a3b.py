"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf] — 128-expert top-8 fine-grained
MoE with qk-norm."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    d_ff_expert=768,
    n_experts=128,
    top_k=8,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)
