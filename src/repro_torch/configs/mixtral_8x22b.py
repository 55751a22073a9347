"""Mixtral-8x22B [arXiv:2401.04088; hf] — 8-expert top-2 MoE with
sliding-window attention (window 4096, as in Mixtral v0.1's SWA lineage).
SWA makes long_500k decode sub-quadratic: the cache ring holds only the
window, evicting whole compression blocks (DESIGN.md §4)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    d_ff_expert=16384,
    n_experts=8,
    top_k=2,
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1e6,
)
