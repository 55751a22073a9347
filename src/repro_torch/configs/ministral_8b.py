"""Ministral-8B-shape config (paper evaluation model, §4.1) — GQA + SWA."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="ministral-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=131072,
    sliding_window=32768,
    rope_theta=1e8,
)
