"""Llama2-7B-shape config (paper evaluation model, §4.1)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
)
