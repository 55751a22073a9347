"""Chameleon-34B [arXiv:2405.09818; unverified] — early-fusion VLM backbone.

VQ image tokens share the 65536-entry unified vocabulary with text, so the
backbone is a dense GQA decoder served on token ids (the image tokenizer is
not part of the port).  Chameleon uses qk-norm for training stability."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    rope_theta=1e4,
)
