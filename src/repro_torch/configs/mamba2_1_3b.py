"""Mamba2-1.3B [arXiv:2405.21060; unverified] — attention-free SSD.

No KV cache exists, so the paper's technique is inapplicable (DESIGN.md §4
"Arch-applicability"); the arch is implemented without it and long_500k runs
natively on the constant-size state."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)
