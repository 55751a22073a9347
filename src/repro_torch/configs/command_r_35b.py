"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified] — dense GQA,
no biases, large 256k vocabulary (embedding table dominates memory)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    tie_embeddings=True,
    rope_theta=8e6,
)
