"""HuBERT-XLarge [arXiv:2106.07447; unverified] — encoder-only audio
transformer (w2v2 architecture).  The CNN waveform frontend is a stub:
``input_specs`` provides precomputed frame embeddings [B, S, d].  No
autoregressive decode → no KV cache → decode/long shapes are skipped
(DESIGN.md §4); the 504-way head mirrors the cluster-prediction task."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="dense",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    causal=False,
    input_mode="embeddings",
    rope_theta=1e4,
)
