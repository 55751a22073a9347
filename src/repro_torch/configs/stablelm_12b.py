"""StableLM-2-12B [hf:stabilityai; hf] — dense GQA, head_dim 160.

Its head_dim exceeds the Fetch kernel's D <= 128: on the card its decode
attention raises (``kernels/fused_kv_attn.py``); the CPU path serves it."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    rope_theta=1e4,
)
