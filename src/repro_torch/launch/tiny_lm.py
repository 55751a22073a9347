"""The shared tiny byte-level LM (the port of ``repro.launch.tiny_lm``; the
accuracy proxy of DESIGN.md §6).

One tiny LM trained on real text stands in, at small scale, for the
paper's Llama2 / Ministral experiments: ``examples/serve_compressed_torch.py``
serves it through every cache layout.  The config, sequence length, step
count and optimizer settings are the reference's.  Its checkpoint cache is
``artifacts/tiny_lm_torch`` (gitignored), apart from the reference's
``artifacts/tiny_lm``: the two packages never read each other's format.
"""

from __future__ import annotations

from pathlib import Path

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import TextCorpus
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import Trainer, TrainerConfig

# repo_root/artifacts/tiny_lm_torch (this file lives at src/repro_torch/launch/).
CKPT = Path(__file__).resolve().parents[3] / "artifacts" / "tiny_lm_torch"

TINY = ModelConfig(
    name="tiny-byte-lm", family="dense", n_layers=4, d_model=256,
    vocab_size=256, n_heads=8, n_kv_heads=4, head_dim=32, d_ff=512,
    cache_block=32, rel_scale_k=0.05, rel_scale_v=0.15)

SEQ = 128
STEPS = 300


def train_tiny_lm(data: TextCorpus, steps: int = STEPS, device="cuda",
                  ckpt_dir=None) -> Trainer:
    """Train TINY from seed 0 for ``steps`` steps with the reference's
    optimizer settings (its final checkpoint in ``ckpt_dir``, by default
    ``CKPT / "_train"``); returns the Trainer (its ``state`` and its
    ``metrics_log``, the loss curve)."""
    scfg = step_lib.TrainStepConfig(
        remat=False, q_chunk=SEQ, kv_chunk=SEQ,
        opt=adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps))
    trainer = Trainer(TINY, scfg,
                      TrainerConfig(total_steps=steps, ckpt_every=0, log_every=50,
                                    ckpt_dir=str(ckpt_dir or CKPT / "_train")),
                      data, device=device)
    out = trainer.run()
    print(f"[tiny_lm] trained: {out['final_step']} steps, loss {out['last_loss']:.3f}")
    return trainer


def get_tiny_lm(steps: int = STEPS, force: bool = False, device="cuda"):
    """Train (or load from the checkpoint cache) the tiny LM on ``device``.
    Returns (cfg, params, corpus)."""
    dev = resolve_device(device)
    data = TextCorpus(seq_len=SEQ, global_batch=8, max_bytes=2 << 20)
    if not force and store.latest_step(CKPT) is not None:
        like = M.init_params(TINY, seed=0, device=dev, dtype=step_lib.dtype_of(TINY.dtype))
        params, _ = store.restore(CKPT, like)
        return TINY, params, data
    trainer = train_tiny_lm(data, steps, dev)
    params = trainer.state[0]
    store.save(CKPT, steps, params, {"loss": trainer.metrics_log[-1]["loss"]})
    return TINY, params, data
