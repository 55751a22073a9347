"""End-to-end training with the PyTorch port: train a byte-level LM on real
on-disk text with the whole training stack (the train step, AdamW,
checkpointing, the straggler monitor, preemption handling), then resume
from the checkpoint and train on.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]

It runs on the card unless ``--device cpu`` is given; the same Trainer and
step builder train the full configs (``python -m repro_torch.launch.train
--production``).
"""

import argparse
import dataclasses
import tempfile

from repro_torch.data.pipeline import TextCorpus
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="kvcomp_train_")

    cfg = dataclasses.replace(registry.get_smoke_config("llama2_7b"), vocab_size=256,
                              d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                              head_dim=32, d_ff=256)
    data = TextCorpus(seq_len=128, global_batch=8, max_bytes=2 << 20)
    scfg = step_lib.TrainStepConfig(
        remat=True, microbatches=2, q_chunk=128, kv_chunk=128,
        opt=adamw.AdamWConfig(lr=3e-3, warmup_steps=args.steps // 10,
                              total_steps=args.steps))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.steps // 2,
                         ckpt_dir=ckpt_dir, log_every=20)
    trainer = Trainer(cfg, scfg, tcfg, data, device=args.device)
    trainer.install_signal_handlers()
    summary = trainer.run()
    print("first run:", summary)

    # checkpoint / restart: extend training from the checkpoint
    trainer2 = Trainer(cfg, scfg, TrainerConfig(total_steps=args.steps + 20, ckpt_every=0,
                                                ckpt_dir=ckpt_dir, log_every=20),
                       data, device=args.device)
    assert trainer2.maybe_resume(), "expected a checkpoint to resume from"
    print(f"resumed from step {trainer2.start_step}")
    second = trainer2.run()
    print("second run:", second)
    return summary, second


if __name__ == "__main__":
    main()
