"""Training launcher (the port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3_1_7b --steps 50
    python -m repro_torch.launch.train --arch mamba2_1_3b --steps 30 --resume
    python -m repro_torch.launch.train --device cpu ...   # no card

It trains the smoke-size model of ``--arch`` (``--production``: the full
config) on byte-level text or Zipfian synthetic tokens with the
``Trainer``: AdamW, remat, periodic checkpoints, preemption on SIGTERM /
SIGINT and resume.  It runs on the card unless ``--device cpu`` is given.
``--multi-pod`` is refused: sharded training is a later slice of the port,
as ``ServerConfig.mesh`` is for serving.  ``--grad-compress`` is taken and,
on one device, read by nothing (``train.step``).
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.data.pipeline import SyntheticCorpus, TextCorpus
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--production", action="store_true",
                    help="the full config, on one device")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: sharded training is a later slice of the port")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true",
                    help="cross-pod error-feedback int8 all-reduce (read by "
                         "nothing on one device)")
    ap.add_argument("--data", choices=["text", "synthetic"], default="text")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains: the card (default) or the CPU")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod is not served: sharded training is a later slice of the "
                 "port (multi-GPU sharding)")

    cfg = (registry.get_config(args.arch) if args.production
           else registry.get_smoke_config(args.arch))
    if args.data == "text" and cfg.input_mode == "tokens":
        cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, 256))
        data = TextCorpus(seq_len=args.seq, global_batch=args.batch)
        data.vocab_size = cfg.vocab_size
    else:
        data = SyntheticCorpus(seq_len=args.seq, global_batch=args.batch,
                               vocab_size=cfg.vocab_size)

    scfg = step_lib.TrainStepConfig(
        remat=True, microbatches=args.microbatches,
        q_chunk=min(512, args.seq), kv_chunk=min(512, args.seq),
        cross_pod_grad_compress=args.grad_compress,
        opt=adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_every=5)
    trainer = Trainer(cfg, scfg, tcfg, data, device=args.device)
    trainer.install_signal_handlers()
    if args.resume:
        resumed = trainer.maybe_resume()
        print(f"resume: {'ok, from step ' + str(trainer.start_step) if resumed else 'no checkpoint'}")
    summary = trainer.run()
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    main()
