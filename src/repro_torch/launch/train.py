"""Training launcher (the port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3_1_7b --steps 50
    python -m repro_torch.launch.train --arch mamba2_1_3b --steps 30 --resume
    python -m repro_torch.launch.train --device cpu ...   # no card
    python -m repro_torch.launch.train --device cpu --mesh 2,1,2 --grad-compress

It trains the smoke-size model of ``--arch`` on byte-level text or Zipfian
synthetic tokens with the ``Trainer``: AdamW, remat, periodic checkpoints,
preemption on SIGTERM / SIGINT and resume.  Meshes as the reference picks
them: ``--production`` trains the full config on
``make_production_mesh(multi_pod=--multi-pod)`` (16x16, or 2x16x16 with a
"pod" axis), and exits 2 naming the count where fewer devices exist;
otherwise ``make_host_mesh`` over the cards (one card: a 1x1 mesh, the
unsharded run), or ``--mesh data,model`` / ``pod,data,model``.
``--device cpu`` trains on the CPU: one device, or ``--mesh``'s count of
logical CPU shards.  ``--grad-compress`` compresses the cross-pod gradient
wherever the mesh has a "pod" axis (``train.step``).
"""

from __future__ import annotations

import argparse
import dataclasses
import math

from repro_torch.data.pipeline import SyntheticCorpus, TextCorpus
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh, make_train_mesh,
                                     parse_train_mesh)
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
                    help="the full config on the 16x16 production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production: the 2x16x16 (pod, data, model) mesh")
    ap.add_argument("--mesh", default=None,
                    help="'data,model' or 'pod,data,model' (default: the host mesh)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true",
                    help="cross-pod error-feedback int8 all-reduce (on a mesh with a pod axis)")
    ap.add_argument("--data", choices=["text", "synthetic"], default="text")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains: the card (default) or the CPU")
    args = ap.parse_args(argv)

    devices = ["cpu"] if args.device == "cpu" else None  # None: the cards
    try:
        if args.production:
            cfg = registry.get_config(args.arch)
            mesh = make_production_mesh(multi_pod=args.multi_pod, devices=devices)
        else:
            cfg = registry.get_smoke_config(args.arch)
            if args.mesh:
                n = math.prod(parse_train_mesh(args.mesh))
                mesh = make_train_mesh(args.mesh, None if devices is None else devices * n)
            else:
                mesh = make_host_mesh(devices=devices)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
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
    trainer = Trainer(cfg, scfg, tcfg, data, mesh=mesh)
    trainer.install_signal_handlers()
    if args.resume:
        resumed = trainer.maybe_resume()
        print(f"resume: {'ok, from step ' + str(trainer.start_step) if resumed else 'no checkpoint'}")
    summary = trainer.run()
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    main()
