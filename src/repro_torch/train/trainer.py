"""The fault-tolerant training loop (the port of ``repro.train.trainer``).

* checkpoint and restart: periodic asynchronous checkpoints, and on start a
  resume from the latest committed step (``maybe_resume``);
* preemption: SIGTERM / SIGINT set a flag; the loop finishes the current
  step, writes a final checkpoint and returns;
* a straggler monitor: an EWMA of each step's wall time; steps slower than
  ``straggler_factor`` times it are recorded;
* deterministic data resume: the pipeline is a pure function of the step.

Without a mesh the trainer runs on one device: the card unless it is
given ``device="cpu"``.  Given ``mesh=`` (``launch.mesh``), it trains with
``train.step.build_train_artifacts``: the parameters, moments and ``err``
placed as pieces by the shardings, each batch placed by
``batch_sharding``, and ``maybe_resume`` restores onto the current mesh,
whatever mesh wrote the checkpoint.  A caller may set ``trainer.state``
before ``run``, as in the reference (plain tensors are placed on the mesh
when the run starts).
"""

from __future__ import annotations

import dataclasses
import signal
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1


class StragglerMonitor:
    """Wall-time EWMA that flags slow steps; ``clock`` is injectable."""

    def __init__(self, factor: float, alpha: float, clock=time.monotonic):
        self.factor = factor
        self.alpha = alpha
        self.clock = clock
        self.ewma: float | None = None
        self.events: list[tuple[int, float, float]] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        dt = self.clock() - self._t0
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.events.append((step, dt, self.ewma))
        self.ewma = dt if self.ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self.ewma)
        return slow


class Trainer:
    def __init__(self, cfg: ModelConfig, scfg: step_lib.TrainStepConfig, tcfg: TrainerConfig,
                 data, *, device="cuda", mesh=None, seed: int = 0):
        self.cfg, self.scfg, self.tcfg, self.data, self.mesh = cfg, scfg, tcfg, data, mesh
        self.shardings = self.bshard = None
        if mesh is None:
            self.device = resolve_device(device)
            self.step_fn = step_lib.build_train_step(cfg, scfg, self.device)
        else:
            self.device = resolve_device(mesh.home)
            self.step_fn, _, in_sh, _ = step_lib.build_train_artifacts(
                cfg, mesh, scfg, data.batch_at(0))
            self.shardings, self.bshard = in_sh
        self.state = None
        self.start_step = 0
        self._preempted = False
        self.ckpt = store.AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.monitor = StragglerMonitor(tcfg.straggler_factor, tcfg.ewma_alpha)
        self.metrics_log: list[dict] = []
        self._seed = seed

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """Fresh parameters from ``seed`` in ``cfg.dtype``, zero moments; under
        a mesh all placed by the shardings, with a zero ``err`` where the
        mesh has a "pod" axis and the step compresses across it (else
        None)."""
        params = M.init_params(self.cfg, seed=self._seed, device=self.device,
                               dtype=step_lib.dtype_of(self.cfg.dtype))
        if self.mesh is None:
            self.state = (params, adamw.init(params), None)
        else:
            self.state = step_lib.place_state((params, None, None), self.shardings)

    def maybe_resume(self) -> bool:
        last = store.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        if self.state is None:
            self.init_state()
        self.state, manifest = store.restore(self.tcfg.ckpt_dir, self.state, step=last,
                                             shardings=self.shardings)
        self.start_step = int(manifest["step"])
        return True

    # -- preemption ----------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def request_preempt(self):
        self._preempted = True

    # -- loop ----------------------------------------------------------------
    def run(self) -> dict:
        if self.state is None and not self.maybe_resume():
            self.init_state()
        if self.mesh is not None:
            self.state = step_lib.place_state(self.state, self.shardings)
        t_start = time.monotonic()
        step = self.start_step
        while step < self.tcfg.total_steps and not self._preempted:
            batch = self.data.batch_at(step)
            if self.mesh is not None:
                batch = {k: shd.place(torch.as_tensor(v, device=self.device), self.bshard[k])
                         for k, v in batch.items()}
            self.monitor.start()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            slow = self.monitor.stop(step)
            metrics.update(step=step, straggler=slow)
            self.metrics_log.append(metrics)
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                print(f"step {step:6d} loss={metrics['loss']:.4f} "
                      f"lr={metrics['lr']:.2e} gnorm={metrics['grad_norm']:.3f}", flush=True)
            step += 1
            if self.tcfg.ckpt_every and step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step, self.state, {"wall_s": time.monotonic() - t_start})
        # the final checkpoint (preemption or completion)
        self.ckpt.save(step, self.state, {"final": True})
        self.ckpt.wait()
        return {
            "final_step": step,
            "preempted": self._preempted,
            "straggler_events": list(self.monitor.events),
            "last_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
        }
