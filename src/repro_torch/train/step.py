"""The training step builder (the port of ``repro.train.step``'s train
half).

``build_train_step`` returns ``step(state, batch) -> (state, metrics)``
with ``state = (params, opt_state, err)``:

* value and gradients of ``model.lm_loss`` through ``torch.autograd``;
* optional gradient accumulation over ``microbatches`` (the batch split on
  its leading axis, gradients summed in float32 and averaged);
* optional remat: each block (each period, for the hybrid) recomputed in
  the backward pass (``torch.utils.checkpoint``);
* the AdamW update, in place.

The reference's mesh and parameter shardings become one explicit device.
``cross_pod_grad_compress`` is kept and read by nothing: on one device the
reference's step leaves it unused too (its mesh has no ``"pod"`` axis), so
``err`` stays ``None``; the cross-pod all-reduce waits for the sharding
slice.  ``kv_chunk`` is passed on and read by nothing (``model.forward``);
the reference's ``unroll`` (a scan knob) has no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: bool = True
    microbatches: int = 1
    q_chunk: int = 2048
    kv_chunk: int = 2048
    cross_pod_grad_compress: bool = False
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)


def to_device(batch: dict, device) -> dict:
    """A data batch (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
            for k, v in batch.items()}


def value_and_grad(cfg: ModelConfig, scfg: TrainStepConfig, params, batch):
    """(loss, {"ce", "aux_loss"}, gradients in ``tree.leaves(params)``
    order) of one batch; the parameters are left without ``requires_grad``."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, parts = M.lm_loss(params, cfg, batch, remat=scfg.remat, q_chunk=scfg.q_chunk,
                                kv_chunk=scfg.kv_chunk)
        # A leaf the loss does not read (an encoder's token table) gets
        # zeros, as jax.grad gives it.
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, list(grads)


def loss_and_grads(cfg: ModelConfig, scfg: TrainStepConfig, params, batch):
    """(loss, parts, gradients in ``tree.leaves(params)`` order) of a batch of
    tensors, accumulated over ``scfg.microbatches`` as the reference does:
    the batch split on its leading axis, gradients summed in float32 and
    averaged, ``ce`` the mean loss and ``aux_loss`` 0."""
    mb = scfg.microbatches
    if mb <= 1:
        return value_and_grad(cfg, scfg, params, batch)
    parts = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:]) for k, v in batch.items()}
    g_sum, l_sum = None, None
    for i in range(mb):
        loss, _, g = value_and_grad(cfg, scfg, params, {k: v[i] for k, v in parts.items()})
        g = [x.to(torch.float32) for x in g]
        g_sum = g if g_sum is None else [a + b for a, b in zip(g_sum, g)]
        l_sum = loss if l_sum is None else l_sum + loss
    zero = torch.zeros((), dtype=torch.float32, device=l_sum.device)
    return l_sum / mb, {"aux_loss": zero, "ce": l_sum / mb}, [g / mb for g in g_sum]


def build_train_step(cfg: ModelConfig, scfg: TrainStepConfig, device="cuda"):
    """``step(state, batch) -> (state, metrics)``; metrics are device
    scalars: ``loss``, ``ce``, ``aux_loss``, ``grad_norm``, ``lr``."""
    dev = resolve_device(device)

    def step(state, batch):
        params, opt_state, err = state
        loss, parts, grads = loss_and_grads(cfg, scfg, params, to_device(batch, dev))
        params, opt_state, metrics = adamw.update(scfg.opt, tree.unflatten(params, grads),
                                                  opt_state, params)
        return (params, opt_state, err), {"loss": loss, **parts, **metrics}

    return step
