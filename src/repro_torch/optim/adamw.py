"""AdamW with a warmup + cosine schedule and global-norm clipping (the port
of ``repro.optim.adamw``).

All moments and the update arithmetic are float32, whatever the parameters'
dtype, and weight decay applies to every leaf, as in the reference.  Where
the reference returns new trees (its jitted step donates the old ones), the
port updates the parameters and moments in place and returns the same
objects: a copy of a model's parameters and moments would double the
optimizer's memory.  Nothing here reads a device value on the host.

Sharded trees (``distributed.sharding.Sharded`` leaves, the parameters,
gradients and moments on one sharding a leaf) update shard-local: each
distinct piece on its own device, with the scalars (the step, the learning
rate, the clip scale) moved to it.  The global norm counts each element of
the gradient once, not once a replica.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import tree
from repro_torch.distributed.sharding import Sharded, place, replicated, zeros


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then a cosine to
    ``min_lr_ratio`` of the peak."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads) -> torch.Tensor:
    leaves = tree.leaves(grads)
    if leaves and isinstance(leaves[0], Sharded):
        # each distinct piece's sum of squares on the first device, in order
        home = leaves[0].mesh.home
        return torch.sqrt(sum(torch.sum(torch.square(b.to(torch.float32))).to(home)
                              for x in leaves for b, _ in x.distinct()))
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree.map_(lambda x: x * scale.to(x.dtype), grads), norm


def init(params) -> AdamWState:
    first = tree.leaves(params)[0]
    if isinstance(first, Sharded):  # moments sharded like the parameters, the step replicated
        moments = lambda t: tree.map_(  # noqa: E731
            lambda x: zeros(x.sharding, x.shape, torch.float32), t)
        home = first.mesh.home
        return AdamWState(step=place(torch.zeros((), dtype=torch.int32, device=home),
                                     replicated(first.mesh)),
                          mu=moments(params), nu=moments(params))
    dev = first.device
    moments = lambda t: tree.map_(lambda x: torch.zeros_like(x, dtype=torch.float32), t)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=moments(params), nu=moments(params))


def _leaf_update(cfg: AdamWConfig, g, m, v, p, lr, b1c, b2c) -> None:
    gf = g.to(torch.float32)
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * gf * gf)
    pf = p.to(torch.float32)
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * pf
    p.copy_((pf - lr * delta).to(p.dtype))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step on ``params`` (clipped ``grads``), in place.  Returns
    (params, state, metrics {"grad_norm", "lr"}), the same objects."""
    if isinstance(state.step, Sharded):
        return _update_sharded(cfg, grads, state, params)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    state.step.add_(1)
    step = state.step.to(torch.float32)
    lr = schedule(cfg, state.step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state.mu), tree.leaves(state.nu),
                          tree.leaves(params)):
        _leaf_update(cfg, g, m, v, p, lr, b1c, b2c)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update_sharded(cfg: AdamWConfig, grads, state: AdamWState, params):
    """``update`` on sharded trees: the clip scale from the global norm,
    then each distinct piece updated on its own device."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for b in state.step.blocks:
        b.add_(1)
    home = state.step.blocks[0]
    step = home.to(torch.float32)
    lr = schedule(cfg, home)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state.mu), tree.leaves(state.nu),
                          tree.leaves(params)):
        for gb, mb, vb, pb in zip(g.blocks, m.blocks, v.blocks, p.blocks):
            dev = pb.device
            _leaf_update(cfg, gb * scale.to(dev, gb.dtype), mb, vb, pb, lr.to(dev),
                         b1c.to(dev), b2c.to(dev))
    return params, state, {"grad_norm": gnorm, "lr": lr}
