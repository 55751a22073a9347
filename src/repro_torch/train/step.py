"""The step builders (the port of ``repro.train.step``).

``build_train_step`` returns the one-device ``step(state, batch) ->
(state, metrics)`` with ``state = (params, opt_state, err)``:

* value and gradients of ``model.lm_loss`` through ``torch.autograd``;
* optional gradient accumulation over ``microbatches`` (the batch split on
  its leading axis, gradients summed in float32 and averaged);
* optional remat: each block (each period, for the hybrid) recomputed in
  the backward pass (``torch.utils.checkpoint``);
* the AdamW update, in place.

``build_train_artifacts`` returns the same step over a ``launch.mesh.Mesh``
with the reference's sharding trees: parameters, AdamW moments and the
error-feedback state ``err`` held as ``distributed.sharding.Sharded``
pieces by ``train_rules`` (FSDP on "data" x TP on "model"), the batch by
``batch_sharding``.  Where the reference hands the step to GSPMD, the port
computes it explicitly:

* dense, ssm, hybrid and the encoder: each batch shard (over "pod" and
  "data") gathers the parameters onto its device and runs ``lm_loss`` and
  autograd on its rows, its loss term being its masked sum over the GLOBAL
  mask count; its gradients are added into the gradient's pieces, shard
  after shard in a fixed order (the reduce-scatter), and the gathered copy
  and the full gradients are freed before the next shard.  Microbatches
  split the global batch first, as the reference does, and each part over
  the shards;
* MoE: the whole batch on the mesh's first device, since ``moe_apply``
  sizes its capacity from the whole batch and ranks pairs in row order;
* the "model" axis shards storage (parameters, gradients, moments,
  ``err``); the matmuls are not split by heads;
* with ``cross_pod_grad_compress`` on a mesh with a "pod" axis, the reduced
  gradient goes once through ``grad_compress.tree_compress_decompress``
  with the sharded ``err``, as the reference compresses after the in-pod
  reduction;
* AdamW shard-local, the gradient norm counting each element once.

A mesh of one position runs ``build_train_step``'s computation on its
pieces, launch for launch.  ``build_serve_artifacts`` gives the prefill and
decode closures with ``serve_rules`` / ``cache_shardings`` trees.
``kv_chunk`` is passed on and read by nothing (``model.forward``); the
reference's ``unroll`` (a scan knob) has no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import Sharded
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw, grad_compress


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


def value_and_grad(cfg: ModelConfig, scfg: TrainStepConfig, params, batch, count=None):
    """(loss, {"ce", "aux_loss"}, gradients in ``tree.leaves(params)``
    order) of one batch; the parameters are left without ``requires_grad``.
    ``count``: the mean's denominator (``model.lm_loss``)."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, parts = M.lm_loss(params, cfg, batch, remat=scfg.remat, q_chunk=scfg.q_chunk,
                                kv_chunk=scfg.kv_chunk, count=count)
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


# ---------------------------------------------------------------------------
# sharded training
# ---------------------------------------------------------------------------


def shapes_and_axes(cfg: ModelConfig):
    """(the parameters on the meta device: shapes and dtypes without
    storage, the logical-axes tree)."""
    return (M.init_params(cfg, device="meta", dtype=dtype_of(cfg.dtype)), M.param_axes(cfg))


def _meta_f32(shapes):
    return tree.map_(lambda x: torch.empty(x.shape, dtype=torch.float32, device="meta"),
                     shapes)


def build_train_artifacts(cfg: ModelConfig, mesh: Mesh, scfg: TrainStepConfig, batch_shape):
    """Returns (step, state_shapes, in_shardings, out_shardings), the
    reference's four: ``state = (params, opt_state, err)`` as sharded trees
    (``err`` None unless ``cross_pod_grad_compress`` on a mesh with a "pod"
    axis); ``step(state, batch) -> (state, metrics)`` updates the pieces in
    place; ``batch_shape`` maps each batch field to anything with
    ``.shape``.  ``state_shapes`` are meta tensors; ``in_shardings`` is
    ``((params, opt_state, err) shardings, batch shardings)``."""
    rules = shd.train_rules(cfg, mesh)
    pshapes, axes = shapes_and_axes(cfg)
    pshard = shd.make_param_shardings(axes, pshapes, rules, mesh)
    ostate_shapes = adamw.AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                                     mu=_meta_f32(pshapes), nu=_meta_f32(pshapes))
    oshard = adamw.AdamWState(step=shd.replicated(mesh), mu=pshard, nu=pshard)
    bshard = {k: shd.batch_sharding(mesh, v) for k, v in batch_shape.items()}
    err_shapes = eshard = None
    if scfg.cross_pod_grad_compress and "pod" in mesh.axis_names:
        err_shapes, eshard = _meta_f32(pshapes), pshard  # the error buffer mirrors the params
    shards = shd.data_shards(mesh)

    def step(state, batch):
        params, opt_state, err = state
        if mesh.size == 1:  # the one-device step on the pieces, which are the tensors
            p = _unwrap(params)
            loss, parts, grads = loss_and_grads(cfg, scfg, p, to_device(_unwrap(batch),
                                                                      mesh.home))
            grads = tree.unflatten(p, grads)
            if err is not None:
                grads, e = _cross_pod_compressed_allreduce(grads, _unwrap(err))
                for x, new in zip(tree.leaves(err), tree.leaves(e)):
                    x.blocks[0] = new
            _, _, metrics = adamw.update(scfg.opt, grads, _unwrap(opt_state), p)
            return (params, opt_state, err), {"loss": loss, **parts, **metrics}
        loss, parts, grads = _sharded_loss_and_grads(cfg, scfg, mesh, shards, params, batch,
                                                     pshard)
        grads = tree.unflatten(params, grads)
        if err is not None:
            grads, err = _cross_pod_compressed_allreduce(grads, err)
        params, opt_state, metrics = adamw.update(scfg.opt, grads, opt_state, params)
        return (params, opt_state, err), {"loss": loss, **parts, **metrics}

    state_shapes = (pshapes, ostate_shapes, err_shapes)
    in_shardings = ((pshard, oshard, eshard), bshard)
    out_shardings = ((pshard, oshard, eshard), None)
    return step, state_shapes, in_shardings, out_shardings


def _unwrap(tree_):
    """A one-position mesh's pieces: the tensors themselves."""
    return tree.map_(lambda x: x.blocks[0] if isinstance(x, Sharded) else x, tree_)


def _rows(x, start: int, stop: int, device) -> torch.Tensor:
    """Rows [start, stop) of a batch field (sharded or not) on ``device``."""
    if isinstance(x, Sharded):
        return shd.gather(x, device)[start:stop]
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=device)[start:stop]


def _count(part: dict) -> torch.Tensor:
    """A batch part's masked-mean denominator, as ``lm_loss`` computes it."""
    mask = part.get("mask")
    if mask is None:
        return torch.tensor(float(part["labels"].numel()), dtype=torch.float32,
                            device=part["labels"].device)
    return torch.clamp(mask.to(torch.float32).sum(), min=1.0)


def n_batch_shards(cfg: ModelConfig, scfg: TrainStepConfig, mesh: Mesh, batch: int) -> int:
    """How many batch shards the sharded step splits a microbatch over: one
    a (pod, data) index, or 1 (the whole batch on the first device) for MoE
    and for a microbatch the shards do not divide."""
    n = len(shd.data_shards(mesh))
    bp = batch // max(scfg.microbatches, 1)
    return n if cfg.family != "moe" and bp % n == 0 else 1


def _sharded_loss_and_grads(cfg, scfg, mesh, shards, params, batch, pshard):
    """(loss, parts, the gradient as pieces by ``pshard`` in leaf order)."""
    home = mesh.home
    pleaves, sleaves = tree.leaves(params), tree.leaves(pshard)
    mb = max(scfg.microbatches, 1)
    B = next(iter(batch.values())).shape[0]
    bp = B // mb
    n = n_batch_shards(cfg, scfg, mesh, B)
    if n == 1:  # the whole batch on the first device (MoE, or a batch the shards do not divide)
        full = tree.unflatten(params, [shd.gather(x, home) for x in pleaves])
        loss, parts, g = loss_and_grads(cfg, scfg, full,
                                        {k: _rows(v, 0, B, home) for k, v in batch.items()})
        del full
        return loss, parts, [shd.accumulate(None, x, s) for x, s in zip(g, sleaves)]
    b = bp // n
    acc = [None] * len(pleaves)
    l_sum = ce_sum = aux_sum = None
    for i in range(mb):  # each part of the global batch, then each shard of the part
        part = {k: _rows(v, i * bp, (i + 1) * bp, home) for k, v in batch.items()}
        count = _count(part)
        for k in range(n):
            dev = mesh.devices[shards[k]]
            full = tree.unflatten(params, [shd.gather(x, dev) for x in pleaves])
            rows = {key: v[k * b:(k + 1) * b].to(dev) for key, v in part.items()}
            loss, parts, g = value_and_grad(cfg, scfg, full, rows, count=count.to(dev))
            del full
            for j, (x, s) in enumerate(zip(g, sleaves)):
                acc[j] = shd.accumulate(acc[j], x, s, torch.float32 if mb > 1 else None)
            del g
            loss, ce, aux = (x.to(home) for x in (loss, parts["ce"], parts["aux_loss"]))
            l_sum = loss if l_sum is None else l_sum + loss
            ce_sum = ce if ce_sum is None else ce_sum + ce
            aux_sum = aux if aux_sum is None else aux_sum + aux
    if mb == 1:
        return l_sum, {"ce": ce_sum, "aux_loss": aux_sum}, acc
    for s in acc:
        for blk in s.blocks:
            blk.div_(mb)
    zero = torch.zeros((), dtype=torch.float32, device=home)
    return l_sum / mb, {"aux_loss": zero, "ce": l_sum / mb}, acc


def _cross_pod_compressed_allreduce(grads, err):
    """Error-feedback int8 compression of the cross-pod all-reduce: the
    gradient arrives reduced over every batch shard, so every pod holds the
    same value, and the compression runs once on it with the sharded
    ``err``; the mean over pods of equal values is that value."""
    return grad_compress.tree_compress_decompress(grads, err)


def place_state(state, shardings):
    """``(params, opt_state, err)`` placed by ``shardings`` (the first of
    ``build_train_artifacts``'s ``in_shardings``): plain tensors become
    pieces, a missing ``opt_state`` or ``err`` starts at zero, an ``err``
    the shardings do not ask for is dropped."""
    params, opt_state, err = state
    pshard, oshard, eshard = shardings
    params = shd.place_tree(params, pshard)
    opt_state = adamw.init(params) if opt_state is None else shd.place_tree(opt_state, oshard)
    if eshard is None:
        err = None
    else:
        err = (grad_compress.init_error_state(params) if err is None
               else shd.place_tree(err, eshard))
    return params, opt_state, err


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def build_serve_artifacts(cfg: ModelConfig, mesh: Mesh, *, batch: int, prompt_len: int,
                          max_seq: int, q_chunk: int = 2048, kv_chunk: int = 2048):
    """The prefill and decode closures over ``model.prefill`` /
    ``decode_step`` with the parameter shardings of ``serve_rules`` and the
    decode state's of ``cache_shardings``, and the shapes they apply to
    (meta tensors).  The closures take the parameters and state as one
    device holds them; ``serve.scheduler.Server(mesh=)`` is the sharded
    serving path.  ``prompt_len`` and ``kv_chunk`` are the reference's
    signature; nothing reads them."""
    rules = shd.serve_rules(cfg, mesh)
    pshapes, axes = shapes_and_axes(cfg)
    pshard = shd.make_param_shardings(axes, pshapes, rules, mesh)
    state_shapes = M.init_decode_state(cfg, batch, max_seq, device="meta")
    sshard = shd.cache_shardings(state_shapes, mesh)

    def prefill_step(params, batch_in):
        logits, state = M.prefill(params, cfg, batch_in, max_seq, q_chunk=q_chunk)
        return logits[:, -1], state

    def decode_step(params, tokens, position, state):
        return M.decode_step(params, cfg, tokens, position, state)

    return dict(prefill=prefill_step, decode=decode_step, pshapes=pshapes, pshard=pshard,
                state_shapes=state_shapes, sshard=sshard, rules=rules)
