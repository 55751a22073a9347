"""Error-feedback int8 gradient compression (the port of
``repro.optim.grad_compress``).

Gradients quantize to int8 with a per-tensor scale, and the quantization
residual is kept and added back the next step (error feedback), so the
compression does not bias training.  It wraps the cross-pod all-reduce
of a mesh with a ``"pod"`` axis (``train.step.build_train_artifacts``): the
reference compresses the gradient after the in-pod reduction, when every
pod holds the same value, and so does the port, once.  The reference's
parameter tree stacks its layers (``[L, ...]`` a leaf) and quantizes each
stacked leaf with one scale; the port's tree holds a dict a layer, so
``tree_compress_decompress`` takes one scale over the layers' leaves of
the same name.  A sharded leaf (``distributed.sharding.Sharded``) takes
its scale from all its pieces, so each element's code is the unsharded
one.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.distributed.sharding import Sharded, like, zeros


def quantize_int8(x: torch.Tensor, amax=None):
    """Per-tensor symmetric int8 quantization (``amax``: the tensor's largest
    magnitude, when it is known).  Returns (q int8, scale f32)."""
    xf = x.to(torch.float32)
    if amax is None:
        amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """One error-feedback round: quantize ``g + err``; return the dequantized
    tensor (what the collective would carry) and the new residual."""
    return _round([g], [err])[0]


def _pieces(x) -> list[torch.Tensor]:
    return x.blocks if isinstance(x, Sharded) else [x]


def _round(gs, errs) -> list[tuple]:
    """One error-feedback round over leaves that share one scale: the
    largest magnitude of ``g + err`` over all of them (and all their
    pieces, on the first one's device)."""
    targets = [[gb.to(torch.float32) + eb for gb, eb in zip(_pieces(g), _pieces(e))]
               for g, e in zip(gs, errs)]
    flat = [t for ts in targets for t in ts]
    if len(flat) == 1:
        amax = flat[0].abs().max()
    else:
        home = flat[0].device
        amax = torch.stack([t.abs().max().to(home) for t in flat]).max()
    out = []
    for g, e, ts in zip(gs, errs, targets):
        deq, res = [], []
        for t in ts:
            q, scale = quantize_int8(t, amax.to(t.device))
            d = dequantize_int8(q, scale)
            deq.append(d.to(g.dtype))
            res.append(t - d)
        out.append((like(g, deq), like(e, res)) if isinstance(g, Sharded)
                   else (deq[0], res[0]))
    return out


def init_error_state(params):
    def one(x):
        if isinstance(x, Sharded):  # sharded like the parameters
            return zeros(x.sharding, x.shape, torch.float32)
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    return tree.map_(one, params)


def _stack_groups(tree_) -> list[list[int]]:
    """Leaf indices grouped by path without layer indices: the leaves the
    reference holds as one stacked ``[L, ...]`` tensor, which it quantizes
    with one scale."""
    groups: dict = {}
    for i, (path, _) in enumerate(tree.leaves_with_paths(tree_)):
        groups.setdefault(tuple(k for k in path if not isinstance(k, int)), []).append(i)
    return list(groups.values())


def tree_compress_decompress(grads, err_state):
    """``compress_decompress`` over a tree, one scale for each stacked
    group of leaves (``_stack_groups``), as the reference's per-tensor scale
    of its stacked tree."""
    gl, el = tree.leaves(grads), tree.leaves(err_state)
    outs = [None] * len(gl)
    for idx in _stack_groups(grads):
        for i, o in zip(idx, _round([gl[i] for i in idx], [el[i] for i in idx])):
            outs[i] = o
    return (tree.unflatten(grads, [o[0] for o in outs]),
            tree.unflatten(grads, [o[1] for o in outs]))


def payload_bytes(params) -> int:
    """Bytes a compressed gradient all-reduce would move (int8 + a scale
    for each stacked group)."""
    return (sum(x.numel() for x in tree.leaves(params))
            + 4 * len(_stack_groups(params)))
