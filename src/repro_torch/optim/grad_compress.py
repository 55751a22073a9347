"""Error-feedback int8 gradient compression (the port of
``repro.optim.grad_compress``).

Gradients quantize to int8 with a per-tensor scale, and the quantization
residual is kept and added back the next step (error feedback), so the
compression does not bias training.  In the reference this wraps the
cross-pod all-reduce of a multi-pod mesh; that all-reduce waits for the
port's sharding slice.  On one device the reference's step leaves
``cross_pod_grad_compress`` unused (its mesh has no ``"pod"`` axis), and
so does the port's ``train.step``: these functions are the numerics alone.
"""

from __future__ import annotations

import torch

from repro_torch import tree


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization.  Returns (q int8, scale f32)."""
    xf = x.to(torch.float32)
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """One error-feedback round: quantize ``g + err``; return the dequantized
    tensor (what the collective would carry) and the new residual."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), target - deq


def init_error_state(params):
    return tree.map_(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                     params)


def tree_compress_decompress(grads, err_state):
    outs = [compress_decompress(g, e)
            for g, e in zip(tree.leaves(grads), tree.leaves(err_state))]
    return (tree.unflatten(grads, [o[0] for o in outs]),
            tree.unflatten(grads, [o[1] for o in outs]))


def payload_bytes(params) -> int:
    """Bytes a compressed gradient all-reduce would move (int8 + a scale)."""
    return sum(x.numel() + 4 for x in tree.leaves(params))
