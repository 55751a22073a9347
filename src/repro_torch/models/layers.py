"""Shared neural building blocks (plain functions on tensors; parameters in
nested dicts), the port of ``repro.models.layers``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape, scale=None, *, device, dtype=torch.float32):
    """normal * fan_in**-0.5 (fan_in = shape[0]), the reference's init scale."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = fan_in**-0.5
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)


def embed_init(gen: torch.Generator, shape, *, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(0.02)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions broadcast against the S axis.  Rotation
    pairs are (x[..., :half], x[..., half:]) — the Llama convention."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, *, device, dtype=torch.float32):
    return {"w_gate": dense_init(gen, (d_model, d_ff), device=device, dtype=dtype),
            "w_up": dense_init(gen, (d_model, d_ff), device=device, dtype=dtype),
            "w_down": dense_init(gen, (d_ff, d_model), device=device, dtype=dtype)}


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


def init_embedding(gen, vocab: int, d_model: int, tie: bool, *, device,
                   dtype=torch.float32):
    params = {"embed": embed_init(gen, (vocab, d_model), device=device, dtype=dtype)}
    if not tie:
        params["unembed"] = dense_init(gen, (d_model, vocab), device=device, dtype=dtype)
    return params


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["embed"].T
