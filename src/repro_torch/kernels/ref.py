"""Plain PyTorch versions of the kernels' functions (the ``ref.py``
contract of the reference): the CPU path of every kernel wrapper, and what
the kernels are held against on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import bitpack
from repro_torch.core.layouts import quant_block_minmax

NEG_INIT = -1e30  # finite "-inf" so flash combines never produce NaN


def _rows(x, B: int) -> torch.Tensor:
    """Per-row int vector [B] (a scalar broadcasts)."""
    x = torch.as_tensor(x, dtype=torch.int32)
    return x.reshape(-1).expand(B) if x.numel() == 1 else x


def fused_cache_attention_ref(
    q: torch.Tensor,        # [B, Hq, D]
    k_store, k_min, k_step,  # [B, Hkv, NB, *tile.k_tile], units [B, Hkv, NB, D]
    v_store, v_min, v_step,  # [B, Hkv, NB, *tile.v_tile], units [B, Hkv, NB, T]
    k_buf, v_buf,           # [B, Hkv, T, D]
    nb_valid, buf_len,      # int [B] per-row valid blocks / buffer lengths
    *,
    tile,                   # layouts.FusedTileSpec
    block_size: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of the Fetch kernel: decodes every store tile (the
    materialized dequantized store, deliberately — the kernel never forms
    it), one softmax over the live blocks, then the two-part combine with
    the raw buffer tail.  Returns the normalized output [B, Hq, D] f32."""
    B, Hq, D = q.shape
    Hkv, NB = k_store.shape[1], k_store.shape[2]
    G, T = Hq // Hkv, block_size
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    nbv = _rows(nb_valid, B).to(q.device)
    kd = tile.decode_k(k_store, k_min, k_step)  # [B, Hkv, NB, T, D] f32
    vd = tile.decode_v(v_store, v_min, v_step)
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bhntd->bhgnt", qg, kd) * scale
    ok_b = torch.arange(NB, device=q.device)[None, :] < nbv[:, None]  # [B, NB]
    ok = ok_b[:, None, None, :, None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INIT))
    s2 = s.reshape(B, Hkv, G, NB * T)
    m = torch.clamp(s2.amax(-1), min=NEG_INIT)
    p = torch.exp(s2 - m[..., None]) * ok[..., 0].repeat_interleave(T, -1)
    l = p.sum(-1)
    acc = torch.einsum("bhgnt,bhntd->bhgd", p.reshape(B, Hkv, G, NB, T), vd)
    return combine_with_buffer_ref(
        acc.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq),
        q, k_buf, v_buf, buf_len, scale=scale)


def combine_with_buffer_ref(acc, m, l, q, k_buf, v_buf, buf_len,
                            scale: float | None = None) -> torch.Tensor:
    """Two-part softmax combine: store partials (acc, m, l) + raw tail buffer."""
    B, Hq, D = q.shape
    Hkv, T = k_buf.shape[1], k_buf.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bl = _rows(buf_len, B).to(q.device)
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k_buf.to(torch.float32)) * scale
    ok = (torch.arange(T, device=q.device)[None, :] < bl[:, None])[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG_INIT))
    mb = torch.clamp(s.amax(-1), min=NEG_INIT)
    pb = torch.exp(s - mb[..., None]) * ok
    lb = pb.sum(-1)
    accb = torch.einsum("bhgt,bhtd->bhgd", pb, v_buf.to(torch.float32))
    mb, lb, accb = mb.reshape(B, Hq), lb.reshape(B, Hq), accb.reshape(B, Hq, D)
    M = torch.maximum(m, mb)
    a1 = torch.exp(m - M)
    a2 = torch.exp(mb - M)
    denom = l * a1 + lb * a2
    return (acc * a1[..., None] + accb * a2[..., None]) / torch.clamp(denom, min=1e-30)[..., None]


def quant_pack_ref(x: torch.Tensor, rel_scale: float, bits: int, token_wise: bool,
                   kivi: bool = False):
    """Plain Store stage: quantize + no-straddle pack of blocks [..., T, D].

    token_wise=False -> K BlockQuant (units: block x channel); True -> V
    TokenQuant (units: token).  ``kivi`` takes the fixed-bit step
    (max-min)/(2^b-1), the reference's ``kivi_step`` layouts.
    Returns (words int32 [..., W], mn f32 [..., U], step f32 [..., U]).
    """
    *lead, T, D = x.shape
    axes = (-1,) if token_wise else (-2,)
    codes, mn, step = quant_block_minmax(x.to(torch.float32), rel_scale, bits, axes, kivi)
    words = bitpack.pack_nostraddle(codes.reshape(*lead, T * D), bits)
    return words, mn, step
