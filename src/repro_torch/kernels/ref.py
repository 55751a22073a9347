"""Plain PyTorch versions of the kernels' functions (the ``ref.py``
contract of the reference): the CPU path of every kernel wrapper, and what
the kernels are held against on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import bitpack, huffman
from repro_torch.core.layouts import quant_block_minmax

NEG_INIT = -1e30  # finite "-inf" so flash combines never produce NaN


def dequant_k(codes, k_min, k_step) -> torch.Tensor:
    """codes [..., T, D], k_min/k_step [..., D] (BlockQuant units) -> f32."""
    f32 = torch.float32
    return k_min[..., None, :].to(f32) + codes.to(f32) * k_step[..., None, :].to(f32)


def dequant_v(codes, v_min, v_step) -> torch.Tensor:
    """codes [..., T, D], v_min/v_step [..., T] (TokenQuant units) -> f32."""
    f32 = torch.float32
    return v_min[..., None].to(f32) + codes.to(f32) * v_step[..., None].to(f32)


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
    page_tab=None,          # int32 [B, NB] paged: ring slot -> arena page
    *,
    tile,                   # layouts.FusedTileSpec
    block_size: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of the Fetch kernel: decodes every store tile (the
    materialized dequantized store, deliberately — the kernel never forms
    it), one softmax over the live blocks, then the two-part combine with
    the raw buffer tail.  Returns the normalized output [B, Hq, D] f32.

    With ``page_tab`` the stores are a shared arena ``[1, Hkv, P, ...]``:
    each row's tiles are gathered through its table first, and a block whose
    entry is unassigned (< 0, or past the arena) contributes nothing,
    whatever ``nb_valid`` says."""
    B, Hq, D = q.shape
    page_ok = None
    if page_tab is not None:
        P = k_store.shape[2]
        page_ok = (page_tab >= 0) & (page_tab < P)  # [B, NB]
        idx = torch.clamp(page_tab, 0, P - 1).long()

        def gather(a):
            return a[0][:, idx].movedim(1, 0)  # [B, Hkv, NB, ...]

        k_store, v_store = gather(k_store), gather(v_store)
        if tile.has_scales:
            k_min, k_step = gather(k_min), gather(k_step)
            v_min, v_step = gather(v_min), gather(v_step)
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
    if page_ok is not None:
        ok_b = ok_b & page_ok
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


def huffman_decode_ref(payload, nbits, children, is_symbol, symbols, n_per_stream: int,
                       max_stream_bits: int) -> torch.Tensor:
    """Plain branchless-walk decode: payload int32 [..., W], nbits [..., S]
    -> uint8 [..., S, n_per_stream] (leading dims: one per block)."""
    return huffman.decode_block_torch(payload, nbits, children, is_symbol, symbols,
                                      n_per_stream, max_stream_bits)


def huffman_attn_scores_ref(payload, nbits, children, is_symbol, symbols, k_min, k_step, q,
                            max_stream_bits: int) -> torch.Tensor:
    """Plain Huffman decode + dequant + K.q, one stream a cached token (a
    [head_dim] K row): payload [..., W], nbits [..., S], k_min / k_step
    [..., D], q [D] -> scores [..., S] (leading dims: one per block)."""
    D = q.shape[-1]
    codes = huffman_decode_ref(payload, nbits, children, is_symbol, symbols, D,
                               max_stream_bits).to(torch.float32)
    kd = k_min.to(torch.float32)[..., None, :] + codes * k_step.to(torch.float32)[..., None, :]
    return kd @ q.to(torch.float32)
