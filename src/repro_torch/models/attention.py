"""Attention over the compressed KV cache: GQA projections, the block-chunked
prefill step and the one-token decode step (the port of
``repro.models.attention``, serving path).  Layout-agnostic: the cache's
``CacheSpec`` names the layout, and ``cache.attend`` dispatches to the
Fetch kernel or the blockwise scan."""

from __future__ import annotations

import torch

from repro_torch.core import cache as kvcache
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_attention(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    params = {
        "wq": layers.dense_init(gen, (d, H, Dh), **kw),
        "wk": layers.dense_init(gen, (d, Hkv, Dh), **kw),
        "wv": layers.dense_init(gen, (d, Hkv, Dh), **kw),
        "wo": layers.dense_init(gen, (H, Dh, d), scale=(H * Dh) ** -0.5, **kw),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((Dh,), **kw)
        params["k_norm"] = torch.ones((Dh,), **kw)
    return params


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, H, Dh] -> [B, S, H, Dh]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def qkv_project(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """x: [B, S, d] -> q [B,S,H,Dh], k/v [B,S,Hkv,Dh] (RoPE'd, qk-normed)."""
    q, k, v = (_proj(x, params[n]) for n in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(params, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out [B, S, H, Dh] @ wo [H, Dh, d] -> [B, S, d]."""
    wo = params["wo"]
    return attn_out.reshape(*attn_out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def attn_block_chunk(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                     cache: kvcache.LayerKVCache):
    """Block-chunked prefill step: ``C <= block_size`` prompt tokens starting
    at a block boundary.  x: [B, C, d]; positions: int [B, C] absolute.

    Decode-exact boundary semantics, as in the reference: a full chunk
    splits — the first ``T-1`` tokens attend old-store + raw-causal, the
    chunk flushes, and the boundary token attends the post-flush cache
    through ``kvcache.attend`` (so through the Fetch kernel), exactly as
    decode would have."""
    h = layers.rms_norm(x, params["ln_attn"], cfg.norm_eps)
    q, k, v = qkv_project(params["attn"], cfg, h, positions)
    kT = k.transpose(1, 2)  # [B, Hkv, C, Dh]
    vT = v.transpose(1, 2)
    C = q.shape[1]
    if C == cache.spec.block_size:
        o_head = (kvcache.attend_chunk(cache, q[:, :-1], kT[:, :, :-1], vT[:, :, :-1])
                  if C > 1 else None)
        kvcache.append_chunk(cache, kT, vT)
        o_last = kvcache.attend(cache, q[:, -1])[:, None]  # [B, 1, Hq, Dh]
        o = torch.cat([o_head, o_last], dim=1) if o_head is not None else o_last
    else:
        o = kvcache.attend_chunk(cache, q, kT, vT)
        kvcache.append_chunk(cache, kT, vT)
    return x + out_project(params["attn"], o), cache


def attn_block_decode(params, cfg: ModelConfig, x: torch.Tensor, position: torch.Tensor,
                      cache: kvcache.LayerKVCache):
    """One-token decode: append this token's KV (Store on a full buffer) and
    attend over the compressed cache (Fetch).  x: [B, 1, d]; position: int
    [B], every row at its own sequence position."""
    h = layers.rms_norm(x, params["ln_attn"], cfg.norm_eps)
    q, k, v = qkv_project(params["attn"], cfg, h, position.reshape(-1, 1))
    kvcache.append(cache, k[:, 0], v[:, 0])
    # Attending after the append sees the current token too.
    o = kvcache.attend(cache, q[:, 0])  # [B, H, Dh]
    return x + out_project(params["attn"], o[:, None]), cache
