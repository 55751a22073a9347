"""Attention over the compressed KV cache: GQA projections, the
full-length attention of training and the prefill, the block-chunked
prefill step and the one-token decode step (the port of
``repro.models.attention``).  Layout-agnostic: the cache's ``CacheSpec`` names the layout, and
``cache.attend`` dispatches to the Fetch kernel or the blockwise scan."""

from __future__ import annotations

import math

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


def attention_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_attention``'s leaves."""
    axes = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}
    if cfg.qk_norm:
        axes["q_norm"] = axes["k_norm"] = ("head_dim",)
    return axes


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


NEG = -1e9


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    window: int | None = None, q_chunk: int = 512,
                    scale: float | None = None) -> torch.Tensor:
    """Full-sequence attention.  q: [B, S, H, Dh]; k, v: [B, S, Hkv, Dh]
    (GQA broadcast inside); causal and sliding-window masks as the
    reference applies them (key p is visible to query s when p <= s if
    causal, and p > s - window under a window).

    The reference runs a two-level online-softmax loop over query and key
    chunks snapped to divisors of S (a prime S gives chunks of one token).
    Here the queries go in blocks of ``q_chunk`` whatever S is, each block
    against its whole visible key range in one masked product and one
    softmax, which bounds the scores at O(q_chunk·S) a head: a few large
    plain products.  Float32 throughout; equal to the reference within
    float32 rounding (tests/test_torch_ssm.py)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    f32 = torch.float32
    qf = q.to(f32).reshape(B, S, Hkv, G, Dh)
    kf, vf = k.to(f32), v.to(f32)
    out = torch.empty((B, S, Hkv, G, Dh), dtype=f32, device=q.device)
    pos = torch.arange(S, device=q.device)
    step = max(1, min(q_chunk, S))
    for lo in range(0, S, step):
        hi = min(S, lo + step)
        k_hi = hi if causal else S
        k_lo = max(0, lo - window + 1) if window is not None else 0
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, lo:hi], kf[:, k_lo:k_hi]) * scale
        qp, kp = pos[lo:hi, None], pos[None, k_lo:k_hi]
        mask = torch.ones((hi - lo, k_hi - k_lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qp >= kp
        if window is not None:
            mask &= kp > qp - window
        p = torch.softmax(s.masked_fill(~mask, NEG), dim=-1)
        out[:, lo:hi] = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, k_lo:k_hi])
    return out.reshape(B, S, H, Dh).to(q.dtype)


def attn_block_train(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                     q_chunk: int = 512) -> torch.Tensor:
    """Pre-norm attention with its residual over a whole sequence (training
    and evaluation): causal unless the model is encoder-only.  The
    reference's ``kv_chunk`` has no counterpart: ``flash_attention`` takes
    each query block against its whole visible key range."""
    h = layers.rms_norm(x, params["ln_attn"], cfg.norm_eps)
    q, k, v = qkv_project(params["attn"], cfg, h, positions)
    o = flash_attention(q, k, v, causal=cfg.causal and not cfg.encoder_only,
                        window=cfg.sliding_window, q_chunk=q_chunk)
    return x + out_project(params["attn"], o)


def attn_block_prefill(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                       spec: kvcache.CacheSpec, q_chunk: int = 512):
    """Full-length prefill of one attention block: attend the prompt in
    full, and build this layer's compressed cache from its K/V in one
    Store call (``cache.prefill``: every whole block of the prompt, the
    remainder in the raw buffer).  ``spec`` is this layer's dense spec."""
    h = layers.rms_norm(x, params["ln_attn"], cfg.norm_eps)
    q, k, v = qkv_project(params["attn"], cfg, h, positions)
    o = flash_attention(q, k, v, causal=cfg.causal and not cfg.encoder_only,
                        window=cfg.sliding_window, q_chunk=q_chunk)
    cache = kvcache.prefill(spec, k.transpose(1, 2), v.transpose(1, 2))
    return x + out_project(params["attn"], o), cache


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
