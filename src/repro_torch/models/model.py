"""Model assembly for the dense family (the port of ``repro.models.model``,
serving entry points).

Parameters are nested dicts of tensors: ``emb`` (``embed``, ``unembed``),
``ln_f``, and ``blocks`` — one dict per layer (``ln_attn``, ``attn``
{wq, wk, wv, wo}, ``ln_mlp``, ``mlp`` {w_gate, w_up, w_down}) with the
reference's shapes, so ``repro_torch.convert.params_from_jax`` maps the
reference's stacked pytree onto them one layer at a time.

The decode state is ``{"kv": [LayerKVCache, ...]}``, one cache per layer
(each with its own spec, so per-layer policies need no special case).
``decode_step`` and ``prefill_chunk`` update the caches in place.
"""

from __future__ import annotations

import torch

from repro_torch.core import cache as kvcache
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} belongs to a later slice of the port "
            "(ROADMAP.md item 11); this slice serves the dense family")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=torch.float32):
    """Random weights from ``seed`` with the reference's init scales."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kw = dict(device=dev, dtype=dtype)
    params = {"emb": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           cfg.tie_embeddings, **kw),
              "ln_f": torch.ones((cfg.d_model,), **kw), "blocks": []}
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln_attn": torch.ones((cfg.d_model,), **kw),
            "attn": attention.init_attention(gen, cfg, **kw),
            "ln_mlp": torch.ones((cfg.d_model,), **kw),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw),
        })
    return params


def cache_specs(cfg: ModelConfig, max_seq: int) -> tuple[kvcache.CacheSpec, ...]:
    """Per-layer specs resolved from the model's CompressionPolicy."""
    return cfg.compression_policy().layer_specs(
        cfg.n_layers, max_seq=max_seq, window=cfg.sliding_window)


def cache_spec(cfg: ModelConfig, max_seq: int) -> kvcache.CacheSpec:
    """Layer-0 spec (THE spec under a uniform policy)."""
    return cfg.compression_policy().spec_for_layer(
        0, max_seq=max_seq, window=cfg.sliding_window)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda"):
    """Fresh (empty) decode state for all layers."""
    _check_family(cfg)
    return {"kv": [kvcache.init_layer_cache(s, batch, cfg.n_kv_heads,
                                            cfg.resolved_head_dim, dtype, device)
                   for s in cache_specs(cfg, max_seq)]}


def insert_decode_row(dst_state, src_state, row: int):
    """Copy a batch-1 decode state into row ``row`` of a batched one, in
    place — the continuous-batching admission splice.  Tensors of equal
    shape (layout dummies, or a one-slot server) are copied whole."""
    for dst, src in zip(dst_state["kv"], src_state["kv"]):
        for f in kvcache.LayerKVCache.FIELDS:
            d, s = getattr(dst, f), getattr(src, f)
            if d.shape == s.shape:
                d.copy_(s)
            else:
                d[row].copy_(s[0])
    return dst_state


def clear_cache_row(state, row: int):
    """Empty row ``row`` of every layer's cache (a retired slot): nothing of
    the old request stays attendable, and the Fetch kernel's loop over the
    row's live blocks ends at once while the vacated slot idles."""
    for c in state["kv"]:
        c.n_flushed[row] = 0
        c.buf_len[row] = 0
    return state


def _mlp_block(block_p, cfg, x):
    h = layers.rms_norm(x, block_p["ln_mlp"], cfg.norm_eps)
    return x + layers.mlp(block_p["mlp"], h)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, position, state):
    """One decode step.  tokens: int [B]; position: int [B] (each row's
    current length; a scalar broadcasts).  Returns (logits [B, V], state)."""
    position = torch.as_tensor(position, dtype=torch.int32, device=tokens.device)
    if position.dim() == 0:
        position = position.expand(tokens.shape[0])
    x = layers.embed_tokens(params["emb"], tokens[:, None])
    for block_p, cache in zip(params["blocks"], state["kv"]):
        x, _ = attention.attn_block_decode(block_p, cfg, x, position, cache)
        x = _mlp_block(block_p, cfg, x)
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return layers.unembed(params["emb"], x[:, 0]), state


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor, pos0, state):
    """One block-chunked prefill step: tokens int [B, C], up to
    ``block_size`` prompt tokens starting at the block boundary ``pos0``
    (scalar or [B]); ``state``'s caches sit at that boundary (raw buffers
    empty).  Returns (logits [B, V] of the chunk's LAST token, state)."""
    B, C = tokens.shape
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=tokens.device)
    if pos0.dim() == 0:
        pos0 = pos0.expand(B)
    positions = pos0[:, None] + torch.arange(C, dtype=torch.int32, device=tokens.device)
    x = layers.embed_tokens(params["emb"], tokens)
    for block_p, cache in zip(params["blocks"], state["kv"]):
        x, _ = attention.attn_block_chunk(block_p, cfg, x, positions, cache)
        x = _mlp_block(block_p, cfg, x)
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return layers.unembed(params["emb"], x[:, -1]), state
