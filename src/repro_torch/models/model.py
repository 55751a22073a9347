"""Model assembly for the dense family (the port of ``repro.models.model``,
serving entry points).

Parameters are nested dicts of tensors: ``emb`` (``embed``, ``unembed``),
``ln_f``, and ``blocks`` — one dict per layer (``ln_attn``, ``attn``
{wq, wk, wv, wo}, ``ln_mlp``, ``mlp`` {w_gate, w_up, w_down}) with the
reference's shapes, so ``repro_torch.convert.params_from_jax`` maps the
reference's stacked pytree onto them one layer at a time.

The decode state is ``{"kv": [LayerKVCache, ...]}``, one cache per layer
(each with its own spec, so per-layer policies need no special case).
``decode_step`` and ``prefill_chunk`` update the caches in place.  Under
``cache_mode="paged"`` with a sized pool the caches hold one shared arena
each plus per-row page tables (DESIGN.md §10); the functions at the end of
the module are the scheduler's page-table and encode-to-page operations.
"""

from __future__ import annotations

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core import pool
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


def cache_specs(cfg: ModelConfig, max_seq: int,
                pool_pages: int = 0) -> tuple[kvcache.CacheSpec, ...]:
    """Per-layer specs resolved from the model's CompressionPolicy.
    ``pool_pages`` sizes the shared paged arena (``cache_mode="paged"``);
    with the default 0 a paged policy resolves to its dense twin."""
    return cfg.compression_policy().layer_specs(
        cfg.n_layers, max_seq=max_seq, window=cfg.sliding_window, pool_pages=pool_pages)


def cache_spec(cfg: ModelConfig, max_seq: int, pool_pages: int = 0) -> kvcache.CacheSpec:
    """Layer-0 spec (THE spec under a uniform policy)."""
    return cfg.compression_policy().spec_for_layer(
        0, max_seq=max_seq, window=cfg.sliding_window, pool_pages=pool_pages)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda", pool_pages: int = 0):
    """Fresh (empty) decode state for all layers.  ``pool_pages`` (serving
    only) sizes each layer's shared arena under ``cache_mode="paged"``."""
    _check_family(cfg)
    return {"kv": [kvcache.init_layer_cache(s, batch, cfg.n_kv_heads,
                                            cfg.resolved_head_dim, dtype, device)
                   for s in cache_specs(cfg, max_seq, pool_pages)]}


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


def insert_decode_row_paged(dst_state, src_state, row: int, pages: torch.Tensor):
    """Paged admission splice: land a batch-1 *dense* decode state (the
    paged spec's dense twin) in row ``row`` of a paged one, scattering its
    blocks into the arena pages ``pages`` (int32 [NB], -1 where the prompt
    left the slot empty) and writing the page-table row."""
    for d, s in zip(dst_state["kv"], src_state["kv"]):
        pool.splice_row(d, s, row, pages)
    return dst_state


def assign_cache_pages(state, rows: torch.Tensor, slots: torch.Tensor, pages: torch.Tensor):
    """Point ``page_tab[rows[i], slots[i]] = pages[i]`` in every layer's cache:
    the scheduler calls this right before the decode step whose buffer flush
    lands in those pages."""
    for c in state["kv"]:
        pool.assign_pages(c, rows, slots, pages)
    return state


def clear_cache_row(state, row: int):
    """Empty row ``row`` of every layer's cache (a retired or preempted
    slot): nothing of the old request stays attendable, and the Fetch
    kernel's loop over the row's live blocks ends at once while the vacated
    slot idles.  In paged mode the page-table row is unassigned too, so the
    slot's idle decode can never write into pages re-issued to another
    request."""
    for c in state["kv"]:
        c.n_flushed[row] = 0
        c.buf_len[row] = 0
        if c.spec.paged:
            pool.clear_row(c, row)
    return state


def chunk_state_view(state, pages: torch.Tensor, pos0: int):
    """Batch-1 view of one row's chunked prefill over the LIVE paged state
    (DESIGN.md §13): every layer's view shares its arena, so
    ``prefill_chunk`` on the view encodes each full chunk straight into the
    pooled pages ``pages`` (int32 [NB]) while the batched state is
    untouched."""
    return {"kv": [pool.chunk_view(c, pages, pos0) for c in state["kv"]]}


def adopt_chunk_stores(state, chunked):
    """Fold a chunk step's arena updates (made through a
    ``chunk_state_view``) back into the live state."""
    for d, s in zip(state["kv"], chunked["kv"]):
        pool.adopt_stores(d, s)
    return state


def install_chunk_row(state, chunked, row: int, pages: torch.Tensor):
    """Finish a chunked prefill: splice the final view's buffers and lengths
    into row ``row`` and point its page-table row at ``pages``, the moment
    the row becomes attendable by the decode batch."""
    for d, s in zip(state["kv"], chunked["kv"]):
        pool.install_row(d, s, row, pages)
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
