"""Public KVComp facade (the port of ``repro.api``): the one import for
compressing, serving and sizing KV caches.

    from repro_torch import api
    from repro_torch.core.policy import CompressionPolicy

    policy = CompressionPolicy(layout="packed")      # or kivi / huffman / raw
    cache  = api.compress(k, v, policy=policy)       # Store (prefill bulk)
    out    = api.attend(cache, q)                    # Fetch (the fused kernel)
    k2, v2 = api.decompress(cache)                   # reconstruct
    report = api.estimate_ratio(k, v, policy=policy) # exact size accounting

    server = api.serve(cfg, params, max_slots=8)     # continuous batching
    handle = server.submit(api.Request(prompt, max_new_tokens=64))
    for tok in handle.tokens(): ...                  # streaming
    result = handle.result()                         # or block for the rest

Everything dispatches through the ``CacheLayout`` registry
(``repro_torch.core.layouts``): a layout registered with
``@register_layout(name)``, the four built-ins raw / packed / kivi / huffman
included, is servable through this module with no other code aware of it.
Entry points that build device state (``serve``, ``make_cache``,
``compress``) run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch import obs  # noqa: F401  (observability facade: DESIGN.md §14)
from repro_torch.core import cache as kvcache
from repro_torch.core import huffman, layouts, quant
from repro_torch.core import pool as blockpool
from repro_torch.core.policy import CompressionPolicy, LayerOverride, TensorPolicy  # noqa: F401
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serve.scheduler import Handle, Request, Server, ServerConfig  # noqa: F401

__all__ = [
    "CompressionPolicy", "TensorPolicy", "LayerOverride",
    "available_layouts", "register_layout", "make_spec", "make_cache",
    "available_backends", "register_backend",
    "compress", "decompress", "append", "attend", "estimate_ratio",
    "serve", "Server", "ServerConfig", "Request", "Handle", "obs",
]

register_layout = layouts.register_layout
register_backend = kernel_ops.register_backend


def serve(cfg, params, *, max_slots: int = 8, max_seq: int = 4096,
          pad_id: int = 0, policy: str = "fcfs",
          attn_backend: str | None = None,
          cache_mode: str | None = None,
          pool_hbm_bytes: int | None = None,
          prefix_cache: str = "off",
          mesh=None,
          prefill_mode: str = "chunked",
          prefill_chunk_tokens: int | None = None,
          trace: str = "off",
          max_requeues: int = 32,
          max_pending: int | None = None,
          backpressure: str = "reject",
          default_deadline_s: float | None = None,
          faults=None,
          audit_every: int = 0,
          q_chunk: int = 512, kv_chunk: int = 512,
          device="cuda") -> Server:
    """Launch a continuous-batching server over ``cfg``'s cache policy, on
    ``device`` (where ``params`` live).

    Returns a ``repro_torch.serve.scheduler.Server``: ``submit(Request) ->
    Handle`` with ``handle.result()`` / streaming ``handle.tokens()``;
    requests join and leave decode slots at their own positions.  The
    keywords are the reference's (``ServerConfig`` documents each):
    ``policy`` (admission order "fcfs" | "ljf"), ``attn_backend`` (None
    keeps the config's; "auto" runs the Fetch kernel on the card),
    ``cache_mode`` / ``pool_hbm_bytes`` (the paged pool), ``prefix_cache``
    ("on" | "noshare" | "off"), ``prefill_mode`` / ``prefill_chunk_tokens``
    (chunked admission), ``trace`` ("off" | "events" | "full": the event
    trace, exported by ``server.shutdown(trace_out=...)`` as Chrome JSON),
    and the request lifecycle (``max_requeues``, ``max_pending``,
    ``backpressure``, ``default_deadline_s``, ``faults``, ``audit_every``).
    ``mesh`` serves across devices (DESIGN.md §12): a ``("data", "model")``
    mesh of torch devices (``repro_torch.launch.mesh.make_serve_mesh("dp,tp",
    devices=...)``; a device may repeat) shards decode slots, page tables
    and the arena's pages over "data" and KV heads over "model", with one
    copy of the parameters on the mesh's first device, so greedy tokens
    equal the single-device server's; ``server.stats()["shards"]`` reports
    each data shard's pages and preemptions.  ``q_chunk`` sizes the query block
    of the full-length prefill that admits the ssm and hybrid families
    (``attention.flash_attention``); ``kv_chunk`` is accepted and validated
    for the reference's signature and changes nothing here, since a query
    block attends its whole key range in one product.
    """
    if q_chunk < 1 or kv_chunk < 1:
        raise ValueError(f"q_chunk and kv_chunk must be >= 1, got {q_chunk}, {kv_chunk}")
    return Server(cfg, params,
                  ServerConfig(max_slots=max_slots, max_seq=max_seq,
                               pad_id=pad_id, policy=policy,
                               attn_backend=attn_backend,
                               cache_mode=cache_mode,
                               pool_hbm_bytes=pool_hbm_bytes,
                               prefix_cache=prefix_cache,
                               mesh=mesh,
                               prefill_mode=prefill_mode,
                               prefill_chunk_tokens=prefill_chunk_tokens,
                               trace=trace,
                               max_requeues=max_requeues,
                               max_pending=max_pending,
                               backpressure=backpressure,
                               default_deadline_s=default_deadline_s,
                               faults=faults,
                               audit_every=audit_every),
                  device=device, q_chunk=q_chunk)


def available_layouts() -> tuple[str, ...]:
    """Names of every registered cache layout."""
    return layouts.available_layouts()


def available_backends() -> tuple[str, ...]:
    """Names of every registered decode-attention backend."""
    return kernel_ops.available_backends()


def _policy(policy: CompressionPolicy | None) -> CompressionPolicy:
    return policy if policy is not None else CompressionPolicy()


def make_spec(policy: CompressionPolicy | None = None, *, layer: int = 0,
              max_seq: int = 4096, window: int | None = None) -> kvcache.CacheSpec:
    """Resolve a (possibly per-layer-overridden) policy to one CacheSpec."""
    return _policy(policy).spec_for_layer(layer, max_seq=max_seq, window=window)


def make_cache(batch: int, n_kv_heads: int, head_dim: int, *,
               policy: CompressionPolicy | None = None, layer: int = 0,
               max_seq: int = 4096, window: int | None = None,
               dtype=torch.bfloat16, device="cuda") -> kvcache.LayerKVCache:
    """An empty, servable layer cache under the policy's layout."""
    spec = make_spec(policy, layer=layer, max_seq=max_seq, window=window)
    return kvcache.init_layer_cache(spec, batch, n_kv_heads, head_dim, dtype, device=device)


def compress(k, v, *, policy: CompressionPolicy | None = None, layer: int = 0,
             max_seq: int | None = None, window: int | None = None,
             dtype=torch.bfloat16, device="cuda") -> kvcache.LayerKVCache:
    """Bulk-compress prompt KV [B, Hkv, S, D] into a layer cache on
    ``device`` (the Store)."""
    dev = resolve_device(device)
    k, v = torch.as_tensor(k, device=dev), torch.as_tensor(v, device=dev)
    S = k.shape[2]
    spec = make_spec(policy, layer=layer,
                     max_seq=max_seq if max_seq is not None else S, window=window)
    return kvcache.prefill(spec, k, v, dtype)


def decompress(cache: kvcache.LayerKVCache):
    """Reconstruct (k, v) [B, Hkv, S, D]: the decoded store blocks followed
    by the exact raw-buffer tail.  Reads the cache's lengths on the host.
    A paged cache is first gathered back into a private dense ring
    (``repro_torch.core.pool.to_dense``)."""
    cache = blockpool.to_dense(cache)
    spec = cache.spec
    k_deq, v_deq = spec.impl.fetch(spec, cache)
    B, H, NB, T, D = k_deq.shape
    nf = cache.n_flushed.cpu().numpy()
    bl = cache.buf_len.cpu().numpy()
    if not ((nf == nf[0]).all() and (bl == bl[0]).all()):
        raise ValueError(
            "decompress needs uniform per-row lengths (rows of a continuous "
            f"batch are at different positions: n_flushed={nf.tolist()}, "
            f"buf_len={bl.tolist()}); decompress rows individually instead")
    nb = int(nf[0])
    if nb > NB:
        raise ValueError("cache has evicted blocks; only the last "
                         f"{NB * T} store tokens are reconstructible")
    buf = int(bl[0])
    k = torch.cat([k_deq.reshape(B, H, NB * T, D)[:, :, :nb * T], cache.k_buf[:, :, :buf]],
                  dim=2)
    v = torch.cat([v_deq.reshape(B, H, NB * T, D)[:, :, :nb * T], cache.v_buf[:, :, :buf]],
                  dim=2)
    return k, v


def append(cache: kvcache.LayerKVCache, k_new, v_new) -> kvcache.LayerKVCache:
    """Append one token's KV [B, Hkv, D] (compress on block overflow)."""
    return kvcache.append(cache, k_new, v_new)


def attend(cache: kvcache.LayerKVCache, q, scale: float | None = None,
           backend: str | None = None):
    """Single-token decode attention over (store ∥ buffer) -> [B, Hq, D].

    Dispatches through the attention-backend registry; ``backend=None``
    defers to the cache spec (``"auto"``: the Fetch kernel on the card for
    fused-capable layouts, the blockwise scan on the CPU)."""
    return kvcache.attend(cache, q, scale, backend=backend)


def estimate_ratio(k=None, v=None, *, policy: CompressionPolicy | None = None,
                   layer: int = 0, which: str = "both") -> dict:
    """Exact compression-ratio accounting of this policy on real tensors
    ``[ctx, heads, head_dim]``.

    Quantizes K (BlockQuant) and/or V (TokenQuant) under the resolved layer
    policy with ``core.quant`` (the reference's eager arithmetic), fits
    Huffman codebooks where the layout needs them, and returns per-tensor
    ``RatioReport``s plus the combined ratio.  ``which`` in {"k", "v",
    "both"} limits the work to one tensor."""
    if which not in ("k", "v", "both"):
        raise ValueError(f"which must be k|v|both, got {which!r}")
    if (which in ("k", "both") and k is None) or \
            (which in ("v", "both") and v is None):
        raise ValueError(f"which={which!r} needs the corresponding tensor(s)")
    k = torch.as_tensor(k) if k is not None else None
    v = torch.as_tensor(v) if v is not None else None
    ref = k if k is not None else v
    spec = make_spec(policy, layer=layer, max_seq=int(ref.shape[0]))
    lay = spec.impl
    head_dim = int(ref.shape[-1])

    def report(q):
        book = None
        if lay.needs_codebook:
            book = huffman.build_codebook(huffman.histogram(q.codes).cpu().numpy())
        return lay.size_report(q, block_size=spec.block_size, head_dim=head_dim,
                               kivi_bits=spec.bits_k, book=book)

    out = {"layout": spec.layout}
    if which in ("k", "both"):
        qk = (quant.kivi_quantize_k(k, spec.bits_k, 32) if lay.kivi_step
              else quant.quantize_k_block(k, spec.rel_scale_k, spec.block_size))
        out["k"] = report(qk)
    if which in ("v", "both"):
        qv = (quant.kivi_quantize_v(v, spec.bits_v) if lay.kivi_step
              else quant.quantize_v_token(v, spec.rel_scale_v))
        out["v"] = report(qv)
    reports = [out[t] for t in ("k", "v") if t in out]
    total_bits = sum(r.total_bits for r in reports)
    n = sum(r.n_values for r in reports)
    out["ratio"] = n * layouts.RAW_BITS_PER_VALUE / max(total_bits, 1)
    return out
