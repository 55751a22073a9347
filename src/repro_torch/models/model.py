"""Model assembly for the dense, MoE, ssm and hybrid families (the port of
``repro.models.model``): the training entry points ``forward`` and
``lm_loss``, and the serving ones, the full-length ``prefill``,
``decode_step`` and the block-chunked ``prefill_chunk``.

Parameters are nested dicts of tensors with the reference's names and
shapes: ``emb`` (``embed``, ``unembed``), ``ln_f``, and

* dense / MoE: ``blocks``, one dict per layer (``ln_attn``, ``attn`` {wq,
  wk, wv, wo}, then the FFN: dense ``ln_mlp``, ``mlp`` {w_gate, w_up,
  w_down}; MoE ``ln_moe``, ``moe`` {router, w_gate, w_up, w_down});
* ssm: ``blocks``, one Mamba2 dict per layer (``models.ssm``);
* hybrid (Zamba2): ``mamba``, ``n_periods`` lists of ``period - 1`` Mamba2
  dicts, ``mamba_tail`` (the remainder, when there is one) and ONE
  ``attn_shared`` attention+MLP block that every period runs after its
  Mamba2 blocks.

``repro_torch.convert.params_from_jax`` maps the reference's stacked pytree
onto them.

The decode state is ``{"kv": [LayerKVCache, ...]}`` with one cache per
attention layer (a hybrid has one per period: ``n_cache_layers``), plus
``"ssm"`` (ssm: a state dict per layer; hybrid: per period, per block) and
``"ssm_tail"`` (hybrid), each state dict ``{"conv" [B, K-1, C], "ssm"
[B, H, N, P]}``.  ``decode_step`` and ``prefill_chunk`` update the state
in place.  Under ``cache_mode="paged"`` with a sized pool the caches hold
one shared arena each plus per-row page tables (DESIGN.md §10); the
functions at the end of the module are the scheduler's page-table and
encode-to-page operations.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import cache as kvcache
from repro_torch.core import pool
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.config import ModelConfig

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port serves {FAMILIES}")


def _hybrid_counts(cfg: ModelConfig):
    """(periods, Mamba2 blocks a period, tail Mamba2 blocks) of a hybrid."""
    period = cfg.hybrid_period
    n_periods = cfg.n_layers // period
    return n_periods, period - 1, cfg.n_layers - n_periods * period


def _dense_block(gen, cfg: ModelConfig, kw):
    return {"ln_attn": torch.ones((cfg.d_model,), **kw),
            "attn": attention.init_attention(gen, cfg, **kw),
            "ln_mlp": torch.ones((cfg.d_model,), **kw),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=torch.float32):
    """Random weights from ``seed`` with the reference's init scales
    (``device="meta"``: shapes and dtypes alone, no storage)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    kw = dict(device=dev, dtype=dtype)
    params = {"emb": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           cfg.tie_embeddings, **kw),
              "ln_f": torch.ones((cfg.d_model,), **kw)}
    if cfg.family == "dense":
        params["blocks"] = [_dense_block(gen, cfg, kw) for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        params["blocks"] = [moe.init_moe_block(gen, cfg, **kw) for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        params["blocks"] = [ssm.init_mamba_block(gen, cfg, **kw)
                            for _ in range(cfg.n_layers)]
    else:
        n_periods, ppm, tail = _hybrid_counts(cfg)
        params["mamba"] = [[ssm.init_mamba_block(gen, cfg, **kw) for _ in range(ppm)]
                           for _ in range(n_periods)]
        if tail:
            params["mamba_tail"] = [ssm.init_mamba_block(gen, cfg, **kw)
                                    for _ in range(tail)]
        # ONE shared attention block (Zamba2's weight-shared attention).
        params["attn_shared"] = _dense_block(gen, cfg, kw)
    return params


def _dense_block_axes(cfg: ModelConfig) -> dict:
    return {"ln_attn": ("embed",), "attn": attention.attention_axes(cfg),
            "ln_mlp": ("embed",), "mlp": layers.mlp_axes()}


def param_axes(cfg: ModelConfig):
    """The logical-axes tree of ``init_params``: the same structure, a
    tuple of axis names for each leaf.  A leaf's axes are the reference's
    (``repro.models.model.init_params``) without its stacking axes
    (``layers``, ``periods``): the port holds one dict a layer."""
    _check_family(cfg)
    axes = {"emb": layers.embedding_axes(cfg.tie_embeddings), "ln_f": ("embed",)}
    if cfg.family == "dense":
        axes["blocks"] = [_dense_block_axes(cfg) for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        axes["blocks"] = [moe.moe_block_axes(cfg) for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        axes["blocks"] = [ssm.mamba_block_axes() for _ in range(cfg.n_layers)]
    else:
        n_periods, ppm, tail = _hybrid_counts(cfg)
        axes["mamba"] = [[ssm.mamba_block_axes() for _ in range(ppm)]
                         for _ in range(n_periods)]
        if tail:
            axes["mamba_tail"] = [ssm.mamba_block_axes() for _ in range(tail)]
        axes["attn_shared"] = _dense_block_axes(cfg)
    return axes


def _embed_input(params, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return layers.embed_tokens(params["emb"], batch["tokens"])
    return batch["embeddings"]  # the audio/vlm frontend stub: precomputed


def _run(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward pass under ``remat`` (the
    reference's ``jax.checkpoint`` of its scan bodies)."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def forward(params, cfg: ModelConfig, batch, *, remat: bool = False,
            q_chunk: int = 512, kv_chunk: int = 512):
    """Full-sequence forward (training and evaluation): ``batch`` holds
    ``tokens`` int [B, S] (or ``embeddings`` [B, S, d] under
    ``input_mode="embeddings"``).  Returns (logits [B, S, V], {"aux_loss"}),
    the aux loss summed over the MoE layers (0 elsewhere).  ``remat``
    recomputes each block (each period, for the hybrid) in the backward
    pass.  ``kv_chunk`` is the reference's; nothing reads it here
    (``attention.flash_attention`` has no key chunks)."""
    _check_family(cfg)
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def attn_ffn(block_p, x):
        x = attention.attn_block_train(block_p, cfg, x, positions, q_chunk=q_chunk)
        if cfg.family == "moe":
            h = layers.rms_norm(x, block_p["ln_moe"], cfg.norm_eps)
            y, a = moe.moe_apply(block_p["moe"], cfg, h)
            return x + y, a
        h = layers.rms_norm(x, block_p["ln_mlp"], cfg.norm_eps)
        return x + layers.mlp(block_p["mlp"], h), None

    def period(period_p, x):
        for block_p in period_p:
            x = ssm.mamba_block_train(block_p, cfg, x)
        return attn_ffn(params["attn_shared"], x)[0]

    if cfg.family in ("dense", "moe"):
        for block_p in params["blocks"]:
            x, a = _run(lambda x, p=block_p: attn_ffn(p, x), remat, x)
            if a is not None:
                aux = aux + a
    elif cfg.family == "ssm":
        for block_p in params["blocks"]:
            x = _run(lambda x, p=block_p: ssm.mamba_block_train(p, cfg, x), remat, x)
    else:
        for period_p in params["mamba"]:
            x = _run(lambda x, p=period_p: period(p, x), remat, x)
        for block_p in params.get("mamba_tail", ()):
            x = ssm.mamba_block_train(block_p, cfg, x)
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return layers.unembed(params["emb"], x), {"aux_loss": aux}


def lm_loss(params, cfg: ModelConfig, batch, *, remat: bool = False,
            q_chunk: int = 512, kv_chunk: int = 512, count=None):
    """Next-token cross entropy (tokens mode) or frame cross entropy (encoder
    mode) against ``batch["labels"]`` int [B, S], masked by ``batch["mask"]``
    when given, in float32, plus the MoE aux loss.  Returns ``(loss, {"ce",
    "aux_loss"})``.  ``count`` (a float32 scalar) replaces the mask's own
    count as the mean's denominator: a batch shard's term of the global
    batch's masked mean (``train.step``)."""
    logits, aux = forward(params, cfg, batch, remat=remat, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    lf = logits.to(torch.float32)
    labels = batch["labels"].long()
    ll = lf.gather(-1, labels[..., None])[..., 0] - torch.logsumexp(lf, dim=-1)
    mask = batch.get("mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0) if count is None else count
    loss = -(ll * mask).sum() / denom
    return loss + aux["aux_loss"], {"ce": loss, **aux}


def n_cache_layers(cfg: ModelConfig) -> int:
    """How many KV caches the decode state holds (hybrid: one per period)."""
    if cfg.family in ("dense", "moe"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return _hybrid_counts(cfg)[0]
    return 0


def cache_specs(cfg: ModelConfig, max_seq: int,
                pool_pages: int = 0) -> tuple[kvcache.CacheSpec, ...]:
    """Per-cache-layer specs resolved from the model's CompressionPolicy.
    ``pool_pages`` sizes the shared paged arena (``cache_mode="paged"``);
    with the default 0 a paged policy resolves to its dense twin."""
    return cfg.compression_policy().layer_specs(
        n_cache_layers(cfg), max_seq=max_seq, window=cfg.sliding_window,
        pool_pages=pool_pages)


def cache_spec(cfg: ModelConfig, max_seq: int, pool_pages: int = 0) -> kvcache.CacheSpec:
    """Layer-0 spec (THE spec under a uniform policy)."""
    return cfg.compression_policy().spec_for_layer(
        0, max_seq=max_seq, window=cfg.sliding_window, pool_pages=pool_pages)


def _check_nonuniform_supported(cfg: ModelConfig) -> None:
    if cfg.family == "hybrid" and cfg.cache_overrides:
        raise NotImplementedError(
            "per-layer cache_overrides are not supported for hybrid models "
            "(all periods share one weight-shared attention block)")


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda", pool_pages: int = 0):
    """Fresh (empty) decode state for all layers.  ``pool_pages`` (serving
    only) sizes each layer's shared arena under ``cache_mode="paged"``."""
    _check_family(cfg)
    _check_nonuniform_supported(cfg)
    dev = resolve_device(device)
    state = {}
    if cfg.family != "ssm":
        state["kv"] = [kvcache.init_layer_cache(s, batch, cfg.n_kv_heads,
                                                cfg.resolved_head_dim, dtype, dev)
                       for s in cache_specs(cfg, max_seq, pool_pages)]

    def fresh():
        return ssm.init_mamba_state(cfg, batch, device=dev)

    if cfg.family == "ssm":
        state["ssm"] = [fresh() for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_periods, ppm, tail = _hybrid_counts(cfg)
        state["ssm"] = [[fresh() for _ in range(ppm)] for _ in range(n_periods)]
        if tail:
            state["ssm_tail"] = [fresh() for _ in range(tail)]
    return state


def _insert_leaf(d: torch.Tensor, s: torch.Tensor, row: int) -> None:
    """The reference's per-leaf splice: equal shapes copy whole (a one-slot
    server); otherwise the batch axis is the first axis where the shapes
    differ, and the source has extent 1 there."""
    if d.shape == s.shape:
        d.copy_(s)
        return
    axis = next(i for i, (a, b) in enumerate(zip(d.shape, s.shape)) if a != b)
    if s.shape[axis] != 1:
        raise ValueError(f"source state is not batch=1: {tuple(s.shape)} at axis {axis}")
    d.narrow(axis, row, 1).copy_(s)


def _insert_tree(d, s, row: int) -> None:
    if isinstance(d, dict):
        for key in d:
            _insert_tree(d[key], s[key], row)
    elif isinstance(d, (list, tuple)):
        for a, b in zip(d, s):
            _insert_tree(a, b, row)
    else:
        _insert_leaf(d, s, row)


def insert_decode_row(dst_state, src_state, row: int):
    """Copy a batch-1 decode state into row ``row`` of a batched one, in
    place — the continuous-batching admission splice, for every family:
    each cache field and each SSM state leaf takes the per-leaf rule."""
    for key in dst_state:
        if key == "kv":
            for dst, src in zip(dst_state["kv"], src_state["kv"]):
                for f in kvcache.LayerKVCache.FIELDS:
                    _insert_leaf(getattr(dst, f), getattr(src, f), row)
        else:
            _insert_tree(dst_state[key], src_state[key], row)
    return dst_state


def insert_decode_row_paged(dst_state, src_state, row: int, pages: torch.Tensor):
    """Paged admission splice: land a batch-1 *dense* decode state (the
    paged spec's dense twin) in row ``row`` of a paged one, scattering its
    blocks into the arena pages ``pages`` (int32 [NB], -1 where the prompt
    left the slot empty) and writing the page-table row.  Every non-KV
    leaf (a hybrid's SSM states) takes the per-leaf splice."""
    for key in dst_state:
        if key == "kv":
            for d, s in zip(dst_state["kv"], src_state["kv"]):
                pool.splice_row(d, s, row, pages)
        else:
            _insert_tree(dst_state[key], src_state[key], row)
    return dst_state


def assign_cache_pages(state, rows: torch.Tensor, slots: torch.Tensor, pages: torch.Tensor):
    """Point ``page_tab[rows[i], slots[i]] = pages[i]`` in every layer's cache:
    the scheduler calls this right before the decode step whose buffer flush
    lands in those pages."""
    for c in state["kv"]:
        pool.assign_pages(c, rows, slots, pages)
    return state


def clear_cache_row(state, row: int):
    """Unassign row ``row``'s pages in every layer's page table (a retired,
    cancelled or preempted slot of a paged server): the slot's idle decode
    can never write into pages re-issued to another request, and its reads
    skip the unassigned entries.  Lengths stay as they were, as in the
    reference: under MoE an idle row's hidden state takes part in the
    batch's expert capacity, so its inputs must be the reference's."""
    for c in state["kv"]:
        pool.clear_row(c, row)
    return state


def gather_prefix_state(state, pages: torch.Tensor, n_blocks: int):
    """Seed a batch-1 *dense* decode state from cached arena pages, the
    prefix-hit path of a server whose chunks run on a private state
    (DESIGN.md §11).  ``pages``: int32 [NB], the physical page of logical
    block ``i`` for the first ``n_blocks`` blocks (-1 beyond).  Every
    layer's cache copies its blocks bit for bit out of the live arena with
    an empty raw buffer, so ``prefill_chunk`` resumes at block ``n_blocks``
    as if it had chunked the whole prefix itself.  The single-card server
    chunks through the live arena (``chunk_state_view``) and does not call
    this."""
    return {"kv": [pool.gather_pages(c, pages, n_blocks) for c in state["kv"]]}


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


def _ffn_block(block_p, cfg, x):
    """The block's pre-norm FFN with its residual: the MoE layer (its aux
    loss dropped, as serving does) or the dense SwiGLU."""
    if cfg.family == "moe":
        h = layers.rms_norm(x, block_p["ln_moe"], cfg.norm_eps)
        return x + moe.moe_apply(block_p["moe"], cfg, h)[0]
    h = layers.rms_norm(x, block_p["ln_mlp"], cfg.norm_eps)
    return x + layers.mlp(block_p["mlp"], h)


def _shared_block_tail(params, cfg: ModelConfig, x):
    """The hybrid's weight-shared block after its attention: the MLP."""
    p = params["attn_shared"]
    return x + layers.mlp(p["mlp"], layers.rms_norm(x, p["ln_mlp"], cfg.norm_eps))


def prefill(params, cfg: ModelConfig, batch, max_seq: int, q_chunk: int = 512):
    """Process a whole prompt: ``batch`` {"tokens": int [B, S]}.  Returns
    (logits [B, S, V], a fresh batch-B decode state): every attention
    layer's compressed cache built from the prompt's K/V in one Store call
    (whole blocks; the remainder in the raw buffer), every Mamba2 block's
    conv window and SSM state.  Caches are dense (the dense twin of a
    paged spec); the scheduler splices them into its live state."""
    _check_family(cfg)
    _check_nonuniform_supported(cfg)
    x = _embed_input(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    state = {}
    if cfg.family in ("dense", "moe"):
        caches = []
        for block_p, spec in zip(params["blocks"], cache_specs(cfg, max_seq)):
            x, cache = attention.attn_block_prefill(block_p, cfg, x, positions, spec,
                                                    q_chunk=q_chunk)
            x = _ffn_block(block_p, cfg, x)
            caches.append(cache)
        state["kv"] = caches
    elif cfg.family == "ssm":
        state["ssm"] = []
        for block_p in params["blocks"]:
            x, st = ssm.mamba_block_prefill(block_p, cfg, x)
            state["ssm"].append(st)
    else:
        spec = cache_spec(cfg, max_seq)
        state["kv"], state["ssm"] = [], []
        for period_p in params["mamba"]:
            states = []
            for block_p in period_p:
                x, st = ssm.mamba_block_prefill(block_p, cfg, x)
                states.append(st)
            x, cache = attention.attn_block_prefill(params["attn_shared"], cfg, x,
                                                    positions, spec, q_chunk=q_chunk)
            x = _shared_block_tail(params, cfg, x)
            state["ssm"].append(states)
            state["kv"].append(cache)
        if "mamba_tail" in params:
            state["ssm_tail"] = []
            for block_p in params["mamba_tail"]:
                x, st = ssm.mamba_block_prefill(block_p, cfg, x)
                state["ssm_tail"].append(st)
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return layers.unembed(params["emb"], x), state


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, position, state):
    """One decode step.  tokens: int [B]; position: int [B] (each row's
    current length; a scalar broadcasts).  Returns (logits [B, V], state)."""
    position = torch.as_tensor(position, dtype=torch.int32, device=tokens.device)
    if position.dim() == 0:
        position = position.expand(tokens.shape[0])
    x = layers.embed_tokens(params["emb"], tokens[:, None])
    if cfg.family in ("dense", "moe"):
        for block_p, cache in zip(params["blocks"], state["kv"]):
            x, _ = attention.attn_block_decode(block_p, cfg, x, position, cache)
            x = _ffn_block(block_p, cfg, x)
    elif cfg.family == "ssm":
        for block_p, st in zip(params["blocks"], state["ssm"]):
            x, _ = ssm.mamba_block_decode(block_p, cfg, x, st)
    else:
        for period_p, states, cache in zip(params["mamba"], state["ssm"], state["kv"]):
            for block_p, st in zip(period_p, states):
                x, _ = ssm.mamba_block_decode(block_p, cfg, x, st)
            x, _ = attention.attn_block_decode(params["attn_shared"], cfg, x, position,
                                               cache)
            x = _shared_block_tail(params, cfg, x)
        for block_p, st in zip(params.get("mamba_tail", ()), state.get("ssm_tail", ())):
            x, _ = ssm.mamba_block_decode(block_p, cfg, x, st)
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return layers.unembed(params["emb"], x[:, 0]), state


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor, pos0, state):
    """One block-chunked prefill step: tokens int [B, C], up to
    ``block_size`` prompt tokens starting at the block boundary ``pos0``
    (scalar or [B]); ``state``'s caches sit at that boundary (raw buffers
    empty).  Returns (logits [B, V] of the chunk's LAST token, state).
    Pure-KV families only, as in the reference: an SSM state has no
    chunk step."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"block-chunked prefill needs pure-KV decode state (family {cfg.family!r})")
    B, C = tokens.shape
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=tokens.device)
    if pos0.dim() == 0:
        pos0 = pos0.expand(B)
    positions = pos0[:, None] + torch.arange(C, dtype=torch.int32, device=tokens.device)
    x = layers.embed_tokens(params["emb"], tokens)
    for block_p, cache in zip(params["blocks"], state["kv"]):
        x, _ = attention.attn_block_chunk(block_p, cfg, x, positions, cache)
        x = _ffn_block(block_p, cfg, x)
    x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return layers.unembed(params["emb"], x[:, -1]), state
