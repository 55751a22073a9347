"""The Fetch kernel: in-place decompression + flash-decode attention over the
compressed cache (``csrc/fused_kv_attn.cu``), and its plain version.

Replaces the Pallas kernel of ``repro.kernels.fused_kv_attn`` (dense and
paged tiles: raw passthrough, packed/kivi no-straddle words, and huffman
slots decoded with the chunked LUT).  One CTA per (row, KV head) decodes
each live block's K and V tile in shared memory, runs the G query rows'
scores and online softmax in float32, and finally folds in the raw buffer
masked by ``buf_len``.  Given a page table, block ``n`` of row ``b`` is read
from arena page ``page_tab[b, n]`` and an unassigned entry is skipped.
Launches count as ``fused_kv_attn``, with ``_huffman`` for huffman tiles and
``_paged`` with a page table.

``fused_cache_attention`` takes the plain version (``ref.
fused_cache_attention_ref``) only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ref import fused_cache_attention_ref as plain

NAME = "fused_kv_attn"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 15 + [_I] * 16 + [ctypes.c_float, _P]
_KINDS = {"raw": 0, "packed": 1, "huffman": 2}


def fused_cache_attention(q, k_store, k_min, k_step, v_store, v_min, v_step,
                          k_buf, v_buf, nb_valid, buf_len, page_tab=None, *, tile,
                          block_size: int, scale: float | None = None) -> torch.Tensor:
    """Decode attention over (store ∥ buffer) -> [B, Hq, D] float32.

    q f32 [B, Hq, D]; stores/units/buffers as ``LayerKVCache`` holds them;
    nb_valid (already clamped to NB) and buf_len int32 [B].  ``page_tab``
    int32 [B, NB] marks a paged cache: the stores are then the shared arena
    [1, Hkv, P, ...]."""
    if q.device.type == "cpu":
        return plain(q, k_store, k_min, k_step, v_store, v_min, v_step, k_buf,
                     v_buf, nb_valid, buf_len, page_tab, tile=tile,
                     block_size=block_size, scale=scale)
    dev = q.device
    runtime.require(dev.type == "cuda", f"{NAME}: q on {dev}")
    B, Hq, D = q.shape
    Hkv, P = k_store.shape[1], k_store.shape[2]
    paged = page_tab is not None
    NB = page_tab.shape[-1] if paged else P
    Bs = 1 if paged else B  # the arena's batch extent is 1
    T = block_size
    G = Hq // Hkv
    max_acc = runtime.library(NAME).fused_kv_attn_max_acc()
    runtime.require(Hq == Hkv * G and G * D <= max_acc,
                    f"{NAME}: {Hq} query heads over {Hkv} KV heads of width {D} "
                    f"exceed the kernel's {max_acc} accumulators a CTA")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bf, i32 = torch.bfloat16, torch.int32
    packed = tile.has_scales  # packed or huffman words with unit scales
    huff = tile.kind == "huffman"
    store_dt = i32 if packed else bf
    checks = [("q", q, torch.float32, (B, Hq, D)),
              ("k_store", k_store, store_dt, (Bs, Hkv, P, *tile.k_tile)),
              ("v_store", v_store, store_dt, (Bs, Hkv, P, *tile.v_tile)),
              ("k_buf", k_buf, bf, (B, Hkv, T, D)), ("v_buf", v_buf, bf, (B, Hkv, T, D)),
              ("nb_valid", nb_valid, i32, (B,)), ("buf_len", buf_len, i32, (B,))]
    if packed:
        checks += [("k_min", k_min, bf, (Bs, Hkv, P, D)), ("k_step", k_step, bf, (Bs, Hkv, P, D)),
                   ("v_min", v_min, bf, (Bs, Hkv, P, T)), ("v_step", v_step, bf, (Bs, Hkv, P, T))]
    if paged:
        checks.append(("page_tab", page_tab, i32, (B, NB)))
    for name, t, dt, shape in checks:
        runtime.check_tensor(NAME, name, t, dt, shape, dev)
    lut_k, lut_v = tile.luts(dev) if huff else (None, None)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    ptr = (lambda t: t.data_ptr()) if packed else (lambda t: None)
    runtime.launch(
        NAME, _ARGTYPES, q.data_ptr(), k_store.data_ptr(), ptr(k_min), ptr(k_step),
        v_store.data_ptr(), ptr(v_min), ptr(v_step), k_buf.data_ptr(), v_buf.data_ptr(),
        nb_valid.data_ptr(), buf_len.data_ptr(), page_tab.data_ptr() if paged else None,
        ptr(lut_k) if huff else None, ptr(lut_v) if huff else None,
        out.data_ptr(), B, Hkv, G, D, T, NB, P,
        tile.k_tile[0] if packed else 0, tile.v_tile[0] if packed else 0,
        tile.bits_k, tile.bits_v, _KINDS[tile.kind], tile.hdr_k, tile.hdr_v, tile.probes_k,
        tile.probes_v, float(scale), runtime.stream_ptr(dev),
        count=NAME + ("_huffman" if huff else "") + ("_paged" if paged else ""))
    return out
