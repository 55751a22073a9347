"""The Fetch kernel: in-place decompression + flash-decode attention over the
compressed cache (``csrc/fused_kv_attn.cu``), and its plain version.

Replaces the Pallas kernel of ``repro.kernels.fused_kv_attn`` (dense and
paged tiles: raw passthrough, packed/kivi no-straddle words, and huffman
slots decoded with the chunked LUT).  Each CTA of the split kernel takes
``SPLIT_BLOCKS`` consecutive ring slots of one (row, KV head), or the raw
buffer masked by ``buf_len``; it decodes each block's K and V codes into
shared memory, runs the scores and P.V products on the tensor cores (TF32
hi/lo split, the scales folded out of the tiles) with an online softmax in
float32, and writes its partial (acc, m, l) to a float32 workspace.  A
second kernel, ``fused_kv_attn_combine``, merges a row's ranges in
ascending order and the buffer last.  The split depends only on the ring
slot, so a row's output never depends on the rest of the batch.  Given a
page table, block ``n`` of row ``b`` is read from arena page
``page_tab[b, n]`` and an unassigned entry is skipped.  One wrapper call
(two CUDA launches) counts once, as ``fused_kv_attn``, with ``_huffman`` for
huffman tiles and ``_paged`` with a page table.

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
SPLIT_BLOCKS = 1  # ring slots a CTA; the library reports its own (fused_kv_attn_split_blocks)
MAX_G, MAX_DIM = 8, 128  # one mma n-tile of query rows; D, T at most 8 m-tiles
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 16 + [_I] * 16 + [ctypes.c_float, _P]
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
    runtime.require(Hq == Hkv * G and G <= MAX_G,
                    f"{NAME}: {Hq} query heads over {Hkv} KV heads: the kernel takes "
                    f"groups of at most {MAX_G} query heads a KV head")
    runtime.require(all(x % 8 == 0 and 8 <= x <= MAX_DIM for x in (D, T)),
                    f"{NAME}: head_dim {D} and block_size {T} must be multiples of 8 "
                    f"in [8, {MAX_DIM}]")
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
    if packed:
        runtime.require(max(tile.bits_k, tile.bits_v) <= 8,
                        f"{NAME}: code widths of at most 8 bits, got {tile.bits_k}/{tile.bits_v}")
    # bf16 tiles are copied in 16-byte chunks
    for name, t in (("k_buf", k_buf), ("v_buf", v_buf)) + (
            () if packed else (("k_store", k_store), ("v_store", v_store))):
        runtime.require(t.data_ptr() % 16 == 0, f"{NAME}: {name} must be 16-byte aligned")
    lut_k, lut_v = tile.luts(dev) if huff else (None, None)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    ws = torch.empty(workspace_elems(B, Hkv, G, D, NB, split_blocks()), dtype=torch.float32,
                     device=dev)
    ptr = (lambda t: t.data_ptr()) if packed else (lambda t: None)
    runtime.launch(
        NAME, _ARGTYPES, q.data_ptr(), k_store.data_ptr(), ptr(k_min), ptr(k_step),
        v_store.data_ptr(), ptr(v_min), ptr(v_step), k_buf.data_ptr(), v_buf.data_ptr(),
        nb_valid.data_ptr(), buf_len.data_ptr(), page_tab.data_ptr() if paged else None,
        ptr(lut_k) if huff else None, ptr(lut_v) if huff else None, ws.data_ptr(),
        out.data_ptr(), B, Hkv, G, D, T, NB, P,
        tile.k_tile[0] if packed else 0, tile.v_tile[0] if packed else 0,
        tile.bits_k, tile.bits_v, _KINDS[tile.kind], tile.hdr_k, tile.hdr_v, tile.probes_k,
        tile.probes_v, float(scale), runtime.stream_ptr(dev),
        count=NAME + ("_huffman" if huff else "") + ("_paged" if paged else ""))
    return out


def split_blocks() -> int:
    """The ring slots a CTA of the loaded kernel library takes."""
    fn = runtime.library(NAME).fused_kv_attn_split_blocks
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def workspace_elems(B: int, Hkv: int, G: int, D: int, NB: int, split: int) -> int:
    """float32 elements of the split partials: per (row, KV head), each of
    the ceil(NB / split) ring ranges and the buffer holds acc [G, D], m [G]
    and l [G]."""
    return B * Hkv * (-(-NB // split) + 1) * G * (D + 2)
