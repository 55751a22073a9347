"""The Store kernel: quantize + no-straddle pack whole blocks straight into
their cache ring slots (``csrc/pack_encode.cu``), and its plain version.

Replaces the Pallas kernel of ``repro.kernels.pack_encode``, extended to the
contract of the reference's ``PackedLayout.compress_blocks`` (what its server
stores): packed words plus bf16 unit minima and steps, codes from the
float32 step, and the kivi step as an option.  One launch encodes K and V.

Rows whose slot is the drop sentinel (``slot >= NB``) write nothing, so the
decode path launches it on every step without a host-side check.
``pack_encode`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layouts import scatter_slots
from repro_torch.kernels import runtime
from repro_torch.kernels.ref import quant_pack_ref

NAME = "pack_encode"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TENSOR_ARGS = [_P] * 4 + [_I, _F, _I, _I]  # x, words, mn, st, bits, rel, kivi, token
_ARGTYPES = _TENSOR_ARGS * 2 + [_P] + [_I] * 8 + [_P]


def pack_encode_plain(kb, vb, slots, k_store, k_min, k_step, v_store, v_min, v_step,
                      *, bits_k, bits_v, rel_scale_k, rel_scale_v, kivi) -> None:
    """Plain version: compress every row's blocks, then write the flushing
    rows' words and bf16 scales into their slots (drop sentinel = no write)."""
    bf = torch.bfloat16
    for x, bits, rel, tok, stores in (
            (kb, bits_k, rel_scale_k, False, (k_store, k_min, k_step)),
            (vb, bits_v, rel_scale_v, True, (v_store, v_min, v_step))):
        words, mn, st = quant_pack_ref(x, rel, bits, tok, kivi)
        for store, val in zip(stores, (words, mn.to(bf), st.to(bf))):
            scatter_slots(store, slots, val)


def pack_encode(kb, vb, slots, k_store, k_min, k_step, v_store, v_min, v_step,
                *, bits_k: int, bits_v: int, rel_scale_k: float, rel_scale_v: float,
                kivi: bool) -> None:
    """Store stage, in place.

    kb/vb [B, H, n, T, D] raw blocks (bf16 or f32); slots int32 [B, n] ring
    slots (>= NB drops the row); k_store/v_store int32 [B, H, NB, W];
    k_min/k_step bf16 [B, H, NB, D]; v_min/v_step bf16 [B, H, NB, T]."""
    if kb.device.type == "cpu":
        return pack_encode_plain(
            kb, vb, slots, k_store, k_min, k_step, v_store, v_min, v_step,
            bits_k=bits_k, bits_v=bits_v, rel_scale_k=rel_scale_k,
            rel_scale_v=rel_scale_v, kivi=kivi)
    _launch(((kb, k_store, k_min, k_step, bits_k, rel_scale_k, kivi, False),
             (vb, v_store, v_min, v_step, bits_v, rel_scale_v, kivi, True)), slots)


def quant_pack(x: torch.Tensor, *, rel_scale: float, bits: int, token_wise: bool,
               kivi: bool = False):
    """Compress [NBLK, T, D] blocks of one tensor -> (words int32 [NBLK, W],
    mn bf16 [NBLK, U], step bf16 [NBLK, U]).  The scales come back as bf16,
    what the cache stores (the reference's ``ops.quant_pack`` returns the
    float32 scales before that rounding)."""
    NBLK, T, D = x.shape
    if x.device.type == "cpu":
        words, mn, st = quant_pack_ref(x, rel_scale, bits, token_wise, kivi)
        return words, mn.to(torch.bfloat16), st.to(torch.bfloat16)
    cpw = 32 // bits
    U = T if token_wise else D
    words = torch.empty((NBLK, 1, 1, (T * D + cpw - 1) // cpw), dtype=torch.int32,
                        device=x.device)
    mn = torch.empty((NBLK, 1, 1, U), dtype=torch.bfloat16, device=x.device)
    st = torch.empty_like(mn)
    slots = torch.zeros((NBLK, 1), dtype=torch.int32, device=x.device)
    _launch(((x.reshape(NBLK, 1, 1, T, D), words, mn, st, bits, rel_scale, kivi,
              token_wise),), slots)
    return words.reshape(NBLK, -1), mn.reshape(NBLK, U), st.reshape(NBLK, U)


def _launch(tensors, slots) -> None:
    """One kernel launch over 1 or 2 (x, words, mn, st, bits, rel_scale,
    kivi, token_wise) descriptors sharing the block grid and slots."""
    x0 = tensors[0][0]
    dev = x0.device
    runtime.require(dev.type == "cuda", f"{NAME}: blocks on {dev}")
    runtime.require(x0.dtype in (torch.bfloat16, torch.float32),
                    f"{NAME}: blocks must be bf16 or f32, got {x0.dtype}")
    B, H, n, T, D = x0.shape
    NB = tensors[0][1].shape[2]
    runtime.check_tensor(NAME, "slots", slots, torch.int32, (B, n), dev)
    flat = []
    for x, words, mn, st, bits, rel, kivi, tok in tensors:
        runtime.require(1 <= bits <= 8, f"{NAME}: code width must be 1..8 bits, got {bits}")
        cpw = 32 // bits
        U = T if tok else D
        runtime.check_tensor(NAME, "blocks", x, x0.dtype, (B, H, n, T, D), dev)
        runtime.check_tensor(NAME, "words", words, torch.int32,
                             (B, H, NB, (T * D + cpw - 1) // cpw), dev)
        runtime.check_tensor(NAME, "mn", mn, torch.bfloat16, (B, H, NB, U), dev)
        runtime.check_tensor(NAME, "step", st, torch.bfloat16, (B, H, NB, U), dev)
        flat += [x.data_ptr(), words.data_ptr(), mn.data_ptr(), st.data_ptr(),
                 bits, float(rel), int(kivi), int(tok)]
    if len(tensors) == 1:
        flat += [None, None, None, None, 1, 0.0, 0, 0]
    runtime.launch(NAME, _ARGTYPES, *flat, slots.data_ptr(), len(tensors),
                   int(x0.dtype == torch.bfloat16), B, H, n, T, D, NB,
                   runtime.stream_ptr(dev))
