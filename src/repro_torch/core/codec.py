"""KVComp compression pipelines: quantization then entropy coding (the port
of ``repro.core.codec``, paper §3).

Two pipelines share the §3.1.1 quantizer:

* the Huffman pipeline, the maximal-ratio path: per-layer shared canonical
  codebooks (built once from prefill histograms, §3.2), streams packed at
  deterministic cumsum offsets;
* the packed pipeline: per-block adaptive fixed-length packing.

Both report compression ratios with full metadata accounting.  The
accounting lives with the cache layouts (``repro_torch.core.layouts``:
every ``CacheLayout`` owns its ``size_report``); this module re-exports the
report helpers and adds the host-side codebook fitting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack, huffman, layouts, quant
from repro_torch.core.layouts import (  # noqa: F401  (re-exported public API)
    RAW_BITS_PER_VALUE,
    RatioReport,
    huffman_ratio,
    kivi_ratio,
    packed_ratio,
)


@dataclasses.dataclass
class KVCompCodec:
    """End-to-end codec with per-layer shared codebooks (paper §3.2)::

        codec = KVCompCodec(quant.QuantConfig(...))
        codec.fit(k_prefill, v_prefill)          # build codebooks once
        qk = codec.quantize_k(k)                 # the lossy step
        report = codec.report_k(qk)              # exact size accounting

    Size reports dispatch through the cache-layout registry, so any
    registered layout name is a valid ``mode``."""

    cfg: quant.QuantConfig
    book_k: huffman.CodeBook | None = None
    book_v: huffman.CodeBook | None = None

    # -- the lossy step -------------------------------------------------------
    def quantize_k(self, k) -> quant.Quantized:
        if self.cfg.k_granularity == "block":
            return quant.quantize_k_block(k, self.cfg.rel_scale_k, self.cfg.block_size)
        return quant.quantize_k_channel(k, self.cfg.rel_scale_k)

    def quantize_v(self, v) -> quant.Quantized:
        return quant.quantize_v_token(v, self.cfg.rel_scale_v)

    # -- codebooks (prefill time, host) ---------------------------------------
    def fit(self, k, v) -> None:
        qk, qv = self.quantize_k(k), self.quantize_v(v)
        self.book_k = huffman.build_codebook(huffman.histogram(qk.codes).cpu().numpy())
        self.book_v = huffman.build_codebook(huffman.histogram(qv.codes).cpu().numpy())

    # -- size accounting ------------------------------------------------------
    def _report(self, q: quant.Quantized, mode: str, book) -> RatioReport:
        if mode == "huffman" and book is None:
            raise ValueError("call fit() first")
        return layouts.get_layout(mode).size_report(
            q, block_size=self.cfg.block_size, head_dim=q.codes.shape[-1],
            kivi_bits=self.cfg.kivi_bits, book=book)

    def report_k(self, qk: quant.Quantized, mode: str = "huffman") -> RatioReport:
        return self._report(qk, mode, self.book_k)

    def report_v(self, qv: quant.Quantized, mode: str = "huffman") -> RatioReport:
        return self._report(qv, mode, self.book_v)

    # -- full encode / decode (the ragged Huffman container) -------------------
    def _book(self, which: str) -> huffman.CodeBook:
        book = self.book_k if which == "k" else self.book_v
        if book is None:
            raise ValueError("call fit() first")
        return book

    def encode_huffman(self, q: quant.Quantized, which: str = "k"):
        """Encode quantized codes, a stream a row of ``head_dim`` codes.
        Returns (payload int32 words, nbits int32 [streams], codes_shape)."""
        book = self._book(which)
        shape = tuple(q.codes.shape)
        streams = q.codes.reshape(-1, shape[-1])
        cap = streams.numel() * huffman.MAX_CODE_LEN // 32 + 2
        payload, nbits, _ = huffman.encode_block_torch(
            streams, *book.encode_tables(streams.device), cap)
        return payload, nbits, shape

    def decode_huffman(self, payload, nbits, codes_shape, which: str = "k"):
        book = self._book(which)
        lut = torch.as_tensor(book.decode_lut(), device=payload.device)
        out = huffman.decode_block_lut_torch(payload, nbits, lut, codes_shape[-1],
                                             book.decode_probes)
        return out.reshape(codes_shape)

    # -- the packed pipeline --------------------------------------------------
    def encode_packed(self, q: quant.Quantized, pow2: bool = True) -> bitpack.AdaptivePacked:
        block_codes = self.cfg.block_size * q.codes.shape[-1]
        codes2d = q.codes.reshape(-1, block_codes)
        cap = codes2d.numel() // 4 + codes2d.shape[0]  # >= the worst case, 8 bits a value
        return bitpack.pack_adaptive(codes2d, capacity_words=cap, pow2=pow2)

    def decode_packed(self, packed: bitpack.AdaptivePacked, codes_shape):
        return bitpack.unpack_adaptive(packed).reshape(codes_shape)


def compute_histogram_figure(qcodes, n_show: int = 32) -> np.ndarray:
    """Paper Fig. 3 analogue: histogram of quantized KV codes."""
    codes = qcodes.cpu().numpy() if torch.is_tensor(qcodes) else np.asarray(qcodes)
    return np.bincount(codes.reshape(-1), minlength=256)[:n_show]
