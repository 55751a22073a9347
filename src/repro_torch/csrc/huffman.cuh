// Device-side Huffman stream reading shared by the Fetch kernel's huffman
// tile decode (fused_kv_attn.cu) and the huffman decode kernels
// (huffman_decode.cu).
//
// Streams are LSB-first within little-endian u32 words: global bit position p
// lives at word p >> 5, bit p & 31.  A block's slot is a u16 header of
// per-stream bit counts (stream 2i in the low half of word i, 2i+1 in the high
// half) followed by the payload, the streams packed back to back.
//
// The LUT decode follows src/repro/core/huffman.py `decode_block_lut_jax`
// bit for bit: a flat [n_nodes * 256] int32 table whose entry [state, chunk]
// holds the first symbol reached from node `state` along the chunk's 8 bits
// (bits 0..7 symbol, 8..11 bits consumed, bit 12 emitted, 16.. next node).
// Each symbol takes `probes` (1 or 2) probes; a symbol whose codeword would
// run past its stream's budget decodes to 0 (the `pos <= ends` mask), and
// word reads clamp to the last payload word.

#pragma once

#include <stdint.h>

namespace huff {

constexpr int kChunkBits = 8;

// Bit count of stream s from the header words.
__device__ __forceinline__ int stream_bits(const uint32_t* hdr, int s) {
  return static_cast<int>((hdr[s >> 1] >> ((s & 1) * 16)) & 0xFFFFu);
}

// First bit of stream s: the exclusive prefix sum of the header's counts.
__device__ __forceinline__ int stream_start(const uint32_t* hdr, int s) {
  int pos = 0;
  for (int i = 0; i < s; ++i) pos += stream_bits(hdr, i);
  return pos;
}

// The 8 stream bits at bit position pos (`_peek_chunk`): straddles at most
// two words, both reads clamped to the last of the n_words payload words.
__device__ __forceinline__ uint32_t peek_chunk(const uint32_t* payload, int pos, int n_words) {
  const int w = min(pos >> 5, n_words - 1);
  const uint32_t b = static_cast<uint32_t>(pos & 31);
  const uint32_t lo = payload[w] >> b;
  const uint32_t hi = (payload[min(w + 1, n_words - 1)] << (31u - b)) << 1;  // x << (32 - b)
  return (lo | hi) & ((1u << kChunkBits) - 1u);
}

// Decode n symbols of one stream that starts at bit pos and owns the bits
// [pos, end): emit(j, sym) is called for j = 0 .. n-1 in order.  The LUT is
// read through the read-only data path.
template <typename Emit>
__device__ __forceinline__ void lut_decode_stream(const uint32_t* payload, int n_words, int pos,
                                                  int end, const int* __restrict__ lut,
                                                  int probes, int n, Emit emit) {
  for (int j = 0; j < n; ++j) {
    int state = 0, sym = 0;
    bool done = false;
    for (int k = 0; k < probes; ++k) {
      if (done) break;
      const int e = __ldg(lut + (state << kChunkBits) + peek_chunk(payload, pos, n_words));
      pos += (e >> 8) & 0xF;
      state = e >> 16;
      if ((e >> 12) & 1) {
        sym = e & 0xFF;
        done = true;
      }
    }
    emit(j, pos <= end ? sym : 0);
  }
}

}  // namespace huff
