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
//
// multi_decode_stream gives the same codes from the port's multi-symbol
// table (src/repro_torch/core/huffman.py `build_multi_lut`), for books whose
// tree is complete and whose every code fits its 12-bit peek.

#pragma once

#include <stdint.h>

namespace huff {

constexpr int kChunkBits = 8;
constexpr int kMultiPeekBits = 12;  // huffman.py MULTI_PEEK_BITS
constexpr int kMultiMaxSymbols = 4;  // huffman.py MULTI_MAX_SYMBOLS

// Bit count of stream s from the header words.
__device__ __forceinline__ int stream_bits(const uint32_t* hdr, int s) {
  return static_cast<int>((hdr[s >> 1] >> ((s & 1) * 16)) & 0xFFFFu);
}

// The first bit of stream s, for a whole warp at once, from the bit counts
// count(i): lane L holds stream s = s0 + L (s0 the warp's first stream;
// streams at or past n_streams count nothing).  The streams before the warp
// are summed lane-strided and reduced, the warp's own by a shuffle scan.
// Every lane of the warp must call it.
template <typename Count>
__device__ __forceinline__ int stream_start_warp_by(Count count, int s, int n_streams) {
  const int lane = threadIdx.x & 31, s0 = s - lane;
  int before = 0;
  for (int i = lane; i < s0; i += 32) before += count(i);
  before = __reduce_add_sync(0xffffffffu, before);
  const int own = s < n_streams ? count(s) : 0;
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  return before + incl - own;
}

// The first bit of stream s (the exclusive prefix sum of the header's
// counts), for a whole warp at once.
__device__ __forceinline__ int stream_start_warp(const uint32_t* hdr, int s, int n_streams) {
  return stream_start_warp_by([hdr](int i) { return stream_bits(hdr, i); }, s, n_streams);
}

// Decode n symbols of one stream that starts at bit pos and owns the bits
// [pos, end): emit(j, sym) is called for j = 0 .. n-1 in order.  A probe
// reads the 8 stream bits at pos (`_peek_chunk`): they straddle at most the
// two words pos >> 5 and the next, each read clamped to the last of the
// n_words payload words.  Those two words are kept in registers and the word
// after them is loaded ahead, so a symbol's chain is its LUT probes alone (a
// probe consumes at most 8 bits, so pos crosses at most one word a probe).
// The LUT is read through the read-only data path.
template <typename Emit>
__device__ __forceinline__ void lut_decode_stream(const uint32_t* payload, int n_words, int pos,
                                                  int end, const int* __restrict__ lut,
                                                  int probes, int n, Emit emit) {
  const int last = n_words - 1;
  int w = pos >> 5;
  uint32_t lo = payload[min(w, last)], hi = payload[min(w + 1, last)];
  uint32_t nx = payload[min(w + 2, last)];
  for (int j = 0; j < n; ++j) {
    int state = 0, sym = 0;
    bool done = false;
    for (int k = 0; k < probes; ++k) {
      if (done) break;
      const uint32_t b = static_cast<uint32_t>(pos & 31);
      const uint32_t chunk = ((lo >> b) | ((hi << (31u - b)) << 1)) & ((1u << kChunkBits) - 1u);
      const int e = __ldg(lut + (state << kChunkBits) + chunk);
      pos += (e >> 8) & 0xF;
      state = e >> 16;
      if ((e >> 12) & 1) {
        sym = e & 0xFF;
        done = true;
      }
      if ((pos >> 5) != w) {
        ++w;
        lo = hi;
        hi = nx;
        nx = payload[min(w + 2, last)];
      }
    }
    emit(j, pos <= end ? sym : 0);
  }
}

// Decode n symbols of one stream (bits [pos, end)) into row[0 .. n-1] with
// the multi-symbol table: a probe peeks kMultiPeekBits stream bits and emits
// every whole codeword they hold (entry: symbols at bits 8k of .x; .y holds
// the count, the bits consumed through each symbol at bits 4 + 4k, and the
// bits consumed in all at bits 20..23).  The codewords are the ones the
// chunked LUT decodes, one by one, from the same bits: the window below
// (two words in registers, clamped to the last payload word, and the word
// after them loaded ahead) reads the bits lut_decode_stream reads, and a
// symbol whose last bit passes end is 0.  row needs kMultiMaxSymbols - 1
// bytes of room past n.  The window moves by selects, the stores are
// predicated (a branch masks symbols only where the budget may end inside
// the probe), and the next probe's read is issued before this probe's
// stores, so they overlap its latency.
__device__ __forceinline__ void multi_decode_stream(const uint32_t* payload, int n_words, int pos,
                                                    int end, const uint2* tab, int n,
                                                    uint8_t* row) {
  constexpr uint32_t kMask = (1u << kMultiPeekBits) - 1u;
  const int last = n_words - 1;
  int w = pos >> 5;
  uint32_t b = static_cast<uint32_t>(pos & 31);
  uint32_t lo = payload[min(w, last)], hi = payload[min(w + 1, last)];
  uint32_t nx = payload[min(w + 2, last)];
  uint2 e = tab[__funnelshift_r(lo, hi, b) & kMask];
  for (int j = 0; j < n;) {
    const uint32_t adv = e.y >> 20;  // <= 12, so the window moves at most one word
    const bool cross = b + adv >= 32;
    b = (b + adv) & 31u;
    lo = cross ? hi : lo;
    hi = cross ? nx : hi;
    w += cross;
    nx = payload[min(w + 2, last)];
    const uint2 next = tab[__funnelshift_r(lo, hi, b) & kMask];
    const int cnt = static_cast<int>(e.y & 7u);
    uint32_t sym = e.x;
    if (end - pos < kMultiPeekBits) {  // the budget may end inside this probe
#pragma unroll
      for (int k = 0; k < kMultiMaxSymbols; ++k)
        if (pos + static_cast<int>((e.y >> (4 + 4 * k)) & 15u) > end) sym &= ~(0xFFu << (8 * k));
    }
#pragma unroll
    for (int k = 0; k < kMultiMaxSymbols; ++k)
      if (k < cnt) row[j + k] = static_cast<uint8_t>(sym >> (8 * k));
    j += cnt;
    pos += static_cast<int>(adv);
    e = next;
  }
}

}  // namespace huff
