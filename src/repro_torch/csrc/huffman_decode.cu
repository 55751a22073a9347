// Huffman decode kernels for Hopper (sm_90a): the paper's branchless
// bit-serial tree walk, alone and fused with the K scores, and the chunked
// LUT decode of whole cache slots.
//
// huffman_decode_kernel replaces the Pallas TPU kernel
// src/repro/kernels/huffman_decode.py:56 (`_decode_kernel`, launched by
// `huffman_decode_pallas`); huffman_attn_scores_kernel replaces
// src/repro/kernels/huffman_decode.py:65 (`_fused_scores_kernel`, launched by
// `huffman_attn_scores_pallas`).  Both compute what `walk_decode_jax`
// (src/repro/core/huffman.py:402) computes: stream s of a block walks the
// array-based tree one payload bit at a time (idx = children[idx, bit]),
// writes the symbol at its output column w at a leaf, advances w and resets to
// the root, for at most max_bits bits and never past its own nbits; nothing
// lands past n_per_stream, and columns a short stream never reaches stay 0.
// The scores kernel then dequantizes each column (kmn[w] + c * kst[w]) and
// sums (K.q) * scale in float32, column by column.
//
// Design: the paper's own GPU mapping, one CTA a block and one thread a
// stream, with the tree tables (children, is_symbol, symbols: 8 KB at the
// padded 512 nodes) in shared memory.  A thread keeps its current payload word
// in a register and reads the next one through the read-only path only when
// its bit position crosses a word.  A lane stops at its nbits: past it the
// walk contributes nothing, and it would otherwise read the next stream's bits.
//
// huffman_lut_decode_kernel has no Pallas counterpart: it is the blockwise
// chunk path's slot decode (`HuffmanLayout._decode`, src/repro/core/
// layouts.py:755-774, which the reference runs as one XLA loop).  One CTA a
// slot stages the slot (u16 header + payload) in shared memory; thread t
// decodes stream t with the chunked LUT of huffman.cuh into a shared-memory
// tile of codes, which the CTA then writes out row-major.
//
// What bounds them on an H100: by the card's rates, bytes (a block's payload,
// a few KB, and its codes or scores out), but in fact latency: every symbol
// is a chain of dependent reads (tree steps or LUT probes), and a block has
// only S = 64 streams at Yi-6B width.  Simple and right first; times beside
// the bound are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman.cuh"

namespace {

struct WalkArgs {
  const uint32_t* payload;  // [NBLK, W]
  const int* nbits;         // [NBLK, S] (u16 values)
  const int* children;      // [n_nodes, 2]
  const int* is_symbol;     // [n_nodes]
  const int* symbols;       // [n_nodes]
  int W, S, L, n_nodes, max_bits;
};

// Stage the tree tables and the block's bit counts in shared memory.
__device__ void stage_tables(const WalkArgs& a, int blk, int* ch, int* isym, int* sym,
                             int* nb) {
  for (int i = threadIdx.x; i < 2 * a.n_nodes; i += blockDim.x) ch[i] = a.children[i];
  for (int i = threadIdx.x; i < a.n_nodes; i += blockDim.x) {
    isym[i] = a.is_symbol[i];
    sym[i] = a.symbols[i];
  }
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) nb[s] = a.nbits[blk * a.S + s];
  __syncthreads();
}

// The branchless walk of stream s: emit(w, sym) at each leaf with w < L.
// Returns the number of leaves reached.
template <typename Emit>
__device__ int walk_stream(const WalkArgs& a, int blk, const int* ch, const int* isym,
                           const int* sym, const int* nb, int s, Emit emit) {
  const uint32_t* payload = a.payload + static_cast<size_t>(blk) * a.W;
  int start = 0;
  for (int i = 0; i < s; ++i) start += nb[i];
  const int n = min(nb[s], a.max_bits);
  int idx = 0, w = 0, cur = -1;
  uint32_t word = 0;
  for (int p = 0; p < n; ++p) {
    const int g = start + p;
    const int wi = min(g >> 5, a.W - 1);  // reads clamp to the payload, as the walk's gathers
    if (wi != cur) {
      word = __ldg(payload + wi);
      cur = wi;
    }
    idx = ch[2 * idx + ((word >> (g & 31)) & 1u)];
    if (isym[idx]) {
      if (w < a.L) emit(w, sym[idx]);
      ++w;
      idx = 0;
    }
  }
  return w;
}

__global__ void huffman_decode_kernel(WalkArgs a, uint8_t* out) {
  extern __shared__ int smem[];
  int* ch = smem;
  int* isym = ch + 2 * a.n_nodes;
  int* sym = isym + a.n_nodes;
  int* nb = sym + a.n_nodes;
  const int blk = blockIdx.x;
  stage_tables(a, blk, ch, isym, sym, nb);
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    uint8_t* row = out + (static_cast<size_t>(blk) * a.S + s) * a.L;
    const int w = walk_stream(a, blk, ch, isym, sym, nb, s,
                              [&](int c, int v) { row[c] = static_cast<uint8_t>(v); });
    for (int c = w; c < a.L; ++c) row[c] = 0;
  }
}

__global__ void huffman_attn_scores_kernel(WalkArgs a, const float* k_min, const float* k_step,
                                           const float* q, float scale, float* out) {
  extern __shared__ int smem[];
  int* ch = smem;
  int* isym = ch + 2 * a.n_nodes;
  int* sym = isym + a.n_nodes;
  int* nb = sym + a.n_nodes;
  float* kmn = reinterpret_cast<float*>(nb + a.S);
  float* kst = kmn + a.L;
  float* qs = kst + a.L;
  const int blk = blockIdx.x;
  for (int d = threadIdx.x; d < a.L; d += blockDim.x) {
    kmn[d] = k_min[static_cast<size_t>(blk) * a.L + d];
    kst[d] = k_step[static_cast<size_t>(blk) * a.L + d];
    qs[d] = q[d];
  }
  stage_tables(a, blk, ch, isym, sym, nb);
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    float acc = 0.f;
    const int w = walk_stream(a, blk, ch, isym, sym, nb, s, [&](int c, int v) {
      acc += (kmn[c] + static_cast<float>(v) * kst[c]) * qs[c];
    });
    for (int c = w; c < a.L; ++c) acc += kmn[c] * qs[c];  // code 0 past the stream's end
    out[static_cast<size_t>(blk) * a.S + s] = acc * scale;
  }
}

__global__ void huffman_lut_decode_kernel(const uint32_t* slots, const int* lut, uint8_t* out,
                                          int W, int hdr, int T, int D, int probes) {
  extern __shared__ uint32_t words[];  // W slot words, then T rows of D + 4 code bytes
  uint8_t* codes = reinterpret_cast<uint8_t*>(words + W);
  const int DP = D + 4;  // row stride: 33 words at D = 128, so the rows' writes spread over banks
  const size_t n = blockIdx.x;
  for (int i = threadIdx.x; i < W; i += blockDim.x) words[i] = slots[n * W + i];
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int pos = huff::stream_start(words, t);
    uint8_t* row = codes + t * DP;
    huff::lut_decode_stream(words + hdr, W - hdr, pos, pos + huff::stream_bits(words, t), lut,
                            probes, D, [&](int d, int c) { row[d] = static_cast<uint8_t>(c); });
  }
  __syncthreads();
  uint8_t* dst = out + n * T * D;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) dst[i] = codes[(i / D) * DP + i % D];
}

int threads_for(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename Kernel>
int set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

WalkArgs walk_args(const void* payload, const void* nbits, const void* children,
                   const void* is_symbol, const void* symbols, int W, int S, int L,
                   int n_nodes, int max_bits) {
  WalkArgs a;
  a.payload = static_cast<const uint32_t*>(payload);
  a.nbits = static_cast<const int*>(nbits);
  a.children = static_cast<const int*>(children);
  a.is_symbol = static_cast<const int*>(is_symbol);
  a.symbols = static_cast<const int*>(symbols);
  a.W = W; a.S = S; a.L = L; a.n_nodes = n_nodes; a.max_bits = max_bits;
  return a;
}

}  // namespace

extern "C" {

const char* huffman_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher runs its kernel on `stream` and returns cudaGetLastError().

int huffman_decode_launch(const void* payload, const void* nbits, const void* children,
                          const void* is_symbol, const void* symbols, void* out, int NBLK,
                          int W, int S, int L, int n_nodes, int max_bits, void* stream) {
  const WalkArgs a = walk_args(payload, nbits, children, is_symbol, symbols, W, S, L, n_nodes,
                               max_bits);
  const size_t smem = sizeof(int) * (4 * static_cast<size_t>(n_nodes) + S);
  const int e = set_smem(huffman_decode_kernel, smem);
  if (e != 0) return e;
  huffman_decode_kernel<<<NBLK, threads_for(S), smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int huffman_attn_scores_launch(const void* payload, const void* nbits, const void* children,
                               const void* is_symbol, const void* symbols, const void* k_min,
                               const void* k_step, const void* q, void* out, int NBLK, int W,
                               int S, int L, int n_nodes, int max_bits, float scale,
                               void* stream) {
  const WalkArgs a = walk_args(payload, nbits, children, is_symbol, symbols, W, S, L, n_nodes,
                               max_bits);
  const size_t smem = sizeof(int) * (4 * static_cast<size_t>(n_nodes) + S) +
                      sizeof(float) * 3 * static_cast<size_t>(L);
  const int e = set_smem(huffman_attn_scores_kernel, smem);
  if (e != 0) return e;
  huffman_attn_scores_kernel<<<NBLK, threads_for(S), smem,
                               static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(k_min), static_cast<const float*>(k_step),
      static_cast<const float*>(q), scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int huffman_lut_decode_launch(const void* slots, const void* lut, void* out, int N, int W,
                              int hdr, int T, int D, int probes, void* stream) {
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(W) +
                      static_cast<size_t>(T) * (D + 4);
  const int e = set_smem(huffman_lut_decode_kernel, smem);
  if (e != 0) return e;
  huffman_lut_decode_kernel<<<N, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(slots), static_cast<const int*>(lut),
      static_cast<uint8_t*>(out), W, hdr, T, D, probes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
