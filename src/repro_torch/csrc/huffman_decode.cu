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
// layouts.py:755-774, which the reference runs as one XLA loop), of K and V
// in one launch.  It writes the codes of the reference's chunked LUT decode
// (`decode_block_lut_jax`), edge cases included.
//
// What bounds the walk kernels on an H100: by the card's rates, bytes (a
// block's payload, a few KB, and its codes or scores out), but in fact
// latency: every symbol is a chain of dependent reads (tree steps or LUT
// probes), and a block has only S = 64 streams at Yi-6B width.  Simple and
// right first; times beside the bound are in PERF.md.
//
// The slot decode is bound the same way.  By the card's rates a 64-slot
// span of one layer is 0.5 MB of slots and codes, 0.2 us; in fact a slot's
// time is its staging plus one stream's chain of table reads, and the launch.
// An instrumented copy of the earlier one-slot-a-CTA kernel showed the chain
// of 128 probes a stream taking most of a slot's cycles, a probe costing
// about an L2 trip, then the byte-wise copy-out, the 4-byte slot copy and
// the serial header sums.  The design:
// - Probes.  Where the book allows it (every code fits 12 bits, the tree is
//   complete: the layout's default books), a probe reads the port's
//   multi-symbol table (huffman.py `build_multi_lut`, huffman.cuh
//   `multi_decode_stream`): 12 stream bits -> every whole codeword they hold,
//   2 or 3 for K (4 to 5 bits), 4 for V (3 bits), so 53 and 32 probes a
//   stream where the LUT takes 128.  The table (32 KB) is staged in shared
//   memory: read through L1, a cold CTA's probes cost an L2 trip each.  The
//   chain step moves its window by selects and issues the next probe's read
//   before this probe's stores.  Other books keep the chunked LUT's 1 or 2
//   probes a symbol, through the read-only path.
// - Copies.  The slots (4-byte aligned rows) and then the table are staged
//   with 16-byte cp.async copies of the granules that cover them, all in
//   flight at once; the header scan runs while the table arrives.  Codes
//   leave in 16-byte stores from rows of stride D + 4.
// - Streams.  Every thread of a slot decodes one stream and finds its first
//   bit with the warp scan over the header (huff::stream_start_warp).
// - Occupancy.  A CTA takes two slots of one tensor: the table is the
//   largest thing a CTA stages, so two slots share one copy of it, and at
//   T = 64 the CTA's four warps give each of an SM's schedulers one chain.
//   K and V slots go to different CTAs of the same launch.
// `-Xptxas -v` for sm_90a: the slot decode 32 registers, the walk kernels
// 31; no stack, no spills.  Shared memory of a slot-decode CTA at Yi-6B
// width: 32,768 B of table, 16,896 B of code rows, 2 x 5,280 B of K slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
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

// The slot LUT decode.  A CTA takes kSlotsPerCta slots of one tensor, Tw =
// T rounded up to a warp threads a slot, thread s of a slot decoding its
// stream s.  Shared memory: the tensor's multi-symbol table (where it has
// one), the code rows of each slot (row stride D + 4 bytes, so a warp's
// stores and the copy-out's reads spread over the banks), then each slot as
// staged (the 16-byte granules that cover it).
constexpr int kSlotsPerCta = 2;
constexpr int kMultiBytes = static_cast<int>(sizeof(uint2)) << huff::kMultiPeekBits;

struct SlotTensor {
  const uint32_t* slots;  // [N, W]: u16 header of T bit counts, then the payload
  const int* lut;         // chunked LUT [n_nodes * 256]
  const uint2* multi;     // multi-symbol table [1 << kMultiPeekBits], or null
  uint8_t* out;           // [N, T, D]
  int N, W, hdr, probes, ctas;
};

struct SlotParams {
  SlotTensor t[2];  // K, then V; a tensor with N = 0 takes no CTA
  int T, D, Tw;
};

struct SlotSmem {
  int rows, stage, slot_stage, total;
};

__host__ __device__ inline SlotSmem slot_smem(bool multi, int T, int D, int W) {
  SlotSmem s;
  s.rows = multi ? kMultiBytes : 0;
  s.stage = s.rows + (kSlotsPerCta * T * (D + 4) + 15) / 16 * 16;
  s.slot_stage = run_bytes(4 * W);
  s.total = s.stage + kSlotsPerCta * s.slot_stage;
  return s;
}

__global__ void __launch_bounds__(1024) huffman_lut_decode_kernel(SlotParams p) {
  extern __shared__ __align__(16) uint8_t sm[];
  const bool is_v = blockIdx.x >= p.t[0].ctas;
  const SlotTensor a = is_v ? p.t[1] : p.t[0];  // a select: no local copy of the parameters
  const int T = p.T, D = p.D, DP = D + 4;
  const int n0 = (blockIdx.x - (is_v ? p.t[0].ctas : 0)) * kSlotsPerCta;
  const int nslots = min(kSlotsPerCta, a.N - n0);
  const SlotSmem L = slot_smem(a.multi != nullptr, T, D, a.W);
  const uint2* tab = reinterpret_cast<const uint2*>(sm);
  uint8_t* rows = sm + L.rows;

  // The slots first, then the table: the header scan runs while the table
  // is still arriving.
  for (int q = 0; q < nslots; ++q)
    stage_run(sm + L.stage + q * L.slot_stage, a.slots + static_cast<size_t>(n0 + q) * a.W,
              4 * a.W, blockDim.x);
  cp_async_commit();
  if (a.multi) {
    for (int i = threadIdx.x; i < kMultiBytes / 16; i += blockDim.x)
      cp_async16(sm + 16 * i, reinterpret_cast<const uint8_t*>(a.multi) + 16 * i);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  static_assert(kSlotsPerCta == 2, "one comparison finds a thread's slot");
  const int q = threadIdx.x < p.Tw ? 0 : 1, s = threadIdx.x - q * p.Tw;
  const bool live = q < nslots;  // whole warps: Tw is a multiple of 32
  const uint32_t* words = landed<uint32_t>(sm + L.stage + q * L.slot_stage,
                                           a.slots + static_cast<size_t>(n0 + q) * a.W);
  const int pos = live ? huff::stream_start_warp(words, s, T) : 0;
  cp_async_wait<0>();
  __syncthreads();
  if (live && s < T) {
    const int end = pos + huff::stream_bits(words, s);
    uint8_t* row = rows + (q * T + s) * DP;
    if (a.multi) {
      huff::multi_decode_stream(words + a.hdr, a.W - a.hdr, pos, end, tab, D, row);
    } else {
      huff::lut_decode_stream(words + a.hdr, a.W - a.hdr, pos, end, a.lut, a.probes, D,
                              [&](int d, int c) { row[d] = static_cast<uint8_t>(c); });
    }
  }
  __syncthreads();

  // Copy-out, row-major, 16 bytes a store (4 where D is not a multiple of 16);
  // the two slots' rows are consecutive in the output, as in shared memory.
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rows);
  const int vec = D % 16 == 0 ? 4 : 1, per_row = D / (4 * vec);
  const float r_per_row = 1.f / static_cast<float>(per_row);
  uint8_t* out = a.out + static_cast<size_t>(n0) * T * D;
  for (int i = threadIdx.x; i < nslots * T * per_row; i += blockDim.x) {
    const int r = div_small(i, per_row, r_per_row), c = i - r * per_row;
    const uint32_t* src = rw + r * (DP / 4) + c * vec;
    uint8_t* dst = out + r * D + 4 * vec * c;
    if (vec == 4) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(src[0], src[1], src[2], src[3]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = src[0];
    }
  }
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

// The slot LUT decode of K and V in one launch (vN = 0: K alone); a null
// multi table selects the tensor's chunked-LUT probes.
int huffman_lut_decode_launch(const void* kslots, const void* klut, const void* kmulti,
                              void* kout, int kN, int kW, int khdr, int kprobes,
                              const void* vslots, const void* vlut, const void* vmulti,
                              void* vout, int vN, int vW, int vhdr, int vprobes, int T, int D,
                              void* stream) {
  SlotParams p;
  p.t[0] = SlotTensor{static_cast<const uint32_t*>(kslots), static_cast<const int*>(klut),
                      static_cast<const uint2*>(kmulti), static_cast<uint8_t*>(kout), kN, kW,
                      khdr, kprobes, (kN + kSlotsPerCta - 1) / kSlotsPerCta};
  p.t[1] = SlotTensor{static_cast<const uint32_t*>(vslots), static_cast<const int*>(vlut),
                      static_cast<const uint2*>(vmulti), static_cast<uint8_t*>(vout), vN, vW,
                      vhdr, vprobes, (vN + kSlotsPerCta - 1) / kSlotsPerCta};
  p.T = T;
  p.D = D;
  p.Tw = (T + 31) / 32 * 32;
  int smem = 0;
  for (const SlotTensor& a : p.t)
    if (a.N > 0) {
      const int need = slot_smem(a.multi != nullptr, T, D, a.W).total;
      smem = need > smem ? need : smem;
    }
  const int e = set_smem(huffman_lut_decode_kernel, smem);
  if (e != 0) return e;
  huffman_lut_decode_kernel<<<p.t[0].ctas + p.t[1].ctas, kSlotsPerCta * p.Tw, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
