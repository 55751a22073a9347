// Fetch stage: in-place decompression of the compressed KV cache fused with
// flash-decode attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_kv_attn.py:57
// (`_kernel`, launched by `fused_cache_attention_pallas`), dense and paged
// variants, for the raw passthrough tiles, the packed/kivi no-straddle tiles
// and the huffman tiles (see below).
//
// What bounds it on an H100: in float32 on the CUDA cores, operations.  Per
// live block and KV head the kernel reads ~9.5 KB (the packed K and V words at
// 5 and 3 bits a value, and four short bf16 scale vectors) and the function
// needs ~266 kflop: G*T*D multiply-adds twice (scores and the P.V product),
// with the scales folded into the products (q.(mn + st*c) = q.mn + (q*st).c,
// and the same for V).  At G = 8 that is ~28 flop a byte, above the card's
// float32 balance of 67 TFLOP/s over 3.35 TB/s (= 20), so the float32 units
// set the floor; on the tensor cores (bf16 or TF32) the same work would be
// bound by bytes.  This kernel also dequantizes each of the 2*T*D values
// (another ~33 kflop a block): a cost of its design, not of the function,
// paid for a simple tile loop.  The design keeps every decoded value out of
// device memory:
// the words and scales of one block are staged in shared memory, decoded
// there to a float32 [T, D] tile, consumed, and overwritten by the next
// block.
//
// This first version is deliberately simple: one CTA per (row, KV head) walks
// that row's live blocks in order, so only B*Hkv CTAs run (16 at the serving
// shape) and the loads are not overlapped with compute.  Its time is recorded
// against the bound in PERF.md; splitting the block loop and using the tensor
// cores is later work.  Any such split must keep a fixed split count and a
// fixed combine order: a row's output may not depend on which other rows are
// in the batch (batched == solo), which is also why there are no atomics.
//
// Paged variant (a page table is given; null selects the dense variant, whose
// code and numbers are unchanged).  The stores are one shared arena per layer,
// [1, Hkv, P, ...], and block n of row b lives in page page_tab[b, n].  The
// CTA stages its row's NB table entries in shared memory (256 B at NB = 64)
// and addresses block n at (h * P + page).  An entry that is unassigned
// (< 0, as for a preempted or retired row, or past the arena) skips the block
// entirely, so no clamped page ever reaches the softmax (the TPU kernel's
// `pt_ref >= 0` guard, src/repro/kernels/fused_kv_attn.py:113-114).  The
// table adds NB * 4 bytes a row to what the kernel reads, so float32
// operations still bound it, and the simple one-CTA-per-(row, head) design
// stays for now.
//
// Decode: code i = t*D + d of a block sits in word i / cpw at bit
// (i % cpw) * bits, cpw = 32 / bits.  The words do not align with rows of the
// tile (128 % 6 != 0 at 5 bits), so the index is flat.  K dequantizes per
// channel (mn[d] + c*st[d]), V per token (mn[t] + c*st[t]).  Scores and the
// online softmax (m, l, acc) run in float32, then the raw tail buffer is folded
// in, masked by buf_len[b], exactly as the TPU kernel's final grid step does.
//
// Huffman tiles (kind 2; the TPU kernel's huffman tile decode,
// src/repro/core/layouts.py:822-848 `HuffmanLayout._tile_decode`, with the
// LUTs as aux operands, src/repro/kernels/fused_kv_attn.py:85-89, 118-137).
// A slot is a u16 header of T per-stream bit counts and a worst-case-padded
// payload (1313 K / 801 V words at Yi-6B width, smaller than the packed
// slots, so the same words buffer holds it).  The slot is staged in shared
// memory like packed words; thread t < T then sums the header counts before
// its own stream (the exclusive scan, read from the staged header) and
// decodes its stream's D codes with the chunked LUT (huffman.cuh, at most 2
// probes a symbol), writing the same dequantized float32 tile row with the
// same expression as packed tiles.  Equal codes and scales therefore give a
// bit-identical output to the packed tile's, and the score, softmax and
// accumulate code is shared.  What bounds this decode is latency, not the
// card: each stream is a chain of D dependent probes, and only T of the 256
// threads work while the others wait.  The LUTs (41 x 256 and 15 x 256 int32
// at Yi-6B width; up to 401 x 256 for a fitted book, more than shared memory
// holds) are read from device memory through the read-only path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman.cuh"

namespace {

constexpr float kNegInit = -1e30f;  // finite "-inf" (kernels/ref.py NEG_INIT)
constexpr int kThreads = 256;
constexpr int kMaxAcc = 8;  // G*D <= kThreads * kMaxAcc accumulators a CTA
enum TileKind { kRaw = 0, kPacked = 1, kHuffman = 2 };

struct Params {
  const float* q;  // [B, Hkv*G, D]
  // Stores: [Bs, Hkv, P, ...] with Bs = B, P = NB dense; Bs = 1 for an arena.
  const void* k_store;  // packed/huffman: u32 [Bs,Hkv,P,Wk]; raw: bf16 [Bs,Hkv,P,T,D]
  const __nv_bfloat16* k_min;  // [Bs,Hkv,P,D] (packed only)
  const __nv_bfloat16* k_step;
  const void* v_store;
  const __nv_bfloat16* v_min;  // [Bs,Hkv,P,T] (packed only)
  const __nv_bfloat16* v_step;
  const __nv_bfloat16* k_buf;  // [B,Hkv,T,D]
  const __nv_bfloat16* v_buf;
  const int* nb_valid;  // [B], already clamped to NB
  const int* buf_len;   // [B]
  const int* page_tab;  // [B, NB] arena page of each ring slot; null = dense
  const int* lut_k;     // huffman: flat [n_nodes * 256] decode LUTs
  const int* lut_v;
  float* out;           // [B, Hkv*G, D]
  int Hkv, G, D, T, NB, P, Wk, Wv, bits_k, bits_v;  // P: store block extent
  int kind;             // TileKind
  int hdr_k, hdr_v, probes_k, probes_v;  // huffman: header words, LUT probes
  float scale;
};

// One tile's source: bf16 values, or a slot of u32 words with its units.
struct TileSrc {
  int kind;
  const void* data;  // bf16 [T, D] (raw) or u32 [W] words
  const __nv_bfloat16* mn;
  const __nv_bfloat16* st;
  int W, bits, hdr, probes;
  const int* lut;
};

__device__ __forceinline__ float dequant(float mn, uint32_t c, float st) {
  return __fmaf_rn(static_cast<float>(c), st, mn);
}

// Decode one [T, D] tile into shared memory (row stride D + 1, which keeps
// the column reads of the score loop free of bank conflicts).  bf16 tiles
// (raw store or the tail buffer) convert; packed and huffman slots are staged
// in `words` with their unit scales and dequantized (per channel for K, per
// token for V).
__device__ void decode_tile(const TileSrc& src, bool per_channel, int T, int D, float* tile,
                            float* mn, float* st, uint32_t* words) {
  const int tid = threadIdx.x, nt = blockDim.x, DP = D + 1;
  if (src.kind == kRaw) {
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(src.data);
    for (int i = tid; i < T * D; i += nt) {
      const int t = i / D, d = i - t * D;
      tile[t * DP + d] = __bfloat162float(v[i]);
    }
    return;
  }
  const uint32_t* wsrc = static_cast<const uint32_t*>(src.data);
  const int U = per_channel ? D : T;
  for (int i = tid; i < src.W; i += nt) words[i] = wsrc[i];
  for (int u = tid; u < U; u += nt) {
    mn[u] = __bfloat162float(src.mn[u]);
    st[u] = __bfloat162float(src.st[u]);
  }
  __syncthreads();
  if (src.kind == kHuffman) {
    const uint32_t* payload = words + src.hdr;
    for (int t = tid; t < T; t += nt) {
      const int pos = huff::stream_start(words, t);
      float* row = tile + t * DP;
      huff::lut_decode_stream(payload, src.W - src.hdr, pos, pos + huff::stream_bits(words, t),
                              src.lut, src.probes, D, [&](int d, int c) {
                                const int u = per_channel ? d : t;
                                row[d] = dequant(mn[u], static_cast<uint32_t>(c), st[u]);
                              });
    }
    return;
  }
  const int bits = src.bits, cpw = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  for (int i = tid; i < T * D; i += nt) {
    const int t = i / D, d = i - t * D;
    const uint32_t c = (words[i / cpw] >> ((i % cpw) * bits)) & mask;
    const int u = per_channel ? d : t;
    tile[t * DP + d] = dequant(mn[u], c, st[u]);
  }
}

// Scores of the G query rows against the K tile, then the online-softmax
// update of (m, l); leaves the probabilities in `sc` and each row's rescale
// factor in `alpha`.  `valid` masks tokens t >= valid (the tail buffer).
__device__ void scores_softmax(const float* tile, const float* qs, float* sc,
                               float* m_s, float* l_s, float* alpha, int G,
                               int T, int D, float scale, int valid) {
  const int tid = threadIdx.x, nt = blockDim.x, DP = D + 1;
  for (int e = tid; e < G * T; e += nt) {
    const int g = e / T, t = e - g * T;
    const float* kr = tile + t * DP;
    const float* qr = qs + g * D;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
    sc[e] = t < valid ? s * scale : kNegInit;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  for (int g = warp; g < G; g += nw) {
    float mx = kNegInit;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, sc[g * T + t]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = m_s[g];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float p = t < valid ? expf(sc[g * T + t] - m_new) : 0.f;
      sc[g * T + t] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      alpha[g] = a;
      l_s[g] = l_s[g] * a + sum;
      m_s[g] = m_new;
    }
  }
  __syncthreads();
}

// acc[g, d] = acc[g, d] * alpha[g] + sum_t p[g, t] * V[t, d]; each thread owns
// the accumulators e = tid + k * blockDim.x, k < kMaxAcc.
__device__ void accumulate(float (&acc)[kMaxAcc], const float* tile, const float* sc,
                           const float* alpha, int G, int T, int D) {
  const int DP = D + 1;
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < G * D) {
      const int g = e / D, d = e - g * D;
      const float* pr = sc + g * T;
      float a = acc[k] * alpha[g];
      for (int t = 0; t < T; ++t) a += pr[t] * tile[t * DP + d];
      acc[k] = a;
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_kv_attn_kernel(Params p) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = p.G, D = p.D, T = p.T, U = D > T ? D : T;
  float* tile = smem;             // T * (D + 1)
  float* qs = tile + T * (D + 1);  // G * D
  float* sc = qs + G * D;         // G * T
  float* mn = sc + G * T;         // U
  float* st = mn + U;             // U
  float* m_s = st + U;            // G
  float* l_s = m_s + G;           // G
  float* alpha = l_s + G;         // G
  uint32_t* words = reinterpret_cast<uint32_t*>(alpha + G);  // max(Wk, Wv)
  const int Wmax = p.kind == kRaw ? 0 : (p.Wk > p.Wv ? p.Wk : p.Wv);
  int* pt_s = reinterpret_cast<int*>(words + Wmax);  // NB

  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;
  const float* qrow = p.q + bh * G * D;  // rows h*G .. h*G+G-1 of q[b]
  for (int i = tid; i < G * D; i += blockDim.x) qs[i] = qrow[i];
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInit;
    l_s[g] = 0.f;
  }
  if (p.page_tab != nullptr) {
    for (int i = tid; i < p.NB; i += blockDim.x) pt_s[i] = p.page_tab[b * p.NB + i];
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int nbv = p.nb_valid[b];
  for (int n = 0; n < nbv; ++n) {
    size_t blk = bh * p.NB + n;
    if (p.page_tab != nullptr) {
      const int page = pt_s[n];  // the same value in every thread of the CTA
      if (page < 0 || page >= p.P) continue;
      blk = static_cast<size_t>(h) * p.P + page;
    }
    const bool raw = p.kind == kRaw;
    const TileSrc ks = {
        p.kind,
        raw ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(p.k_store) + blk * T * D)
            : static_cast<const void*>(static_cast<const uint32_t*>(p.k_store) + blk * p.Wk),
        raw ? nullptr : p.k_min + blk * D, raw ? nullptr : p.k_step + blk * D,
        p.Wk, p.bits_k, p.hdr_k, p.probes_k, p.lut_k};
    decode_tile(ks, true, T, D, tile, mn, st, words);
    __syncthreads();
    scores_softmax(tile, qs, sc, m_s, l_s, alpha, G, T, D, p.scale, T);
    const TileSrc vs = {
        p.kind,
        raw ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(p.v_store) + blk * T * D)
            : static_cast<const void*>(static_cast<const uint32_t*>(p.v_store) + blk * p.Wv),
        raw ? nullptr : p.v_min + blk * T, raw ? nullptr : p.v_step + blk * T,
        p.Wv, p.bits_v, p.hdr_v, p.probes_v, p.lut_v};
    decode_tile(vs, false, T, D, tile, mn, st, words);
    __syncthreads();
    accumulate(acc, tile, sc, alpha, G, T, D);
    __syncthreads();
  }

  // The raw tail buffer (the exact residual window), masked by buf_len[b].
  const int bl = p.buf_len[b];
  const TileSrc kb = {kRaw, p.k_buf + bh * T * D, nullptr, nullptr, 0, 0, 0, 0, nullptr};
  decode_tile(kb, true, T, D, tile, mn, st, words);
  __syncthreads();
  scores_softmax(tile, qs, sc, m_s, l_s, alpha, G, T, D, p.scale, bl);
  const TileSrc vb = {kRaw, p.v_buf + bh * T * D, nullptr, nullptr, 0, 0, 0, 0, nullptr};
  decode_tile(vb, false, T, D, tile, mn, st, words);
  __syncthreads();
  accumulate(acc, tile, sc, alpha, G, T, D);

  float* orow = p.out + bh * G * D;
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int e = tid + k * blockDim.x;
    if (e < G * D) orow[e] = acc[k] / fmaxf(l_s[e / D], 1e-30f);
  }
}

}  // namespace

extern "C" {

int fused_kv_attn_max_acc() { return kThreads * kMaxAcc; }

const char* fused_kv_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream` and returns cudaGetLastError().  kind: 0 raw,
// 1 packed (no-straddle words), 2 huffman (lut_k / lut_v, hdr_*, probes_*).
int fused_kv_attn_launch(const void* q, const void* k_store, const void* k_min,
                         const void* k_step, const void* v_store, const void* v_min,
                         const void* v_step, const void* k_buf, const void* v_buf,
                         const void* nb_valid, const void* buf_len, const void* page_tab,
                         const void* lut_k, const void* lut_v, void* out, int B, int Hkv,
                         int G, int D, int T, int NB, int P, int Wk, int Wv, int bits_k,
                         int bits_v, int kind, int hdr_k, int hdr_v, int probes_k,
                         int probes_v, float scale, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k_store = k_store;
  p.k_min = static_cast<const __nv_bfloat16*>(k_min);
  p.k_step = static_cast<const __nv_bfloat16*>(k_step);
  p.v_store = v_store;
  p.v_min = static_cast<const __nv_bfloat16*>(v_min);
  p.v_step = static_cast<const __nv_bfloat16*>(v_step);
  p.k_buf = static_cast<const __nv_bfloat16*>(k_buf);
  p.v_buf = static_cast<const __nv_bfloat16*>(v_buf);
  p.nb_valid = static_cast<const int*>(nb_valid);
  p.buf_len = static_cast<const int*>(buf_len);
  p.page_tab = static_cast<const int*>(page_tab);
  p.lut_k = static_cast<const int*>(lut_k);
  p.lut_v = static_cast<const int*>(lut_v);
  p.out = static_cast<float*>(out);
  p.Hkv = Hkv; p.G = G; p.D = D; p.T = T; p.NB = NB; p.P = P; p.Wk = Wk; p.Wv = Wv;
  p.bits_k = bits_k; p.bits_v = bits_v; p.kind = kind; p.scale = scale;
  p.hdr_k = hdr_k; p.hdr_v = hdr_v; p.probes_k = probes_k; p.probes_v = probes_v;
  const bool raw = kind == kRaw;
  const int U = D > T ? D : T;
  const int Wmax = Wk > Wv ? Wk : Wv;
  const size_t smem = sizeof(float) * (static_cast<size_t>(T) * (D + 1) + G * D + G * T
                                       + 2 * U + 3 * G)
                      + sizeof(uint32_t) * static_cast<size_t>(raw ? 0 : Wmax)  // slot words
                      + sizeof(int) * static_cast<size_t>(page_tab != nullptr ? NB : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_kv_attn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_kv_attn_kernel<<<dim3(Hkv, B), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
