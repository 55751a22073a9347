// Fetch stage: in-place decompression of the compressed KV cache fused with
// flash-decode attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_kv_attn.py:57
// (`_kernel`, launched by `fused_cache_attention_pallas`), dense variant, for
// the raw passthrough tiles and the packed/kivi no-straddle tiles.
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
// Decode: code i = t*D + d of a block sits in word i / cpw at bit
// (i % cpw) * bits, cpw = 32 / bits.  The words do not align with rows of the
// tile (128 % 6 != 0 at 5 bits), so the index is flat.  K dequantizes per
// channel (mn[d] + c*st[d]), V per token (mn[t] + c*st[t]).  Scores and the
// online softmax (m, l, acc) run in float32, then the raw tail buffer is folded
// in, masked by buf_len[b], exactly as the TPU kernel's final grid step does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInit = -1e30f;  // finite "-inf" (kernels/ref.py NEG_INIT)
constexpr int kThreads = 256;
constexpr int kMaxAcc = 8;  // G*D <= kThreads * kMaxAcc accumulators a CTA

struct Params {
  const float* q;  // [B, Hkv*G, D]
  const void* k_store;  // packed: u32 [B,Hkv,NB,Wk]; raw: bf16 [B,Hkv,NB,T,D]
  const __nv_bfloat16* k_min;  // [B,Hkv,NB,D] (packed only)
  const __nv_bfloat16* k_step;
  const void* v_store;
  const __nv_bfloat16* v_min;  // [B,Hkv,NB,T] (packed only)
  const __nv_bfloat16* v_step;
  const __nv_bfloat16* k_buf;  // [B,Hkv,T,D]
  const __nv_bfloat16* v_buf;
  const int* nb_valid;  // [B], already clamped to NB
  const int* buf_len;   // [B]
  float* out;           // [B, Hkv*G, D]
  int Hkv, G, D, T, NB, Wk, Wv, bits_k, bits_v, raw;
  float scale;
};

// Decode one [T, D] tile into shared memory (row stride D + 1, which keeps
// the column reads of the score loop free of bank conflicts).  `bf16_src`
// non-null means a bf16 tile (raw store or the tail buffer); otherwise the
// packed words are staged in `words` and dequantized with the unit scales.
__device__ void decode_tile(const __nv_bfloat16* bf16_src, const uint32_t* wsrc,
                            const __nv_bfloat16* mnp, const __nv_bfloat16* stp,
                            int W, int bits, bool per_channel, int T, int D,
                            float* tile, float* mn, float* st, uint32_t* words) {
  const int tid = threadIdx.x, nt = blockDim.x, DP = D + 1;
  if (bf16_src != nullptr) {
    for (int i = tid; i < T * D; i += nt) {
      const int t = i / D, d = i - t * D;
      tile[t * DP + d] = __bfloat162float(bf16_src[i]);
    }
    return;
  }
  const int U = per_channel ? D : T;
  for (int i = tid; i < W; i += nt) words[i] = wsrc[i];
  for (int u = tid; u < U; u += nt) {
    mn[u] = __bfloat162float(mnp[u]);
    st[u] = __bfloat162float(stp[u]);
  }
  __syncthreads();
  const int cpw = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  for (int i = tid; i < T * D; i += nt) {
    const int t = i / D, d = i - t * D;
    const uint32_t c = (words[i / cpw] >> ((i % cpw) * bits)) & mask;
    const int u = per_channel ? d : t;
    tile[t * DP + d] = mn[u] + static_cast<float>(c) * st[u];
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

  const int tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;
  const float* qrow = p.q + bh * G * D;  // rows h*G .. h*G+G-1 of q[b]
  for (int i = tid; i < G * D; i += blockDim.x) qs[i] = qrow[i];
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInit;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int nbv = p.nb_valid[b];
  for (int n = 0; n < nbv; ++n) {
    const size_t blk = bh * p.NB + n;
    if (p.raw) {
      decode_tile(static_cast<const __nv_bfloat16*>(p.k_store) + blk * T * D,
                  nullptr, nullptr, nullptr, 0, 0, true, T, D, tile, mn, st, words);
    } else {
      decode_tile(nullptr, static_cast<const uint32_t*>(p.k_store) + blk * p.Wk,
                  p.k_min + blk * D, p.k_step + blk * D, p.Wk, p.bits_k, true,
                  T, D, tile, mn, st, words);
    }
    __syncthreads();
    scores_softmax(tile, qs, sc, m_s, l_s, alpha, G, T, D, p.scale, T);
    if (p.raw) {
      decode_tile(static_cast<const __nv_bfloat16*>(p.v_store) + blk * T * D,
                  nullptr, nullptr, nullptr, 0, 0, false, T, D, tile, mn, st, words);
    } else {
      decode_tile(nullptr, static_cast<const uint32_t*>(p.v_store) + blk * p.Wv,
                  p.v_min + blk * T, p.v_step + blk * T, p.Wv, p.bits_v, false,
                  T, D, tile, mn, st, words);
    }
    __syncthreads();
    accumulate(acc, tile, sc, alpha, G, T, D);
    __syncthreads();
  }

  // The raw tail buffer (the exact residual window), masked by buf_len[b].
  const int bl = p.buf_len[b];
  decode_tile(p.k_buf + bh * T * D, nullptr, nullptr, nullptr, 0, 0, true, T, D,
              tile, mn, st, words);
  __syncthreads();
  scores_softmax(tile, qs, sc, m_s, l_s, alpha, G, T, D, p.scale, bl);
  decode_tile(p.v_buf + bh * T * D, nullptr, nullptr, nullptr, 0, 0, false, T, D,
              tile, mn, st, words);
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

// Launches the kernel on `stream` and returns cudaGetLastError().
int fused_kv_attn_launch(const void* q, const void* k_store, const void* k_min,
                         const void* k_step, const void* v_store, const void* v_min,
                         const void* v_step, const void* k_buf, const void* v_buf,
                         const void* nb_valid, const void* buf_len, void* out,
                         int B, int Hkv, int G, int D, int T, int NB, int Wk, int Wv,
                         int bits_k, int bits_v, int raw, float scale, void* stream) {
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
  p.out = static_cast<float*>(out);
  p.Hkv = Hkv; p.G = G; p.D = D; p.T = T; p.NB = NB; p.Wk = Wk; p.Wv = Wv;
  p.bits_k = bits_k; p.bits_v = bits_v; p.raw = raw; p.scale = scale;
  const int U = D > T ? D : T;
  const int Wmax = Wk > Wv ? Wk : Wv;
  const size_t smem = sizeof(float) * (static_cast<size_t>(T) * (D + 1) + G * D + G * T
                                       + 2 * U + 3 * G)
                      + sizeof(uint32_t) * static_cast<size_t>(raw ? 0 : Wmax);
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
