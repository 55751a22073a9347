// Store stage: error-bounded quantization + no-straddle bit-packing of whole
// compression blocks, written straight into their cache ring slots, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pack_encode.py:46
// (`_kernel`, launched by `quant_pack_pallas`), extended to what the JAX
// server actually stores (`PackedLayout.compress_blocks`,
// src/repro/core/layouts.py:538-546): the packed words, plus the unit minima
// and steps rounded to bf16, with the kivi step (max-min)/(2^b-1) as an
// option.  The codes use the float32 step, as `quant_block_minmax` does.
// The kivi step is (max-min) times the float32 reciprocal of 2^b-1: XLA
// folds the reference's division by that constant into this multiplication
// in every compiled path, including its server's.
//
// What bounds it on an H100: bytes.  A [T, D] bf16 block is read once and
// about a third as many bytes are written; the arithmetic (one division and
// a rounding per value) is small beside that.  The design reads each block
// once into shared memory, reduces the unit min/max there, and writes only
// the packed words and scales back.
//
// One CTA per (row, KV head, block) and tensor (blockIdx.y: 0 = K, 1 = V).
// The store is a per-row ring ([B, H, NB, ...]) or, in paged mode, the shared
// arena of one layer ([1, H, P, ...]): with a store batch extent of 1 every
// row writes to [0, h, slot], the slot being an arena page that the caller
// translated through the row's page table.  Rows whose slot is the drop
// sentinel (slot >= the store's block extent, NB or P: "this row does not
// flush now", or an unassigned page) return at once and write nothing.  The decode path therefore launches
// the kernel on every step without asking the host whether any row flushes:
// the JAX reference skips the encode with a device-side lax.cond, and a
// host-side test here would stall every layer of every step.
//
// Numerics match the reference bit for bit: IEEE division and multiplication
// (no fast math, and the explicit _rn intrinsics keep the compiler from
// contracting them), rintf for round-half-to-even as jnp.round, clip to
// [0, 2^b - 1], and round-to-nearest-even for the bf16 scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Tensor {
  const void* x;          // [B, H, n, T, D] raw blocks, bf16 or f32
  uint32_t* words;        // [Bs, H, NB, W], Bs = store_batch
  __nv_bfloat16* mn;      // [Bs, H, NB, U]
  __nv_bfloat16* st;      // [Bs, H, NB, U]
  int bits;
  float rel_scale;
  int kivi;               // step = (max-min)/(2^b-1) instead of rel_scale*(max-min)
  int token_wise;         // V: units are tokens (U = T); K: channels (U = D)
};

struct Params {
  Tensor t[2];
  const int* slots;       // [B, n]; slot >= NB (or < 0) drops the write
  int B, H, n, T, D, NB, x_bf16;  // NB: the store's block extent (ring or arena)
  int store_batch;        // B (one ring a row) or 1 (the shared arena)
};

__global__ void __launch_bounds__(kThreads) pack_encode_kernel(Params p) {
  const Tensor& td = p.t[blockIdx.y];
  const int blk = blockIdx.x;  // (b, h, j) flattened, j fastest
  const int j = blk % p.n;
  const int h = (blk / p.n) % p.H;
  const int b = blk / (p.n * p.H);
  const int slot = p.slots[b * p.n + j];
  if (slot < 0 || slot >= p.NB) return;

  extern __shared__ float smem[];
  const int T = p.T, D = p.D, TD = T * D;
  const int U = td.token_wise ? T : D;
  float* xs = smem;     // T * D
  float* mn = xs + TD;  // U
  float* sf = mn + U;   // U: the step, or 1 where the step is 0
  const int tid = threadIdx.x, nt = blockDim.x;

  const size_t xoff = static_cast<size_t>(blk) * TD;
  if (p.x_bf16) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(td.x) + xoff;
    for (int i = tid; i < TD; i += nt) xs[i] = __bfloat162float(x[i]);
  } else {
    const float* x = static_cast<const float*>(td.x) + xoff;
    for (int i = tid; i < TD; i += nt) xs[i] = x[i];
  }
  __syncthreads();

  const int sb = p.store_batch == 1 ? 0 : b;
  const size_t dst = (static_cast<size_t>(sb) * p.H + h) * p.NB + slot;
  for (int u = tid; u < U; u += nt) {
    float lo = CUDART_INF_F, hi = -CUDART_INF_F;
    if (td.token_wise) {
      for (int d = 0; d < D; ++d) {
        lo = fminf(lo, xs[u * D + d]);
        hi = fmaxf(hi, xs[u * D + d]);
      }
    } else {
      for (int t = 0; t < T; ++t) {
        lo = fminf(lo, xs[t * D + u]);
        hi = fmaxf(hi, xs[t * D + u]);
      }
    }
    const float range = __fsub_rn(hi, lo);
    const float step = td.kivi
        ? __fmul_rn(range, __fdiv_rn(1.f, static_cast<float>((1 << td.bits) - 1)))
        : __fmul_rn(td.rel_scale, range);
    mn[u] = lo;
    sf[u] = step > 0.f ? step : 1.f;
    td.mn[dst * U + u] = __float2bfloat16_rn(lo);
    td.st[dst * U + u] = __float2bfloat16_rn(step);
  }
  __syncthreads();

  const int bits = td.bits, cpw = 32 / bits;
  const int W = (TD + cpw - 1) / cpw;
  const float maxc = static_cast<float>((1 << bits) - 1);
  uint32_t* out = td.words + dst * W;
  for (int w = tid; w < W; w += nt) {
    uint32_t word = 0;
    for (int k = 0; k < cpw; ++k) {
      const int i = w * cpw + k;
      if (i >= TD) break;
      const int t = i / D, d = i - t * D;
      const int u = td.token_wise ? t : d;
      float c = rintf(__fdiv_rn(__fsub_rn(xs[i], mn[u]), sf[u]));
      c = fminf(fmaxf(c, 0.f), maxc);
      word |= static_cast<uint32_t>(c) << (k * bits);
    }
    out[w] = word;
  }
}

}  // namespace

extern "C" {

const char* pack_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch encodes K (and V when n_tensors == 2).  Returns cudaGetLastError().
int pack_encode_launch(const void* kx, void* kwords, void* kmn, void* kst,
                       int kbits, float krel, int kkivi, int ktoken,
                       const void* vx, void* vwords, void* vmn, void* vst,
                       int vbits, float vrel, int vkivi, int vtoken,
                       const void* slots, int n_tensors, int x_bf16,
                       int B, int H, int n, int T, int D, int NB, int store_batch,
                       void* stream) {
  Params p;
  p.t[0] = Tensor{kx, static_cast<uint32_t*>(kwords), static_cast<__nv_bfloat16*>(kmn),
                  static_cast<__nv_bfloat16*>(kst), kbits, krel, kkivi, ktoken};
  p.t[1] = Tensor{vx, static_cast<uint32_t*>(vwords), static_cast<__nv_bfloat16*>(vmn),
                  static_cast<__nv_bfloat16*>(vst), vbits, vrel, vkivi, vtoken};
  p.slots = static_cast<const int*>(slots);
  p.B = B; p.H = H; p.n = n; p.T = T; p.D = D; p.NB = NB; p.x_bf16 = x_bf16;
  p.store_batch = store_batch;
  const int U = D > T ? D : T;
  const size_t smem = sizeof(float) * (static_cast<size_t>(T) * D + 2 * U);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pack_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pack_encode_kernel<<<dim3(B * H * n, n_tensors), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
