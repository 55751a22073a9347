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
// What bounds it on an H100.  By the card's rates, bytes: a [T, D] bf16
// block is read once and about a third as many bytes are written, and the
// arithmetic (a division and a rounding a value) is small beside that; a
// flush step of 4 rows moves 0.7 MB, 0.2 us.  In fact a launch holds a few
// dozen blocks (32 at 4 rows, 8 for a chunk), so the time is a CTA's chain
// of dependent steps and the launch.  An instrumented copy of the earlier
// kernel (one CTA a block, 256 threads, 2-byte loads widened to float32 in
// shared memory, a thread a unit for the min/max, a division and a
// remainder a code) showed the load, the pack and (for V, whose per-token
// loop hit one bank from every lane) the min/max each taking thousands of
// cycles; one of the new kernel showed that the floating-point arithmetic
// did not set the pack's time (taking out the division and the rounding
// changed nothing).  The design:
// - Split: kSplit CTAs a block.  Each loads and reduces the whole block
//   (the copies after the first come from L2) and packs a quarter of the
//   words, so a launch of a few dozen blocks spreads over more SMs.
// - Load: the block in 16-byte cp.async copies, all in flight at once, kept
//   in its own type (bf16 or f32) in shared memory.
// - Unit min/max: 16-byte vectors, each read once by one thread with one
//   load (consecutive threads, consecutive vectors: no bank conflicts), fold
//   into partials (V: a pair a vector; K: a pair a channel and one of
//   kSlicesK token slices), then a thread a unit folds its partials.  Min
//   and max are exact in any order, so the result is the same bits.
// - Pack: a thread takes whole words (coalesced stores) and walks the (token,
//   channel) index of its codes by increments.  Each code is
//   rintf(__fdiv_rn(x - mn, step)) clipped to [0, 2^b - 1]: the reference
//   divides by a runtime step, so no reciprocal replaces the division.
// - No integer division on the device: the host passes codes a word, words a
//   block and the index steps; the grid's own dimensions give (row, head,
//   block, tensor, split) with shifts; the rest is `div_small`.
//
// The CTAs of a (row, KV head, block) and tensor (0 = K, 1 = V) share blockIdx.x.
// The store is a per-row ring ([B, H, NB, ...]) or, in paged mode, the shared
// arena of one layer ([1, H, P, ...]): with a store batch extent of 1 every
// row writes to [0, h, slot], the slot being an arena page that the caller
// translated through the row's page table.  Rows whose slot is the drop
// sentinel (slot >= the store's block extent, NB or P: "this row does not
// flush now", or an unassigned page) return before any load and write
// nothing.  The decode path therefore launches the kernel on every step
// without asking the host whether any row flushes: the JAX reference skips
// the encode with a device-side lax.cond, and a host-side test here would
// stall every layer of every step.
//
// Numerics match the reference bit for bit: IEEE division and multiplication
// (no fast math, and the explicit _rn intrinsics keep the compiler from
// contracting them), rintf for round-half-to-even as jnp.round, clip to
// [0, 2^b - 1], and round-to-nearest-even for the bf16 scales.
//
// Limits (the wrapper checks them): D a multiple of 8, at most 1024 bytes a
// token row, the blocks 16-byte aligned, code widths of 1 to 8 bits.
// `-Xptxas -v` for sm_90a: 32 and 40 registers (the two input types), no
// stack, no spills; 25,600 B of shared memory a CTA at Yi-6B width (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSplit = 4;       // CTAs a block
constexpr int kSlicesK = 8;     // token slices of the K min/max

struct Tensor {
  const void* x;          // [B, H, n, T, D] raw blocks, bf16 or f32
  uint32_t* words;        // [Bs, H, NB, W], Bs = store_batch
  __nv_bfloat16* mn;      // [Bs, H, NB, U]
  __nv_bfloat16* st;      // [Bs, H, NB, U]
  int bits, cpw, W;       // code width, codes a word, words a block
  int adv_t, adv_d;       // kThreads * cpw codes as (tokens, channels)
  float rel_scale;
  int kivi;               // step = (max-min)/(2^b-1) instead of rel_scale*(max-min)
  int token_wise;         // V: units are tokens (U = T); K: channels (U = D)
};

// Every integer the kernel would otherwise divide for comes from the host.
struct Params {
  Tensor t[2];
  const int* slots;       // [B, n]; slot >= NB (or < 0) drops the write
  int n, T, D, NB;        // NB: the store's block extent (ring or arena)
  int store_batch;        // B (one ring a row) or 1 (the shared arena)
  int n_tensors;
  int RV;                 // 16-byte vectors a token row
  float rD, rRV;          // 1 / D, 1 / RV
};

// Part z of n items split kSplit ways: [n * z / kSplit, n * (z + 1) / kSplit).
__device__ __forceinline__ int split_at(int n, int z) { return n * z / kSplit; }

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One 16-byte vector of shared memory (a single 16-byte load), widened.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float: the bits in the high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Shared memory: the block as loaded, the unit minima and safe steps, then
// the partial minima and maxima (V: one pair a 16-byte vector; K: one a
// (slice, channel)).
__host__ __device__ inline int part_floats(int T, int D, int elem) {
  const int v = T * D * elem / 16, k = kSlicesK * D;
  return v > k ? v : k;
}
__host__ __device__ inline int smem_bytes(int T, int D, int elem) {
  const int U = D > T ? D : T;
  return (T * D * elem + 15) / 16 * 16 + 4 * (2 * U + 2 * part_floats(T, D, elem));
}

template <typename X>
__global__ void __launch_bounds__(kThreads) pack_encode_kernel(Params p) {
  // Grid (n * 2 * kSplit, H, B): x = (j, tensor, z), z fastest.
  const int j = blockIdx.x / (2 * kSplit), tensor = (blockIdx.x / kSplit) & 1;
  const int z = blockIdx.x % kSplit, h = blockIdx.y, b = blockIdx.z;
  if (tensor >= p.n_tensors) return;
  const int slot = p.slots[b * p.n + j];
  if (slot < 0 || slot >= p.NB) return;
  const Tensor& td = p.t[tensor];

  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kVec = 16 / sizeof(X);  // values a 16-byte vector
  const int T = p.T, D = p.D, TD = T * D, RV = p.RV;
  const int U = td.token_wise ? T : D;
  X* xs = reinterpret_cast<X*>(smem);
  float* mn = reinterpret_cast<float*>(smem + (TD * sizeof(X) + 15) / 16 * 16);  // U
  float* sf = mn + U;  // U: the step, or 1 where the step is 0
  float* plo = sf + U;
  float* phi = plo + part_floats(T, D, sizeof(X));
  const int tid = threadIdx.x;

  const size_t blk = (static_cast<size_t>(b) * gridDim.y + h) * p.n + j;
  const X* x = static_cast<const X*>(td.x) + blk * TD;
  for (int i = tid; i < TD / kVec; i += kThreads) cp_async16(xs + i * kVec, x + i * kVec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Unit min/max: partials of 16-byte vectors, then a pass over them.
  if (td.token_wise) {  // V: a pair a vector; a token's RV vectors are contiguous
    for (int v = tid; v < T * RV; v += kThreads) {
      float e[kVec];
      load_vec(xs + v * kVec, e);
      float lo = e[0], hi = e[0];
#pragma unroll
      for (int k = 1; k < kVec; ++k) {
        lo = fminf(lo, e[k]);
        hi = fmaxf(hi, e[k]);
      }
      plo[v] = lo;
      phi[v] = hi;
    }
  } else {  // K: thread (slice, c) takes vector c of tokens slice, slice + 8, ...
    const int sl = div_small(tid, RV, p.rRV), c = tid - sl * RV;
    if (sl < kSlicesK) {
      float lo[kVec], hi[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        lo[k] = CUDART_INF_F;
        hi[k] = -CUDART_INF_F;
      }
      for (int t = sl; t < T; t += kSlicesK) {
        float e[kVec];
        load_vec(xs + (t * RV + c) * kVec, e);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          lo[k] = fminf(lo[k], e[k]);
          hi[k] = fmaxf(hi[k], e[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        plo[sl * D + c * kVec + k] = lo[k];
        phi[sl * D + c * kVec + k] = hi[k];
      }
    }
  }
  __syncthreads();

  // Every CTA of the block reduces every unit; CTA z writes the scales of
  // units [u_lo, u_hi) and packs words [w_lo, w_hi).
  const int sb = p.store_batch == 1 ? 0 : b;
  const size_t dst = (static_cast<size_t>(sb) * gridDim.y + h) * p.NB + slot;
  const int u_lo = split_at(U, z), u_hi = split_at(U, z + 1);
  for (int u = tid; u < U; u += kThreads) {
    const int n_part = td.token_wise ? RV : kSlicesK;
    const int at = td.token_wise ? u * RV : u, stride = td.token_wise ? 1 : D;
    float lo = plo[at], hi = phi[at];
    for (int i = 1; i < n_part; ++i) {
      lo = fminf(lo, plo[at + i * stride]);
      hi = fmaxf(hi, phi[at + i * stride]);
    }
    const float range = __fsub_rn(hi, lo);
    const float step = td.kivi
        ? __fmul_rn(range, __fdiv_rn(1.f, static_cast<float>((1 << td.bits) - 1)))
        : __fmul_rn(td.rel_scale, range);
    mn[u] = lo;
    sf[u] = step > 0.f ? step : 1.f;
    if (u >= u_lo && u < u_hi) {
      td.mn[dst * U + u] = __float2bfloat16_rn(lo);
      td.st[dst * U + u] = __float2bfloat16_rn(step);
    }
  }
  __syncthreads();

  // Pack: thread tid takes words w_lo + tid, + kThreads, ...; (t, d) is the
  // index of the word's first code, advanced by (adv_t, adv_d) a word.
  const int bits = td.bits, cpw = td.cpw, W = td.W;
  const int w_lo = split_at(W, z), w_hi = split_at(W, z + 1);
  const float maxc = static_cast<float>((1 << bits) - 1);
  uint32_t* out = td.words + dst * W;
  const int i0 = (w_lo + tid) * cpw;
  int t = div_small(i0, D, p.rD), d = i0 - t * D;
  for (int w = w_lo + tid; w < w_hi; w += kThreads) {
    uint32_t word = 0;
    int ct = t, cd = d;
    const int k_end = min(cpw, TD - w * cpw);
    for (int k = 0; k < k_end; ++k) {
      const int u = td.token_wise ? ct : cd;
      float c = rintf(__fdiv_rn(__fsub_rn(as_float(xs[ct * D + cd]), mn[u]), sf[u]));
      c = fminf(fmaxf(c, 0.f), maxc);
      word |= static_cast<uint32_t>(c) << (k * bits);
      if (++cd == D) {
        cd = 0;
        ++ct;
      }
    }
    out[w] = word;
    t += td.adv_t;
    d += td.adv_d;
    if (d >= D) {
      d -= D;
      ++t;
    }
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
  auto tensor = [&](const void* x, void* words, void* mn, void* st, int bits, float rel,
                    int kivi, int token) {
    const int cpw = 32 / bits, adv = kThreads * cpw;
    return Tensor{x, static_cast<uint32_t*>(words), static_cast<__nv_bfloat16*>(mn),
                  static_cast<__nv_bfloat16*>(st), bits, cpw, (T * D + cpw - 1) / cpw,
                  adv / D, adv % D, rel, kivi, token};
  };
  Params p;
  p.t[0] = tensor(kx, kwords, kmn, kst, kbits, krel, kkivi, ktoken);
  p.t[1] = n_tensors == 2 ? tensor(vx, vwords, vmn, vst, vbits, vrel, vkivi, vtoken) : p.t[0];
  const int elem = x_bf16 ? 2 : 4;
  p.slots = static_cast<const int*>(slots);
  p.n = n; p.T = T; p.D = D; p.NB = NB;
  p.store_batch = store_batch;
  p.n_tensors = n_tensors;
  p.RV = D * elem / 16;
  p.rD = 1.f / static_cast<float>(D);
  p.rRV = 1.f / static_cast<float>(p.RV);
  const dim3 grid(n * 2 * kSplit, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(T, D, elem);
  cudaError_t e = cudaSuccess;
  if (x_bf16) {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(pack_encode_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) pack_encode_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(p);
  } else {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(pack_encode_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) pack_encode_kernel<float><<<grid, kThreads, smem, s>>>(p);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
