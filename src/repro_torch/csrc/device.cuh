// Device helpers shared by the Fetch (fused_kv_attn.cu), the slot decode
// (huffman_decode.cu) and the Store (pack_encode.cu): 16-byte cp.async copies
// from device memory into shared memory (through L2 only, .cg; 16-byte
// aligned source and destination), and a division without the integer
// divide's long instruction sequence.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the 16-byte granules that cover [src, src + nbytes) to dst, the CTA's
// `threads` threads taking every threads-th granule, so that byte src lands at
// dst + (src % 16) (see `landed`).  dst needs run_bytes(nbytes) bytes.  A
// kernel with a fixed block size passes it as a constant, so the loop keeps
// a constant stride.
__device__ __forceinline__ void stage_run(uint8_t* dst, const void* src, int nbytes,
                                          int threads) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~uintptr_t(15);
  const int chunks = static_cast<int>((((a + nbytes + 15) & ~uintptr_t(15)) - lo) >> 4);
  for (int i = threadIdx.x; i < chunks; i += threads)
    cp_async16(dst + 16 * i, reinterpret_cast<const void*>(lo + 16 * i));
}
template <typename E>
__device__ __forceinline__ const E* landed(const uint8_t* dst, const void* src) {
  return reinterpret_cast<const E*>(dst + (reinterpret_cast<uintptr_t>(src) & 15));
}

// The shared-memory bytes stage_run may fill for a run of nbytes that starts
// at any 4-byte offset: the granules of the run, plus one.
__host__ __device__ constexpr int run_bytes(int nbytes) { return 16 * ((nbytes + 15) / 16 + 1); }

// x / d for 0 <= x < 2^22 and d >= 1, from rd = 1/d rounded to float: the
// float quotient is off by at most one, which the two tests put right.
__device__ __forceinline__ int div_small(int x, int d, float rd) {
  int q = __float2int_rz(__int2float_rn(x) * rd);
  q -= q * d > x;
  q += (q + 1) * d <= x;
  return q;
}
