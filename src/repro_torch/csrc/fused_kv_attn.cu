// Fetch stage: in-place decompression of the compressed KV cache fused with
// flash-decode attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_kv_attn.py:57
// (`_kernel`, launched by `fused_cache_attention_pallas`), dense and paged,
// for the raw passthrough tiles, the packed/kivi no-straddle tiles and the
// huffman tiles (the tile decode of src/repro/core/layouts.py:822-848, with
// the LUTs as aux operands).
//
// What bounds it on an H100.  Per live block and KV head the function reads
// ~9.5 KB (the packed K and V words at 5 and 3 bits a value and four short
// bf16 scale vectors) and needs ~266 kflop: G*T*D multiply-adds twice (the
// scores and the P.V product), with the scales folded into the products:
//   K: s[g,t] = scale * (sum_d (q[g,d]*st[d]) * c[t,d] + sum_d q[g,d]*mn[d])
//   V: sum_t p[g,t]*v[t,d] = sum_t (p[g,t]*st[t]) * c[t,d] + sum_t p[g,t]*mn[t]
// On the float32 CUDA cores that is ~28 flop a byte, above the card's
// balance of 67 TFLOP/s over 3.35 TB/s (= 20), the yardstick the earlier
// simple kernel was held to.  This kernel runs both products on the tensor
// cores, where even at twice the work (below) the products are far below
// the bytes: it is bound by bytes.
//
// Products.  The operand that comes from the cache is exact in TF32: codes
// are integers below 2^8 and raw or buffered values are bf16 (8-bit
// mantissa, TF32 keeps 10).  Only the float32 side (q*st, p*st, or q and p
// for raw tiles) is split, hi = tf32(x), lo = tf32(x - hi), and each product
// is two `mma.sync.aligned.m16n8k8` TF32 products (hi and lo against the
// exact operand) accumulated in float32, so the error stays near float32's
// (plain TF32 would sit at the 1e-4 tolerance).  The query group G <= 8 is
// the n-tile (padded with zero rows):
//   scores^T[T, G] = K[T, D] * (q*st)^T     (m = T, k = D)
//   out^T[D, G]    = V^T[D, T] * (p*st)^T   (m = D, k = T)
// m is padded to 16 and masked (T = 8, D = 24).  A product's work is cut
// into units of (m-tile, fixed share of its k-steps): with at most 8
// m-tiles each of the 8 warps takes one unit (8 / m-tiles warps an m-tile);
// with more (D 160: 10 m-tiles of the P.V product) a unit is a whole m-tile
// and warp w takes units w and w + 8.  The partial sums are added in a
// fixed unit order, so a D at or below 128 runs exactly as before.  mma.sync and not wgmma (m64nNk8): at G = 8 a block is 256
// small products that take well under a microsecond, against microseconds
// of loads and decode; wgmma is the next step only if the products set the
// pace.
//
// Split rule.  The block loop is split across CTAs: CTA (h, s, b) takes the
// ring slots n in [s*S, s*S + S) of row b and KV head h, S = kSplit fixed at
// compile time (never derived from B, the batch's lengths or the card); the
// last CTA of each (row, head), s = ceil(NB/S), takes the raw tail buffer.
// S = 1, chosen by measurement among 1, 2 and 4 (PERF.md): at the serving
// lengths (5 to 16 live blocks a row) the CTAs of one launch fit the card in
// one wave, and a CTA's time is one block's chain of dependent steps, so
// every extra block a CTA takes adds to the kernel's time; only rows of 64
// blocks gain from S = 2, by a few percent.
// A range that starts at or past nb_valid[b] exits at once.  Each CTA writes
// its float32 partial (acc[G, D], m[G], l[G]) to a workspace the wrapper
// allocates; fused_kv_attn_combine then merges the live ranges in ascending
// order and the buffer last, and writes acc / max(l, 1e-30).  No atomics:
// a row's output depends only on its own blocks and lengths, so batched ==
// solo and run-to-run equality hold bit for bit.  Paged ranges are cut on the
// ring slot n, never on pages, and an unassigned entry (< 0 or >= P) inside a
// range is skipped (the TPU kernel's `pt_ref >= 0` guard,
// src/repro/kernels/fused_kv_attn.py:113-114), so paged and dense give the
// same bits on the same blocks.  The CTA reads only its own range's
// page-table entries.
//
// Loads.  A block's K words, V words and four scale vectors are contiguous
// runs; each is brought into shared memory with 16-byte cp.async copies of
// the aligned granules that cover it (the run lands at its address modulo
// 16), issued before the CTA loads q, so the two latencies overlap.  With
// S > 1 the stages are double-buffered: block n+1's copies are in flight
// while block n decodes and multiplies.  Tiles in shared memory hold codes
// (u8) or bf16 values, row stride D + 8, never dequantized float32.
//
// What sets the pace: latency, not the card's rates.  At the serving shapes
// a launch has about one live CTA an SM (8 warps), so each step of a block
// (copy, decode, scores, softmax, P.V) costs its dependency chain.  The code
// keeps loads independent (q's loads all in flight before its stores; four
// codes decoded a 32-bit store; hi and lo products on separate mma chains).
//
// Decode.  Packed tiles: each thread writes four codes of a row a store
// (code i = t*D + d sits in word i / cpw at bit (i % cpw) * bits).
// Huffman tiles: the K slot and the V slot of a block are staged together
// and all T K streams and all T V streams decode at once, one thread a
// stream, K and V on different warps, so a block's critical path is one
// stream's chain of LUT probes; each warp finds its streams' first bits with
// a warp scan over the header (huffman.cuh, whose reading semantics the
// huffman_decode kernels share; a stream keeps its two current words in
// registers).  One stream's chain of LUT probes takes most of a huffman
// block's time.  The LUTs stay on the read-only path: staging
// them in shared memory did not shorten the chain in a measurement, and at
// S = 1 it would copy 57 KB to decode 8.5 KB.  Both kinds write the
// same codes into the same tile, and everything after the decode is shared,
// so huffman and packed give bit-identical outputs on the same blocks.
//
// Limits: G <= 8 (one n-tile), D a multiple of 8 in [8, 160] (StableLM-2-12B's
// head_dim 160: 10 m-tiles), T a multiple of 8 in [8, 128], code widths of at
// most 8 bits.  `-Xptxas -v` for sm_90a with kMaxDim 160: the split kernel 67
// (raw), 72 (packed) and 64 (huffman) registers, the combine 31; no stack, no
// spills.  The launch bounds ask for one CTA an SM (what the serving shapes
// give): without that minimum ptxas held the packed kernel to 64 registers
// and spilled 8 bytes.  Dynamic shared memory (smem_plan) a CTA, set by the
// buffer CTA's two bf16 tiles for every kind: 45,472 B at Yi-6B's D 128, T 64;
// 55,712 B at StableLM-2-12B's D 160, T 64; 100,768 B at D 160, T 128 (over
// 48 KB the launch raises the kernel's dynamic shared memory limit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "huffman.cuh"

// The ring slots a CTA takes.  chip_smoke.py --split-sweep builds variants
// with -DFETCH_SPLIT_BLOCKS=1, 2, 4 to measure it; the package never sets it.
#ifndef FETCH_SPLIT_BLOCKS
#define FETCH_SPLIT_BLOCKS 1
#endif

namespace {

constexpr int kSplit = FETCH_SPLIT_BLOCKS;  // ring slots a CTA
constexpr int kStages = kSplit > 1 ? 2 : 1;
constexpr float kNegInit = -1e30f;  // finite "-inf" (kernels/ref.py NEG_INIT)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kN = 8;           // the mma n-tile: the query group, padded
constexpr int kMaxDim = 160;    // D <= 10 m-tiles of 16
constexpr int kMaxT = 128;      // T <= 8 m-tiles of 16
constexpr int kAcc = kN * kMaxDim / kThreads;  // output elements a thread
enum TileKind { kRaw = 0, kPacked = 1, kHuffman = 2 };

struct Params {
  const float* q;  // [B, Hkv*G, D]
  // Stores: [Bs, Hkv, P, ...] with Bs = B, P = NB dense; Bs = 1 for an arena.
  const void* k_store;  // packed/huffman: u32 [Bs,Hkv,P,Wk]; raw: bf16 [Bs,Hkv,P,T,D]
  const __nv_bfloat16* k_min;  // [Bs,Hkv,P,D] (packed and huffman)
  const __nv_bfloat16* k_step;
  const void* v_store;
  const __nv_bfloat16* v_min;  // [Bs,Hkv,P,T]
  const __nv_bfloat16* v_step;
  const __nv_bfloat16* k_buf;  // [B,Hkv,T,D]
  const __nv_bfloat16* v_buf;
  const int* nb_valid;  // [B]
  const int* buf_len;   // [B]
  const int* page_tab;  // [B, NB] arena page of each ring slot; null = dense
  const int* lut_k;     // huffman: flat [n_nodes * 256] decode LUTs
  const int* lut_v;
  float* ws;   // [B, Hkv, nsplit, G*D + 2*G]: each range's acc, m, l
  float* out;  // [B, Hkv*G, D]
  int Hkv, G, D, T, NB, P, Wk, Wv, bits_k, bits_v;
  int hdr_k, hdr_v, probes_k, probes_v;  // huffman: header words, LUT probes
  int nsplit;  // ceil(NB / kSplit) store ranges + the buffer
  float scale;
};

__host__ __device__ constexpr int r16(int x) { return (x + 15) & ~15; }

// The units of a product with m-extent M: (m-tile, k-share) pairs, and the
// warps (k-shares) an m-tile.  At most 8 m-tiles: 8 units, kWarps / MT
// warps an m-tile; more: one unit (and one k-share) an m-tile.
__host__ __device__ constexpr int m_tiles(int M) { return (M + 15) >> 4; }
__host__ __device__ constexpr int k_shares(int M) {
  return m_tiles(M) <= kWarps ? kWarps / m_tiles(M) : 1;
}
__host__ __device__ constexpr int red_units(int D, int T) {
  return m_tiles(D > T ? D : T) > kWarps ? m_tiles(D > T ? D : T) : kWarps;
}

// Byte offsets into dynamic shared memory, the same on host and device.
struct Smem {
  int qs, ps, red, misc, region, total;
  int raw_tile, code_tile;          // one bf16 / u8 [T, D + 8] tile
  int kw, vw, kmn, kst, vmn, vst;   // inside one word stage
  int stage, codes;                 // one stage; the two code tiles
};

__host__ __device__ inline Smem smem_plan(int kind, int D, int T, int Wk, int Wv) {
  Smem s{};
  s.qs = 0;                                      // f32 [kN, D + 4]: q
  s.ps = s.qs + r16(4 * kN * (D + 4));           // f32 [kN, T + 4]: p
  s.red = s.ps + r16(4 * kN * (T + 4));          // f32 [units, 16, 8]: partial products
  s.misc = s.red + 4 * red_units(D, T) * 16 * kN;  // f32 m, l, alpha, c0, cv [kN]
  s.region = s.misc + r16(4 * 5 * kN);
  s.raw_tile = r16(2 * T * (D + 8));
  s.code_tile = r16(T * (D + 8));
  int region;
  if (kind == kRaw) {
    s.stage = 2 * s.raw_tile;  // the K and V tiles themselves
    region = kStages * s.stage;
  } else {
    // each run may land up to 15 bytes into its granule
    s.kw = 0;
    s.vw = s.kw + r16(4 * Wk) + 32;
    s.kmn = s.vw + r16(4 * Wv) + 32;
    s.kst = s.kmn + r16(2 * D) + 32;
    s.vmn = s.kst + r16(2 * D) + 32;
    s.vst = s.vmn + r16(2 * T) + 32;
    s.stage = s.vst + r16(2 * T) + 32;
    s.codes = kStages * s.stage;
    region = s.codes + 2 * s.code_tile;
    if (region < 2 * s.raw_tile) region = 2 * s.raw_tile;  // the buffer CTA's tiles
  }
  s.total = s.region + region;
  return s;
}

// --- copies --------------------------------------------------------------

// A bf16 [T, D] tile (16-byte aligned) into rows of stride D + 8.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int T,
                                           int D) {
  const int cpr = D / 8;
  for (int i = threadIdx.x; i < T * cpr; i += kThreads) {
    const int t = i / cpr, c = i - t * cpr;
    cp_async16(dst + t * (D + 8) + c * 8, src + t * D + c * 8);
  }
}

// One block's sources in global memory.
struct BlockSrc {
  const void *kw, *vw;  // words, or bf16 tiles (raw)
  const __nv_bfloat16 *kmn, *kst, *vmn, *vst;
};

__device__ __forceinline__ BlockSrc block_src(const Params& p, int kind, size_t blk) {
  BlockSrc s;
  if (kind == kRaw) {
    const size_t n = static_cast<size_t>(p.T) * p.D;
    s.kw = static_cast<const __nv_bfloat16*>(p.k_store) + blk * n;
    s.vw = static_cast<const __nv_bfloat16*>(p.v_store) + blk * n;
    s.kmn = s.kst = s.vmn = s.vst = nullptr;
  } else {
    s.kw = static_cast<const uint32_t*>(p.k_store) + blk * p.Wk;
    s.vw = static_cast<const uint32_t*>(p.v_store) + blk * p.Wv;
    s.kmn = p.k_min + blk * p.D;
    s.kst = p.k_step + blk * p.D;
    s.vmn = p.v_min + blk * p.T;
    s.vst = p.v_step + blk * p.T;
  }
  return s;
}

__device__ __forceinline__ void issue_block(const Params& p, int kind, const Smem& L,
                                            uint8_t* stage, const BlockSrc& s) {
  if (kind == kRaw) {
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(stage);
    stage_tile(kt, static_cast<const __nv_bfloat16*>(s.kw), p.T, p.D);
    stage_tile(kt + L.raw_tile / 2, static_cast<const __nv_bfloat16*>(s.vw), p.T, p.D);
  } else {
    stage_run(stage + L.kw, s.kw, 4 * p.Wk, kThreads);
    stage_run(stage + L.vw, s.vw, 4 * p.Wv, kThreads);
    stage_run(stage + L.kmn, s.kmn, 2 * p.D, kThreads);
    stage_run(stage + L.kst, s.kst, 2 * p.D, kThreads);
    stage_run(stage + L.vmn, s.vmn, 2 * p.T, kThreads);
    stage_run(stage + L.vst, s.vst, 2 * p.T, kThreads);
  }
  cp_async_commit();
}

// --- decode --------------------------------------------------------------

// No-straddle words -> u8 codes [T, D + 8], four codes of a row a 32-bit
// store (code i = t*D + d sits in word i / cpw at bit (i % cpw) * bits;
// four consecutive codes span at most two words, as cpw >= 4).  The
// iterations are independent, so their loads overlap.
__device__ __forceinline__ void decode_packed(const uint32_t* __restrict__ w, int W, int bits,
                                              int T, int D, uint8_t* __restrict__ tile) {
  const uint32_t cpw = 32 / bits, mask = (1u << bits) - 1u;
  const uint32_t magic = 0xFFFFFFFFu / cpw + 1u;  // umulhi(i, magic) == i / cpw for i < 2^22
  const int D4 = D / 4, st = kThreads / D4, sd = kThreads - st * D4;
  int t = threadIdx.x / D4, d4 = threadIdx.x - t * D4;
#pragma unroll 4
  while (t < T) {
    const uint32_t i = static_cast<uint32_t>(t * D + 4 * d4);
    const uint32_t wi = __umulhi(i, magic), o = i - wi * cpw;
    const uint32_t w0 = w[wi], w1 = w[min(wi + 1, static_cast<uint32_t>(W - 1))];
    uint32_t v = 0;
#pragma unroll
    for (uint32_t u = 0; u < 4; ++u) {
      const uint32_t c = o + u < cpw ? w0 >> ((o + u) * bits) : w1 >> ((o + u - cpw) * bits);
      v |= (c & mask) << (8 * u);
    }
    *reinterpret_cast<uint32_t*>(tile + t * (D + 8) + 4 * d4) = v;
    t += st;
    d4 += sd;
    if (d4 >= D4) {
      d4 -= D4;
      ++t;
    }
  }
}

// Huffman slots -> u8 codes: K streams on threads [0, T), V streams on
// [Tw, Tw + T), Tw = T rounded up to a warp, so K and V run on different
// warps at the same time, one thread a stream.
__device__ __forceinline__ void decode_huffman(const Params& p, const uint32_t* ks,
                                               const uint32_t* vs, uint8_t* kt, uint8_t* vt) {
  const int T = p.T, D = p.D, Tw = (T + 31) & ~31;
  const int tid = threadIdx.x;
  if (tid >= 2 * Tw) return;  // whole warps
  const bool v = tid >= Tw;
  const int s = tid - (v ? Tw : 0);
  const uint32_t* slot = v ? vs : ks;
  const int hdr = v ? p.hdr_v : p.hdr_k, W = v ? p.Wv : p.Wk;
  const int pos = huff::stream_start_warp(slot, s, T);  // the whole warp
  if (s >= T) return;
  uint8_t* row = (v ? vt : kt) + s * (D + 8);
  huff::lut_decode_stream(slot + hdr, W - hdr, pos, pos + huff::stream_bits(slot, s),
                          v ? p.lut_v : p.lut_k, v ? p.probes_v : p.probes_k, D,
                          [&](int d, int c) { row[d] = static_cast<uint8_t>(c); });
}

// --- products ------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float elem(const uint8_t* t, int i) { return static_cast<float>(t[i]); }
__device__ __forceinline__ float elem(const __nv_bfloat16* t, int i) {
  return __bfloat162float(t[i]);
}

// Warp `warp`'s units of C[M, 8] = A[M, K] * B[K, 8], unit u into red[u]
// (row major [16, 8]).  A(m, k) = tile[m * DP + k], or tile[k * DP + m] when
// kTrans; B(k, g) = bsrc[g * bstride + k] * st[k] (st null: 1), split into
// TF32 hi and lo.  Unit u takes m-tile u / kw and k-steps u % kw + j * kw,
// kw = k_shares(M); warp w takes units w, w + kWarps, ...
template <bool kTrans, typename E>
__device__ __forceinline__ void product(const E* __restrict__ tile, int DP,
                                        const float* __restrict__ bsrc, int bstride,
                                        const __nv_bfloat16* __restrict__ st, int M, int K,
                                        float* __restrict__ red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tq = lane & 3;
  const int kw = k_shares(M), units = m_tiles(M) * kw, KS = K >> 3;
  const float* brow = bsrc + grp * bstride;
#pragma unroll 1
  for (int u = warp; u < units; u += kWarps) {
    float ch[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};  // two mma chains
    const int r0 = (u / kw) * 16 + grp, r1 = r0 + 8;
    const bool ok0 = r0 < M, ok1 = r1 < M;
#pragma unroll 4
    for (int ks = u % kw; ks < KS; ks += kw) {
      const int k0 = ks * 8 + tq, k1 = k0 + 4;
      uint32_t a[4];
      if (kTrans) {
        a[0] = __float_as_uint(ok0 ? elem(tile, k0 * DP + r0) : 0.f);
        a[1] = __float_as_uint(ok1 ? elem(tile, k0 * DP + r1) : 0.f);
        a[2] = __float_as_uint(ok0 ? elem(tile, k1 * DP + r0) : 0.f);
        a[3] = __float_as_uint(ok1 ? elem(tile, k1 * DP + r1) : 0.f);
      } else {
        a[0] = __float_as_uint(ok0 ? elem(tile, r0 * DP + k0) : 0.f);
        a[1] = __float_as_uint(ok1 ? elem(tile, r1 * DP + k0) : 0.f);
        a[2] = __float_as_uint(ok0 ? elem(tile, r0 * DP + k1) : 0.f);
        a[3] = __float_as_uint(ok1 ? elem(tile, r1 * DP + k1) : 0.f);
      }
      float x0 = brow[k0], x1 = brow[k1];
      if (st != nullptr) {
        x0 = __fmul_rn(x0, __bfloat162float(st[k0]));
        x1 = __fmul_rn(x1, __bfloat162float(st[k1]));
      }
      const uint32_t h0 = tf32(x0), h1 = tf32(x1);
      mma_tf32(cl, a, tf32(__fsub_rn(x0, __uint_as_float(h0))),
               tf32(__fsub_rn(x1, __uint_as_float(h1))));
      mma_tf32(ch, a, h0, h1);
    }
    float2* r = reinterpret_cast<float2*>(red + u * 16 * kN);
    r[(grp * kN + 2 * tq) / 2] = make_float2(__fadd_rn(ch[0], cl[0]), __fadd_rn(ch[1], cl[1]));
    r[((grp + 8) * kN + 2 * tq) / 2] = make_float2(__fadd_rn(ch[2], cl[2]),
                                                   __fadd_rn(ch[3], cl[3]));
  }
}

// Element (m, g) of a product: its units' partials added in unit order.
__device__ __forceinline__ float reduced(const float* red, int M, int m, int g) {
  const int kw = k_shares(M);
  const float* r = red + ((m >> 4) * kw) * 16 * kN + (m & 15) * kN + g;
  float v = r[0];
  for (int j = 1; j < kw; ++j) v = __fadd_rn(v, r[j * 16 * kN]);
  return v;
}

struct Shared {
  float *qs, *ps, *red, *m, *l, *alpha, *c0, *cv;
};

// One tile's attention update: scores, online softmax, P.V, into (m, l) in
// shared memory and acc in registers.  k_mn / k_st / v_mn / v_st are the
// staged unit scales (null for raw tiles).  Tokens t >= valid are masked.
// Called with the tiles ready in shared memory, by every thread.
template <typename E>
__device__ void attend_tile(const Params& p, const Shared& sh, const E* kt, const E* vt,
                            const __nv_bfloat16* k_mn, const __nv_bfloat16* k_st,
                            const __nv_bfloat16* v_mn, const __nv_bfloat16* v_st, int valid,
                            float (&acc)[kAcc]) {
  const int G = p.G, D = p.D, T = p.T, DP = D + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (k_mn != nullptr && warp < G) {  // c0[g] = sum_d q[g, d] * mn[d]
    float c = 0.f;
    for (int d = lane; d < D; d += 32) c = __fmaf_rn(sh.qs[warp * (D + 4) + d], __bfloat162float(k_mn[d]), c);
    for (int o = 16; o > 0; o >>= 1) c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, o));
    if (lane == 0) sh.c0[warp] = c;
  }
  __syncthreads();
  product<false>(kt, DP, sh.qs, D + 4, k_st, T, D, sh.red);
  __syncthreads();
  if (warp < G) {  // warp g: row g's scores, online softmax, p and cv
    const int g = warp;
    float sv[kMaxT / 32];
    float mx = kNegInit;
#pragma unroll
    for (int j = 0; j < kMaxT / 32; ++j) {
      const int t = lane + 32 * j;
      sv[j] = kNegInit;
      if (t < T && t < valid) {
        sv[j] = __fmul_rn(p.scale, __fadd_rn(reduced(sh.red, T, t, g), sh.c0[g]));
        mx = fmaxf(mx, sv[j]);
      }
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = sh.m[g];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f, cv = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT / 32; ++j) {
      const int t = lane + 32 * j;
      if (t < T) {
        const float pr = t < valid ? expf(__fsub_rn(sv[j], m_new)) : 0.f;
        sh.ps[g * (T + 4) + t] = pr;
        sum = __fadd_rn(sum, pr);
        if (v_mn != nullptr) cv = __fmaf_rn(pr, __bfloat162float(v_mn[t]), cv);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      cv = __fadd_rn(cv, __shfl_xor_sync(0xffffffffu, cv, o));
    }
    if (lane == 0) {
      const float a = expf(__fsub_rn(m_prev, m_new));
      sh.alpha[g] = a;
      sh.cv[g] = cv;
      sh.l[g] = __fmaf_rn(sh.l[g], a, sum);
      sh.m[g] = m_new;
    }
  }
  __syncthreads();
  product<true>(vt, DP, sh.ps, T + 4, v_st, D, T, sh.red);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < G * D) {
      const int g = e / D, d = e - g * D;
      acc[k] = __fmaf_rn(acc[k], sh.alpha[g], __fadd_rn(reduced(sh.red, D, d, g), sh.cv[g]));
    }
  }
}

// --- the kernels ---------------------------------------------------------

// CTA (h, s, b): ring slots [s*kSplit, s*kSplit + kSplit) of row b, head h,
// or (s = nsplit - 1) the raw tail buffer; writes the range's partial.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 1) fused_kv_attn_split_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int G = p.G, D = p.D, T = p.T, tid = threadIdx.x;
  const bool buffer = s == p.nsplit - 1;
  const int nbv = min(max(p.nb_valid[b], 0), p.NB);
  const int n0 = s * kSplit, n1 = min(n0 + kSplit, nbv);
  if (!buffer && n0 >= nbv) return;  // the combine reads only live ranges
  const Smem L = smem_plan(KIND, D, T, p.Wk, p.Wv);
  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;
  uint8_t* region = smem + L.region;

  // The live blocks of the range (a paged entry that is unassigned skips).
  size_t blks[kSplit];
  int nl = 0;
  if (!buffer) {
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      const int n = n0 + j;
      if (n >= n1) break;
      if (p.page_tab != nullptr) {
        const int page = p.page_tab[static_cast<size_t>(b) * p.NB + n];
        if (page < 0 || page >= p.P) continue;
        blks[nl++] = static_cast<size_t>(h) * p.P + page;
      } else {
        blks[nl++] = bh * p.NB + n;
      }
    }
    if (nl > 0) issue_block(p, KIND, L, region, block_src(p, KIND, blks[0]));
  } else {
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(region);
    stage_tile(kt, p.k_buf + bh * T * D, T, D);
    stage_tile(kt + L.raw_tile / 2, p.v_buf + bh * T * D, T, D);
    cp_async_commit();
  }

  Shared sh;
  sh.qs = reinterpret_cast<float*>(smem + L.qs);
  sh.ps = reinterpret_cast<float*>(smem + L.ps);
  sh.red = reinterpret_cast<float*>(smem + L.red);
  sh.m = reinterpret_cast<float*>(smem + L.misc);
  sh.l = sh.m + kN;
  sh.alpha = sh.l + kN;
  sh.c0 = sh.alpha + kN;
  sh.cv = sh.c0 + kN;
  const float* __restrict__ qrow = p.q + bh * G * D;  // rows h*G .. h*G+G-1 of q[b]
  float qv[kAcc];  // every load in flight before the first store
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int i = tid + k * kThreads;
    qv[k] = i < G * D ? __ldg(qrow + i) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int i = tid + k * kThreads;
    if (i < kN * D) sh.qs[(i / D) * (D + 4) + i % D] = qv[k];  // rows >= G: 0
  }
  for (int i = tid; i < kN * (T + 4); i += kThreads) sh.ps[i] = 0.f;  // rows >= G stay 0
  if (tid < kN) {
    sh.m[tid] = kNegInit;
    sh.l[tid] = 0.f;
    sh.c0[tid] = 0.f;
    sh.cv[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;

  if (buffer) {
    cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(region);
    attend_tile(p, sh, kt, kt + L.raw_tile / 2, nullptr, nullptr, nullptr, nullptr,
                min(max(p.buf_len[b], 0), T), acc);
  } else {
    for (int i = 0; i < nl; ++i) {
      uint8_t* stage = region + (i & 1) * L.stage;
      if (kStages > 1 && i + 1 < nl) {
        issue_block(p, KIND, L, region + ((i + 1) & 1) * L.stage, block_src(p, KIND, blks[i + 1]));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (KIND == kRaw) {
        const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(stage);
        attend_tile(p, sh, kt, kt + L.raw_tile / 2, nullptr, nullptr, nullptr, nullptr, T, acc);
      } else {
        const BlockSrc src = block_src(p, KIND, blks[i]);
        uint8_t* kt = region + L.codes;
        uint8_t* vt = kt + L.code_tile;
        const uint32_t* kw = landed<uint32_t>(stage + L.kw, src.kw);
        const uint32_t* vw = landed<uint32_t>(stage + L.vw, src.vw);
        if (KIND == kHuffman) {
          decode_huffman(p, kw, vw, kt, vt);
        } else {
          decode_packed(kw, p.Wk, p.bits_k, T, D, kt);
          decode_packed(vw, p.Wv, p.bits_v, T, D, vt);
        }
        attend_tile(p, sh, kt, vt, landed<__nv_bfloat16>(stage + L.kmn, src.kmn),
                    landed<__nv_bfloat16>(stage + L.kst, src.kst),
                    landed<__nv_bfloat16>(stage + L.vmn, src.vmn),
                    landed<__nv_bfloat16>(stage + L.vst, src.vst), T, acc);
      }
      __syncthreads();  // the stage and tiles are free for the next block
    }
  }

  float* rec = p.ws + (bh * p.nsplit + s) * static_cast<size_t>(G * (D + 2));
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kThreads;
    if (e < G * D) rec[e] = acc[k];
  }
  if (tid < G) {  // written by this thread, or behind the last barrier
    rec[G * D + tid] = sh.m[tid];
    rec[G * D + G + tid] = sh.l[tid];
  }
}

// CTA (h*G + g, b), a thread per column d: merge row b's live ranges in
// ascending order, then the buffer, and normalize.  The ranges' m and l go
// to shared memory first (all loads in flight at once); then every thread
// runs the same fixed-order sums.
__global__ void fused_kv_attn_combine(Params p) {
  extern __shared__ float cs[];  // m, l, w of each record
  const int G = p.G, D = p.D, tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x / G, g = blockIdx.x - h * G, b = blockIdx.y;
  const int nbv = min(max(p.nb_valid[b], 0), p.NB);
  const int nr = (nbv + kSplit - 1) / kSplit + 1;  // live ranges, then the buffer
  const size_t bh = static_cast<size_t>(b) * p.Hkv + h;
  const int rs = G * (D + 2);
  const float* __restrict__ base = p.ws + bh * p.nsplit * rs;
  auto rec = [&](int s) { return base + static_cast<size_t>(s < nr - 1 ? s : p.nsplit - 1) * rs; };
  for (int s = tid; s < nr; s += blockDim.x) {
    cs[s] = rec(s)[G * D + g];
    cs[nr + s] = rec(s)[G * D + G + g];
  }
  __syncthreads();
  float M = kNegInit;
  for (int s = lane; s < nr; s += 32) M = fmaxf(M, cs[s]);
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  for (int s = tid; s < nr; s += blockDim.x) cs[2 * nr + s] = expf(__fsub_rn(cs[s], M));
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float a = 0.f, l = 0.f;
#pragma unroll 4
    for (int s = 0; s < nr; ++s) {
      const float w = cs[2 * nr + s];
      l = __fmaf_rn(cs[nr + s], w, l);
      a = __fmaf_rn(rec(s)[g * D + d], w, a);
    }
    p.out[(bh * G + g) * D + d] = __fdiv_rn(a, fmaxf(l, 1e-30f));
  }
}

template <int KIND>
cudaError_t launch_split(const Params& p, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_kv_attn_split_kernel<KIND>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_kv_attn_split_kernel<KIND><<<dim3(p.Hkv, p.nsplit, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The ring slots a CTA takes (the wrapper sizes the workspace from it).
int fused_kv_attn_split_blocks() { return kSplit; }

const char* fused_kv_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the split kernel and the combine on `stream` of card `device`
// (the card that holds the tensors; the launch selects it itself, since this
// library's runtime keeps a current device of its own) and returns
// cudaGetLastError().  kind: 0 raw, 1 packed (no-straddle words), 2 huffman
// (lut_k / lut_v, hdr_*, probes_*).  ws: float32, B * Hkv * (ceil(NB /
// kSplit) + 1) * G * (D + 2) elements.
int fused_kv_attn_launch(const void* q, const void* k_store, const void* k_min,
                         const void* k_step, const void* v_store, const void* v_min,
                         const void* v_step, const void* k_buf, const void* v_buf,
                         const void* nb_valid, const void* buf_len, const void* page_tab,
                         const void* lut_k, const void* lut_v, void* ws, void* out, int B,
                         int Hkv, int G, int D, int T, int NB, int P, int Wk, int Wv, int bits_k,
                         int bits_v, int kind, int hdr_k, int hdr_v, int probes_k,
                         int probes_v, float scale, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const bool dims_ok = G >= 1 && G <= kN && D % 8 == 0 && D >= 8 && D <= kMaxDim &&
                       T % 8 == 0 && T >= 8 && T <= kMaxT && kind >= kRaw && kind <= kHuffman;
  const bool bits_ok = kind != kPacked || (bits_k >= 1 && bits_k <= 8 && bits_v >= 1 && bits_v <= 8);
  const int nsplit = (NB + kSplit - 1) / kSplit + 1;
  if (!dims_ok || !bits_ok || B < 1 || Hkv < 1 || NB < 1 || 3 * 4 * nsplit > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.ws = static_cast<float*>(ws);
  p.out = static_cast<float*>(out);
  p.Hkv = Hkv; p.G = G; p.D = D; p.T = T; p.NB = NB; p.P = P; p.Wk = Wk; p.Wv = Wv;
  p.bits_k = bits_k; p.bits_v = bits_v; p.scale = scale;
  p.hdr_k = hdr_k; p.hdr_v = hdr_v; p.probes_k = probes_k; p.probes_v = probes_v;
  p.nsplit = nsplit;
  const size_t smem = static_cast<size_t>(smem_plan(kind, D, T, Wk, Wv).total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = kind == kRaw      ? launch_split<kRaw>(p, B, smem, st)
                  : kind == kPacked ? launch_split<kPacked>(p, B, smem, st)
                                    : launch_split<kHuffman>(p, B, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_kv_attn_combine<<<dim3(Hkv * G, B), (D + 31) & ~31, 3 * sizeof(float) * p.nsplit,
                          st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
