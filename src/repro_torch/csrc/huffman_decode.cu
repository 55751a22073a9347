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
// sums (K.q) * scale in float32.
//
// What bounds the walk kernels on an H100: by the card's rates, bytes (a
// block's payload, a few KB, and its codes or scores out); in fact latency.
// A launch is one wave (phase 11's 256 blocks: 128 CTAs on 132 SMs), so its
// time is one CTA's critical path: a trip to device memory, the root
// table's build, one stream's chain of dependent table probes, the
// copy-out.  The earlier kernel (PR 13: a CTA a block, a thread a stream
// walking a bit a step) paid serial start sums, dependent shared reads
// every bit and a device-memory word read every 32 bits; stamped copies of
// this one (PERF.md, PR 16) put most of a CTA's cycles in the probe chain,
// then the trip to device memory.  The design:
// - Root table.  Each CTA builds a multi-symbol table from the tree tables
//   it is given (no host step, no codebook): entry c (kPeekBits = 10 bits)
//   holds the whole codewords the walk from the root meets in c's bits (at
//   most kPeekSymbols), the bits through each, and the bits up to the walk's
//   last return to the root; a probe writes them all, so a K stream (4- and
//   5-bit codes) takes 64 probes where the walk took 540 steps.  An entry
//   with no return to the root (a code longer than the peek, a tree that is
//   not complete) holds the node reached, and the stream walks on from it a
//   bit a step to the next leaf or root: exact for any tree tables.  The
//   CTA's 512 threads build the 1,024 entries, two walks a thread
//   interleaved step by step.  A 12-bit table costs more to build than its
//   shorter chain saves, and one built by a kernel of its own and staged
//   into every CTA was no faster.
// - Copies.  Every read of device memory is a 16-byte cp.async of the
//   granules that cover it, all in flight at once: the tree tables (then
//   packed into a word a node), then the payload and bit counts.  Codes go
//   to rows of stride L4 + 4 in shared memory and leave in 16-byte stores.
// - Streams.  A thread decodes a stream and finds its first bit with the
//   warp scan (huff::stream_start_warp_by).  The probe loop keeps three
//   payload words in registers, moves its window by selects, and issues the
//   next probe's table read before the branch to its slow path (the
//   budget's last probe, and the bit walk) and before this probe's stores.
// - Scores.  Kernel 4 forms kmn * q and kst * q once a block, and a thread
//   sums its row's fma(c, kst q, kmn q) right after its decode, while other
//   streams still decode (four threads a row after a barrier was slower).
// - Shape.  A CTA takes two blocks and has 512 threads (at S = 64, 128
//   decode; the rest stage, build and copy out): phase 11's 256 blocks are
//   128 CTAs, one wave.  One or four blocks a CTA, or 256 threads, were
//   slower.
//
// huffman_lut_decode_kernel has no Pallas counterpart: it is the blockwise
// chunk path's slot decode (`HuffmanLayout._decode`, src/repro/core/
// layouts.py:755-774, which the reference runs as one XLA loop), of K and V
// in one launch.  It writes the codes of the reference's chunked LUT decode
// (`decode_block_lut_jax`), edge cases included.
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
// `-Xptxas -v` for sm_90a: the slot decode 32 registers, the walk decode 31,
// the walk + scores 40; no stack, no spills.  Shared memory at Yi-6B width:
// a slot-decode CTA 32,768 B of table, 16,896 B of code rows, 2 x 5,280 B of
// K slot; a walk CTA on phase 11's blocks (W = 1281 words) 46,224 B (decode)
// and 50,912 B (scores): 8,192 B of root table, 2,048 B of node records,
// 16,896 B of code rows, 8,240 B of staged tree tables, per block its
// payload and bit counts (and the score rows and factors).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "huffman.cuh"

namespace {

// ---- The walk kernels ------------------------------------------------------

constexpr int kPeekBits = 10;          // a root-table probe peeks this many stream bits
constexpr int kPeekSymbols = 4;        // whole codewords an entry holds, at most
constexpr int kWalkBlocksPerCta = 2;   // blocks of streams a CTA decodes
constexpr int kWalkThreads = 512;      // a walk CTA's threads
constexpr uint32_t kChildMask = 0x1FFu;  // a node record: child 0 at bits 0..8,
constexpr uint32_t kLeafBit = 1u << 18;  // child 1 at 9..17, the leaf flag, and the
                                         // symbol at 24..31 (huffman.py MAX_NODES = 512)

struct WalkArgs {
  const uint32_t* payload;  // [NBLK, W]
  const int* nbits;         // [NBLK, S] (u16 values)
  const int* children;      // [n_nodes, 2]
  const int* is_symbol;     // [n_nodes]
  const int* symbols;       // [n_nodes]
  int NBLK, W, S, L, n_nodes, max_bits;
};

// A walk CTA's shared memory, byte offsets (each a multiple of 16): the root
// table; the node records; the code rows of all its blocks (stride rs, so
// the blocks' rows are consecutive as in the output); the tree tables and q
// as staged; then per block its payload and bit counts as staged and, for
// the scores, its k_min and k_step rows as staged and the factors kmn * q
// and kst * q.
struct WalkSmem {
  int nodes, rows, rs, ch, isym, sym, q, block, nb, kmn, kst, fac, per_block, total;
};

__host__ __device__ inline WalkSmem walk_smem(int W, int S, int L, int n_nodes, bool scores) {
  WalkSmem m;
  const int L4 = (L + 3) / 4 * 4;
  m.nodes = static_cast<int>(sizeof(uint2)) << kPeekBits;
  m.rows = m.nodes + (4 * n_nodes + 15) / 16 * 16;
  m.rs = L4 + 4;
  m.ch = m.rows + (kWalkBlocksPerCta * S * m.rs + 15) / 16 * 16;
  m.isym = m.ch + run_bytes(8 * n_nodes);
  m.sym = m.isym + run_bytes(4 * n_nodes);
  m.q = m.sym + run_bytes(4 * n_nodes);
  m.block = m.q + (scores ? run_bytes(4 * L) : 0);
  m.nb = run_bytes(4 * W);  // the payload first
  m.kmn = m.nb + run_bytes(4 * S);
  m.kst = m.kmn + (scores ? run_bytes(4 * L) : 0);
  m.fac = m.kst + (scores ? run_bytes(4 * L) : 0);
  m.per_block = m.fac + (scores ? 2 * 4 * L4 : 0);
  m.total = m.block + kWalkBlocksPerCta * m.per_block;
  return m;
}

__device__ __forceinline__ uint32_t child_of(uint32_t rec, uint32_t bit) {
  return (rec >> (9 * bit)) & kChildMask;
}

// Root-table entry c: the tree walk from the root along the kPeekBits bits
// of c (LSB-first), a step idx = child(idx, bit) and, at a leaf, the symbol
// and back to the root, as walk_decode_jax steps.  .x holds the symbols of
// the first kPeekSymbols leaves at bits 8k, .y their count, the bits
// consumed through each at bits 4 + 4k, and at bits 20..23 the bits
// consumed in all: up to the last step that left the walk at the root (a
// leaf, or a child pointer back to the root).  Where no step in the peek
// does, .y is 0 and .x is the node the walk has reached.
//
// The CTA's threads build the table kBuildIlp entries a thread at a time,
// the entries' walks interleaved step by step (selects, no branches), so a
// thread keeps kBuildIlp node reads in flight.
constexpr int kBuildIlp = 2;

__device__ __forceinline__ void build_root_table(const uint32_t* nodes, uint2* tab) {
  const uint32_t root = nodes[0];
  for (int c0 = threadIdx.x; c0 < (1 << kPeekBits); c0 += kBuildIlp * kWalkThreads) {
    uint32_t rec[kBuildIlp], idx[kBuildIlp], syms[kBuildIlp], meta[kBuildIlp], cnt[kBuildIlp],
        used[kBuildIlp];
#pragma unroll
    for (int k = 0; k < kBuildIlp; ++k) {
      rec[k] = root;
      idx[k] = syms[k] = meta[k] = cnt[k] = used[k] = 0;
    }
#pragma unroll
    for (int b = 0; b < kPeekBits; ++b) {
#pragma unroll
      for (int k = 0; k < kBuildIlp; ++k) {
        const uint32_t c = static_cast<uint32_t>(c0 + k * kWalkThreads);
        const uint32_t nxt = child_of(rec[k], (c >> b) & 1u);
        const uint32_t r = nodes[nxt];
        const bool live = cnt[k] < kPeekSymbols, leaf = live && (r & kLeafBit);
        syms[k] |= leaf ? (r >> 24) << (8 * cnt[k]) : 0u;
        meta[k] |= leaf ? static_cast<uint32_t>(b + 1) << (4 + 4 * cnt[k]) : 0u;
        used[k] = live && (leaf || nxt == 0) ? b + 1 : used[k];
        idx[k] = live ? (leaf ? 0u : nxt) : idx[k];
        rec[k] = live ? (leaf ? root : r) : rec[k];
        cnt[k] += leaf;
      }
    }
#pragma unroll
    for (int k = 0; k < kBuildIlp; ++k) {
      const int c = c0 + k * kWalkThreads;
      if (c < (1 << kPeekBits))
        tab[c] = used[k] ? make_uint2(syms[k], cnt[k] | meta[k] | (used[k] << 20))
                         : make_uint2(idx[k], 0u);
    }
  }
}

// Decode the stream that owns bits [pos, end) of the staged payload (n_words
// words; reads clamp to the last) into row[0 .. L): the tree walk's codes,
// row zeroed beforehand (columns the walk never reaches stay 0).  A probe
// reads the root-table entry of the kPeekBits bits at pos and writes its
// whole codewords; after a leaf the walk is at the root, so the next probe
// starts at the last leaf's end.  The walk stops at the budget end or once
// L codes are written.  The hot path takes a probe that ends a codeword
// with the budget at least a peek away: the window (three words in
// registers, the third loaded a probe ahead) moves by selects, and the next
// probe's read is issued before this probe's stores.  The slow path takes
// the rest and reloads the window: a probe the budget may end inside (a
// symbol whose last bit passes end is written as 0), and a peek with no
// return to the root (a code longer than the peek, or a tree that is not
// complete), from whose node the walk goes on a bit a step to the next leaf
// or return to the root.  row needs kPeekSymbols - 1 bytes of room past L.
__device__ __forceinline__ void walk_decode_stream(const uint32_t* words, int n_words, int pos,
                                                   int end, const uint2* tab,
                                                   const uint32_t* nodes, int L,
                                                   uint8_t* row) {
  constexpr uint32_t kMask = (1u << kPeekBits) - 1u;
  const int last = n_words - 1;
  int w = pos >> 5, col = 0;
  uint32_t b = static_cast<uint32_t>(pos & 31);
  uint32_t lo = words[min(w, last)], hi = words[min(w + 1, last)], nx = words[min(w + 2, last)];
  uint2 e = tab[__funnelshift_r(lo, hi, b) & kMask];
  while (pos < end && col < L) {
    const uint32_t adv = e.y >> 20;  // <= kPeekBits < 32
    const int cnt = static_cast<int>(e.y & 7u);
    const bool cross = b + adv >= 32;
    const uint32_t nb = (b + adv) & 31u, nlo = cross ? hi : lo, nhi = cross ? nx : hi;
    const uint2 next = tab[__funnelshift_r(nlo, nhi, nb) & kMask];
    if (adv == 0 || end - pos < kPeekBits) {
      if (adv != 0) {
        uint32_t sym = e.x;
#pragma unroll
        for (int k = 0; k < kPeekSymbols; ++k)
          if (pos + static_cast<int>((e.y >> (4 + 4 * k)) & 15u) > end) sym &= ~(0xFFu << (8 * k));
#pragma unroll
        for (int k = 0; k < kPeekSymbols; ++k)
          if (k < cnt) row[col + k] = static_cast<uint8_t>(sym >> (8 * k));
        col += cnt;
        pos += static_cast<int>(adv);
      } else {
        if (end - pos <= kPeekBits) break;  // no leaf can end inside the budget
        uint32_t idx = e.x, rec = nodes[idx];
        int p = pos + kPeekBits;
        while (p < end) {
          idx = child_of(rec, (words[min(p >> 5, last)] >> (p & 31)) & 1u);
          rec = nodes[idx];
          ++p;
          if (rec & kLeafBit) {
            row[col++] = static_cast<uint8_t>(rec >> 24);
            break;
          }
          if (idx == 0) break;
        }
        pos = p;
      }
      w = pos >> 5;
      b = static_cast<uint32_t>(pos & 31);
      lo = words[min(w, last)];
      hi = words[min(w + 1, last)];
      nx = words[min(w + 2, last)];
      e = tab[__funnelshift_r(lo, hi, b) & kMask];
      continue;
    }
    b = nb;
    lo = nlo;
    hi = nhi;
    w += cross;
    nx = words[min(w + 2, last)];
#pragma unroll
    for (int k = 0; k < kPeekSymbols; ++k)
      if (k < cnt) row[col + k] = static_cast<uint8_t>(e.x >> (8 * k));
    col += cnt;
    pos += static_cast<int>(adv);
    e = next;
  }
}

// Copy nrows rows of width bytes (stride bytes apart in shared memory, each
// 4-byte aligned) to consecutive rows of out: 16 bytes a store where width
// is a multiple of 16, else 4, else 1.
__device__ __forceinline__ void copy_rows_out(const uint8_t* rows, int stride, int nrows,
                                              int width, uint8_t* out) {
  if (width % 4 != 0) {
    for (int i = threadIdx.x; i < nrows * width; i += blockDim.x) {
      const int r = i / width;
      out[i] = rows[r * stride + (i - r * width)];
    }
    return;
  }
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rows);
  const int vec = width % 16 == 0 ? 4 : 1, per_row = width / (4 * vec);
  const float r_per_row = 1.f / static_cast<float>(per_row);
  for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
    const int r = div_small(i, per_row, r_per_row), c = i - r * per_row;
    const uint32_t* src = rw + r * (stride / 4) + c * vec;
    uint8_t* dst = out + r * width + 4 * vec * c;
    if (vec == 4) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(src[0], src[1], src[2], src[3]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = src[0];
    }
  }
}

// The score of one code row (L4 codes, the factors kmn * q at kq and kst * q
// at g, zero past L): fma(c, kst q, kmn q) summed in a running float32 sum
// for each column mod 4, then ((s0 + s1) + (s2 + s3)).
__device__ __forceinline__ float row_score(const uint8_t* row, const float* kq, const float* g,
                                           int L4) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < L4 / 4; ++i) {
    const uint32_t c = reinterpret_cast<const uint32_t*>(row)[i];
    const float4 k = reinterpret_cast<const float4*>(kq)[i];
    const float4 s = reinterpret_cast<const float4*>(g)[i];
    acc[0] += fmaf(static_cast<float>(c & 0xFFu), s.x, k.x);
    acc[1] += fmaf(static_cast<float>((c >> 8) & 0xFFu), s.y, k.y);
    acc[2] += fmaf(static_cast<float>((c >> 16) & 0xFFu), s.z, k.z);
    acc[3] += fmaf(static_cast<float>(c >> 24), s.w, k.w);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// A walk CTA (kWalkThreads threads): blocks b0 .. b0 + kWalkBlocksPerCta - 1,
// Tb threads each (S rounded up to whole warps, at most kWalkThreads /
// kWalkBlocksPerCta), thread t of a block decoding its streams t, t + Tb, ...
// The CTA's other threads help stage, build the root table and copy the
// codes out.
template <bool kScores>
__device__ __forceinline__ void walk_cta(const WalkArgs& a, const float* k_min,
                                         const float* k_step, const float* q, float scale,
                                         uint8_t* codes, float* scores) {
  extern __shared__ __align__(16) uint8_t sm[];
  if (a.S == 0) return;
  const WalkSmem m = walk_smem(a.W, a.S, a.L, a.n_nodes, kScores);
  const int b0 = blockIdx.x * kWalkBlocksPerCta, nblk = min(kWalkBlocksPerCta, a.NBLK - b0);
  uint2* tab = reinterpret_cast<uint2*>(sm);
  uint32_t* nodes = reinterpret_cast<uint32_t*>(sm + m.nodes);
  uint8_t* rows = sm + m.rows;

  // Every read of device memory is a 16-byte copy, all in flight at once:
  // the tree tables (and q, k_min, k_step) first, then the blocks' payload
  // and bit counts; the rows are zeroed meanwhile.  The node records, the
  // score factors and the root table are made while the payload arrives.
  stage_run(sm + m.ch, a.children, 8 * a.n_nodes, kWalkThreads);
  stage_run(sm + m.isym, a.is_symbol, 4 * a.n_nodes, kWalkThreads);
  stage_run(sm + m.sym, a.symbols, 4 * a.n_nodes, kWalkThreads);
  if constexpr (kScores) {
    stage_run(sm + m.q, q, 4 * a.L, kWalkThreads);
    for (int j = 0; j < nblk; ++j) {
      uint8_t* st = sm + m.block + j * m.per_block;
      stage_run(st + m.kmn, k_min + static_cast<size_t>(b0 + j) * a.L, 4 * a.L, kWalkThreads);
      stage_run(st + m.kst, k_step + static_cast<size_t>(b0 + j) * a.L, 4 * a.L, kWalkThreads);
    }
  }
  cp_async_commit();
  for (int j = 0; j < nblk; ++j) {
    uint8_t* st = sm + m.block + j * m.per_block;
    stage_run(st, a.payload + static_cast<size_t>(b0 + j) * a.W, 4 * a.W, kWalkThreads);
    stage_run(st + m.nb, a.nbits + static_cast<size_t>(b0 + j) * a.S, 4 * a.S, kWalkThreads);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < (m.ch - m.rows) / 16; i += kWalkThreads)
    reinterpret_cast<uint4*>(rows)[i] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<1>();
  __syncthreads();

  const int2* ch = landed<int2>(sm + m.ch, a.children);
  const int* isym = landed<int>(sm + m.isym, a.is_symbol);
  const int* sym = landed<int>(sm + m.sym, a.symbols);
  const uint32_t top = static_cast<uint32_t>(a.n_nodes - 1);
  for (int i = threadIdx.x; i < a.n_nodes; i += kWalkThreads) {
    const int2 c = ch[i];
    nodes[i] = min(static_cast<uint32_t>(c.x), top) | (min(static_cast<uint32_t>(c.y), top) << 9) |
               (isym[i] ? kLeafBit : 0u) | (static_cast<uint32_t>(sym[i]) << 24);
  }
  if constexpr (kScores) {
    const int L4 = (a.L + 3) / 4 * 4;
    const float* qs = landed<float>(sm + m.q, q);
    for (int i = threadIdx.x; i < nblk * L4; i += kWalkThreads) {
      const int j = i / L4, d = i - j * L4;
      const size_t at = static_cast<size_t>(b0 + j) * a.L;
      uint8_t* st = sm + m.block + j * m.per_block;
      float* f = reinterpret_cast<float*>(st + m.fac);
      const bool in = d < a.L;
      f[d] = in ? landed<float>(st + m.kmn, k_min + at)[d] * qs[d] : 0.f;
      f[L4 + d] = in ? landed<float>(st + m.kst, k_step + at)[d] * qs[d] : 0.f;
    }
  }
  __syncthreads();
  build_root_table(nodes, tab);
  cp_async_wait<0>();
  __syncthreads();

  const int Tb = min((a.S + 31) / 32 * 32, kWalkThreads / kWalkBlocksPerCta);
  const int j = threadIdx.x / Tb, t = threadIdx.x - j * Tb;
  if (j < nblk) {  // whole warps
    const uint8_t* st = sm + m.block + j * m.per_block;
    const uint32_t* words = landed<uint32_t>(st, a.payload + static_cast<size_t>(b0 + j) * a.W);
    const int* nb = landed<int>(st + m.nb, a.nbits + static_cast<size_t>(b0 + j) * a.S);
    for (int s0 = 0; s0 < a.S; s0 += Tb) {
      const int s = s0 + t;
      const int pos = huff::stream_start_warp_by([nb](int i) { return nb[i]; }, s, a.S);
      if (s < a.S) {
        uint8_t* row = rows + (j * a.S + s) * m.rs;
        walk_decode_stream(words, a.W, pos, pos + min(nb[s], a.max_bits), tab, nodes, a.L, row);
        if constexpr (kScores) {
          const int L4 = (a.L + 3) / 4 * 4;
          const float* kq = reinterpret_cast<const float*>(st + m.fac);
          scores[static_cast<size_t>(b0 + j) * a.S + s] = row_score(row, kq, kq + L4, L4) * scale;
        }
      }
    }
  }
  if constexpr (!kScores) {
    __syncthreads();
    copy_rows_out(rows, m.rs, nblk * a.S, a.L, codes + static_cast<size_t>(b0) * a.S * a.L);
  }
}

__global__ void __launch_bounds__(kWalkThreads) huffman_decode_kernel(WalkArgs a, uint8_t* out) {
  walk_cta<false>(a, nullptr, nullptr, nullptr, 0.f, out, nullptr);
}

__global__ void __launch_bounds__(kWalkThreads)
    huffman_attn_scores_kernel(WalkArgs a, const float* k_min, const float* k_step,
                               const float* q, float scale, float* out) {
  walk_cta<true>(a, k_min, k_step, q, scale, nullptr, out);
}

// ---- The slot LUT decode ---------------------------------------------------

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

  // Copy-out, row-major; the two slots' rows are consecutive in the output,
  // as in shared memory.
  copy_rows_out(rows, DP, nslots * T, D, a.out + static_cast<size_t>(n0) * T * D);
}

template <typename Kernel>
int set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// A walk kernel's launch: kWalkBlocksPerCta blocks a CTA of kWalkThreads.
template <typename Kernel, typename... Rest>
int walk_launch(Kernel* kernel, bool scores, const void* payload, const void* nbits,
                const void* children, const void* is_symbol, const void* symbols, int NBLK,
                int W, int S, int L, int n_nodes, int max_bits, void* stream, Rest... rest) {
  const WalkArgs a{static_cast<const uint32_t*>(payload), static_cast<const int*>(nbits),
                   static_cast<const int*>(children), static_cast<const int*>(is_symbol),
                   static_cast<const int*>(symbols), NBLK, W, S, L, n_nodes, max_bits};
  const int smem = walk_smem(W, S, L, n_nodes, scores).total;
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<(NBLK + kWalkBlocksPerCta - 1) / kWalkBlocksPerCta, kWalkThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a, rest...);
  return static_cast<int>(cudaGetLastError());
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
  return walk_launch(huffman_decode_kernel, false, payload, nbits, children, is_symbol, symbols,
                     NBLK, W, S, L, n_nodes, max_bits, stream, static_cast<uint8_t*>(out));
}

int huffman_attn_scores_launch(const void* payload, const void* nbits, const void* children,
                               const void* is_symbol, const void* symbols, const void* k_min,
                               const void* k_step, const void* q, void* out, int NBLK, int W,
                               int S, int L, int n_nodes, int max_bits, float scale,
                               void* stream) {
  return walk_launch(huffman_attn_scores_kernel, true, payload, nbits, children, is_symbol,
                     symbols, NBLK, W, S, L, n_nodes, max_bits, stream,
                     static_cast<const float*>(k_min), static_cast<const float*>(k_step),
                     static_cast<const float*>(q), scale, static_cast<float*>(out));
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
