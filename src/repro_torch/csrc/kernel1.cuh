// GPULZ Kernel I's per-chunk steps, shared by the three kernels that walk
// the window: Kernel I (lz_match.cu: kernel1), the match-only kernel
// (lz_match.cu: match_only) and the one-launch compressor (lz_fused.cu).
//
// One thread block works on one chunk held in shared memory:
//
//   * load_chunk     the chunk's int32 symbols into a Sym row (S bytes each);
//   * walk_chunk     every position's longest match, warp by warp (below);
//   * select_tokens  the paper's encode thread: one thread walks the lengths
//                    and marks the positions that start a token;
//   * token_size     a position's payload bytes: 2 for a pointer, S for a
//                    literal, 0 where no token starts.
//
// The window walk.  It replaces a per-thread walk (the paper's CUDA shape,
// §3.3.2: each thread walked its own position's window far to near and
// extended each candidate run one symbol at a time), whose lanes extended
// runs of different lengths and so diverged: a warp ran as long as its
// longest run.  It takes the TPU package's order instead
// (src/repro/core/match.py: offsets in lockstep, equality rows, run lengths
// read off the rows):
//
//   * a warp owns two words of 32 consecutive positions, p .. p+63; lane l
//     holds the positions q = p + 31 - l and q + 32 (reversed, so that a
//     run is a count of leading zeros), and the warp walks the offsets
//     d = min(p + 63, W) .. 1 together;
//   * at each d every lane makes three compares from shared memory, for
//     q, q + 32 and q + 64, and three __ballot_sync pack them into the
//     inequality words of positions p .. p+95.  A funnel shift gives each
//     of a lane's two positions the 32 positions from it, and one bit scan
//     (bfind) its run.  Only runs of 32 or more read on, in a warp-uniform
//     branch (a vote) that compares further words while any lane needs
//     them, at most ceil(255 / 32) words;
//   * the best candidate is the maximum of the key (len << 8) + d, with
//     len = min(run, d, 255, C - i): a longer match wins and a tie keeps
//     the larger offset, the reference's key len * (W + 1) + d.  While
//     d >= 32 a run under 32 cannot reach its cap d, so the key needs no
//     min there;
//   * the warp stops when no position's cap min(d, 255, C - i) exceeds its
//     best length.  Caps only shrink as d falls, so a nearer offset could
//     neither win nor tie: the stop is exact.  It is tested every 4 offsets.
//
// No branch diverges: every lane runs the same instructions, and the read-on
// and the stop are decided by warp votes.  What bounds the walk on the H100
// is the issue rate of the integer pipe: about 16 warp instructions per
// offset for 64 positions (3 loads, 3 compares, 4 votes, 2 funnel shifts, 2
// bit scans, 2 keys, 2 maxima).  Measured on hurr-quant (C=2048, S=2,
// W=128), the match-only kernel took 11.3 ms with one word a warp and a
// read-on loop for the runs that reach the word's top (a third of all
// offsets), 6.3 ms with one word and the next word's compare in place of
// that loop, and 5.6 ms with two words a warp, which share the middle
// ballot; testing a per-lane "need" mask in place of the bit scan gained
// nothing, because some lane improved at half the offsets.  Symbols are
// loaded through ld.shared into 32-bit registers: a 16-bit load in C++ is
// widened again (PRMT) before every compare.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gplz {

constexpr int kMaxLen = 255;
constexpr unsigned kFull = 0xffffffffu;

template <typename Sym>
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ src, int C, Sym* sym) {
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    sym[i] = static_cast<Sym>(static_cast<uint32_t>(src[i]));
}

// A symbol from shared memory, zero-extended into 32 bits (a plain load of
// a 16-bit value is widened again before every compare).
__device__ __forceinline__ uint32_t lds(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return v;
}
__device__ __forceinline__ uint32_t lds(const uint16_t* p) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return v;
}
__device__ __forceinline__ uint32_t lds(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return v;
}

// Index of the highest set bit, -1 for 0.
__device__ __forceinline__ int msb(uint32_t x) {
  int r;
  asm("bfind.u32 %0, %1;" : "=r"(r) : "r"(x));
  return r;
}

// Extends, at offset d, the runs of the lanes with ``more`` set through the
// words from base + 32 on (lane l compares base + 32 + 32j, where base =
// p + 31 - l for the word at p, so bit 31 of a ballot is the word's first
// position), until each reaches its cap or a differing position.
template <typename Sym>
__device__ __forceinline__ int extend_run(const Sym* sym, int base, int C, int d, int run, int cap,
                                          bool more) {
  for (int k = base + 32; __any_sync(kFull, more); k += 32) {
    const unsigned ne = __ballot_sync(kFull, !(k < C && lds(sym + k) == lds(sym + k - d)));
    if (more) {
      const int t = __clz(ne);
      run += t;
      more = t == 32 && run < cap;
    }
  }
  return min(run, cap);
}

// The key of a lane whose 32 positions from q are all equal at d (x == 0):
// the run read on through the next word (ne_next) and the words past it,
// capped; other lanes keep ``key``.
template <typename Sym>
__device__ __forceinline__ int long_key(const Sym* sym, int q, int C, int d, unsigned x,
                                        unsigned ne_next, int lane_cap, int best, int key) {
  const int sh = 31 - (threadIdx.x & 31);
  int run = 32 + __clz(__funnelshift_l(0x80000000u, ne_next, sh));
  const int cap = min(d, lane_cap);
  run = extend_run(sym, q + 32, C, d, run, cap,
                   x == 0 && run == 64 - sh && run < cap && cap > (best >> 8));
  return x == 0 ? (min(run, d) << 8) + d : key;
}

// One offset d for the warp's two words: lane l owns positions q and q + 32
// (q = p + 31 - l); ne0, ne1, ne2 are the equality words of positions p ..
// p + 95.  kFar: d >= 32, so a run shorter than 32 never reaches its cap d.
template <bool kEdge, bool kFar, typename Sym>
__device__ __forceinline__ void walk_offset(const Sym* sym, int q, int C, int d, uint32_t xq0,
                                            uint32_t xq1, uint32_t xq2, int cap0, int cap1,
                                            int& best0, int& best1) {
  const int sh = 31 - (threadIdx.x & 31);
  const uint32_t v0 = (!kEdge || (q < C && q >= d)) ? lds(sym + q - d) : ~xq0;
  const uint32_t v1 = (!kEdge || (q + 32 < C && q + 32 >= d)) ? lds(sym + q + 32 - d) : ~xq1;
  const uint32_t v2 = (!kEdge || q + 64 < C) ? lds(sym + q + 64 - d) : ~xq2;
  const unsigned ne0 = __ballot_sync(kFull, v0 != xq0);
  const unsigned ne1 = __ballot_sync(kFull, v1 != xq1);
  const unsigned ne2 = __ballot_sync(kFull, v2 != xq2);
  const unsigned x0 = __funnelshift_l(ne1, ne0, sh), x1 = __funnelshift_l(ne2, ne1, sh);
  int key0 = 7936 + d - 256 * msb(x0), key1 = 7936 + d - 256 * msb(x1);
  if (!kFar) {
    key0 = min(key0, 257 * d);
    key1 = min(key1, 257 * d);
  }
  if (__any_sync(kFull, x0 == 0 || x1 == 0)) {  // some run is 32 or longer: read on
    key0 = long_key(sym, q, C, d, x0, ne1, cap0, best0, key0);
    key1 = long_key(sym, q + 32, C, d, x1, ne2, cap1, best1, key1);
  }
  best0 = max(best0, key0);
  best1 = max(best1, key1);
}

// (length, offset) of the lane's positions q and q + 32 of the words at p;
// (0, 0) where no match exists or past C.  kEdge: the window reaches before
// the chunk (p < W) or the words past its end (p + 96 > C), so positions
// are checked.
template <bool kEdge, typename Sym>
__device__ __forceinline__ int4 walk_pair(const Sym* sym, int p, int C, int W) {
  const int q = p + 31 - (threadIdx.x & 31);
  const uint32_t xq0 = lds(sym + min(q, C - 1)), xq1 = lds(sym + min(q + 32, C - 1)),
                 xq2 = lds(sym + min(q + 64, C - 1));
  const int cap0 = min(kMaxLen, C - q), cap1 = min(kMaxLen, C - q - 32);
  int best0 = 0, best1 = 0;
  int d = min(p + 63, W);
  for (; d & 3; --d)
    walk_offset<kEdge, false>(sym, q, C, d, xq0, xq1, xq2, cap0, cap1, best0, best1);
  for (; d >= 36; d -= 4) {
    if (__all_sync(kFull, min(d, cap0) <= (best0 >> 8) && min(d, cap1) <= (best1 >> 8))) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      walk_offset<kEdge, true>(sym, q, C, d - j, xq0, xq1, xq2, cap0, cap1, best0, best1);
  }
  for (; d >= 4; d -= 4) {
    if (__all_sync(kFull, min(d, cap0) <= (best0 >> 8) && min(d, cap1) <= (best1 >> 8))) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      walk_offset<kEdge, false>(sym, q, C, d - j, xq0, xq1, xq2, cap0, cap1, best0, best1);
  }
  const int len0 = best0 >> 8, len1 = best1 >> 8;
  return make_int4(len0, len0 ? best0 & 0xff : 0, len1, len1 ? best1 & 0xff : 0);
}

// Every position's (length, offset) of the chunk in ``sym``: each warp of
// the block takes pairs of words in turn, and store(i, len, off) is called
// for each i < C.  blockDim.x must be a multiple of 32.
template <typename Sym, typename Store>
__device__ __forceinline__ void walk_chunk(const Sym* sym, int C, int W, Store store) {
  const int lane = threadIdx.x & 31;
  for (int p = 2 * (threadIdx.x - lane); p < C; p += 2 * blockDim.x) {
    const int4 r = (p < W || p + 96 > C) ? walk_pair<true>(sym, p, C, W)
                                         : walk_pair<false>(sym, p, C, W);
    if (p + 31 - lane < C) store(p + 31 - lane, r.x, r.y);
    if (p + 63 - lane < C) store(p + 63 - lane, r.z, r.w);
  }
}

// emit[i] = 1 where a token starts, else 0, from the chunk's lengths in
// ``slen``.  Every thread of the block calls it (it synchronises before and
// after the walk).
__device__ __forceinline__ void select_tokens(const uint8_t* slen, uint8_t* emit, int C,
                                              int min_match) {
  for (int i = threadIdx.x; i < C; i += blockDim.x) emit[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int pos = 0;
    while (pos < C) {
      emit[pos] = 1;
      const int l = slen[pos];
      pos += l >= min_match ? l : 1;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int token_size(int emitted, int len, int min_match, int S) {
  return emitted ? (len >= min_match ? 2 : S) : 0;
}

}  // namespace gplz
