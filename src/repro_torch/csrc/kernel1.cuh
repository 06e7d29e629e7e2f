// GPULZ Kernel I's per-chunk steps, shared by the three kernels that walk
// the window: Kernel I (lz_match.cu: kernel1), the match-only kernel
// (lz_match.cu: match_only) and the one-launch compressor (lz_fused.cu).
//
// One thread block works on one chunk held in shared memory (the paper's
// CUDA shape, §3.3.2):
//
//   * load_chunk     the chunk's int32 symbols into a Sym row (S bytes each);
//   * best_match     one position's far-to-near window walk (d = min(i, W)
//                    .. 1).  A candidate at offset d is capped at
//                    min(d, 255, C - i), a cap that shrinks with d, so the
//                    walk stops as soon as the best length reaches it; strict
//                    improvement keeps ties at the larger offset, which is
//                    the reference's key max(len * (W + 1) + d);
//   * select_tokens  the paper's encode thread: one thread walks the lengths
//                    and marks the positions that start a token;
//   * token_size     a position's payload bytes: 2 for a pointer, S for a
//                    literal, 0 where no token starts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gplz {

constexpr int kMaxLen = 255;

template <typename Sym>
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ src, int C, Sym* sym) {
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    sym[i] = static_cast<Sym>(static_cast<uint32_t>(src[i]));
}

// (length, offset) of the longest match for position i of the chunk in
// ``sym``; (0, 0) where none exists.
template <typename Sym>
__device__ __forceinline__ int2 best_match(const Sym* sym, int i, int C, int W) {
  const int rem = C - i;
  const Sym xi = sym[i];
  int best_len = 0, best_off = 0;
  for (int d = min(i, W); d >= 1; --d) {
    const int cap = min(min(d, kMaxLen), rem);
    if (cap <= best_len) break;
    if (sym[i - d] != xi) continue;
    int l = 1;
    while (l < cap && sym[i + l] == sym[i - d + l]) ++l;
    if (l > best_len) {
      best_len = l;
      best_off = d;
    }
  }
  return make_int2(best_len, best_off);
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
