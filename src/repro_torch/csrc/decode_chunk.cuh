// The GPULZ decode chain of one chunk, shared by the split decoder
// (lz_decode.cu) and the one-launch decoder (lz_decode_mono.cu), with the
// math of src/repro/kernels/lz_decode.py:_decode_values:
//
//   * tokens are taken tile by tile (one per thread, blockDim per tile);
//     each reads its flag bit, a block scan of read sizes [2 | S] gives its
//     payload offset, and it reads its length / offset / literal there;
//   * a second block scan, of output lengths, gives its write position;
//   * a literal writes its symbol to the output at once; a pointer writes,
//     for every output position it covers, the position its symbol is
//     copied from (w - offset) into a u16 row in shared memory, so the
//     covering token of each output symbol is never searched for;
//   * ceil(log2 C) pointer-doubling rounds over that row, in two shared
//     buffers with __syncthreads() between rounds, take every position to
//     the literal it descends from.  This is valid because length <=
//     offset, so every source lies before its copy;
//   * each copied position then reads its symbol from the output.
//
// The chain zero-fills the chunk's output first, so a corrupt container
// whose copy chain ends at a pointer decodes to zeros there, as the
// reference's lit = 0 for pointer tokens does.  The chunk's sections are
// read through an accessor: ``flag(j)`` is flag byte j (j < C / 8) and
// ``pay(k)`` payload byte k (0 <= k < C * S), each 0 where the section
// holds no such byte.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace gplz {

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// ceil(log2 C), at least 1: the pointer-doubling rounds a chunk needs.
inline int doubling_rounds(int C) {
  int rounds = 0;
  while ((1 << rounds) < C) ++rounds;
  return rounds < 1 ? 1 : rounds;
}

// Decode ``ntok`` tokens (already clamped to [0, C]) of one chunk into
// ``o`` (C int32).  ``src`` / ``nxt`` are two C-entry u16 rows of shared
// memory and ``warp_sums`` the block scan's 32 shared ints.  Every thread
// of the block calls it.
template <typename Sections>
__device__ void decode_chunk(const Sections& sec, int ntok, int C, int S, int rounds,
                             uint16_t* src, uint16_t* nxt, int* warp_sums,
                             int32_t* __restrict__ o) {
  for (int w = threadIdx.x; w < C; w += blockDim.x) {
    src[w] = static_cast<uint16_t>(w);
    o[w] = 0;
  }
  __syncthreads();

  const int ps = C * S;
  int rcarry = 0, wcarry = 0;
  for (int tile = 0; tile < ntok; tile += blockDim.x) {
    const int t = tile + threadIdx.x;
    const bool active = t < ntok;
    const int f = active ? (sec.flag(t >> 3) >> (t & 7)) & 1 : 0;
    int total;
    const int roff = rcarry + block_excl_scan(active ? (f ? 2 : S) : 0, &total, warp_sums);
    rcarry += total;
    int ln = 0, off = 0;
    uint32_t lit = 0;
    if (active) {
      if (f) {
        ln = sec.pay(clampi(roff, 0, ps - 1));
        off = sec.pay(clampi(roff + 1, 0, ps - 1));
      } else {
        ln = 1;
        for (int b = 0; b < S; ++b)
          lit |= static_cast<uint32_t>(sec.pay(clampi(roff + b, 0, ps - 1))) << (8 * b);
      }
    }
    const int wpos = wcarry + block_excl_scan(ln, &total, warp_sums);
    wcarry += total;
    if (ln > 0 && wpos < C) {
      if (f) {
        const int end = min(wpos + ln, C);
        for (int w = wpos; w < end; ++w) src[w] = static_cast<uint16_t>(max(w - off, 0));
      } else {
        o[wpos] = static_cast<int32_t>(lit);
      }
    }
  }
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    for (int w = threadIdx.x; w < C; w += blockDim.x) nxt[w] = src[src[w]];
    __syncthreads();
    uint16_t* tmp = src;
    src = nxt;
    nxt = tmp;
  }
  // literal writes above and these reads are ordered by the barrier
  for (int w = threadIdx.x; w < C; w += blockDim.x) {
    const int s = src[w];
    if (s != w) o[w] = o[s];
  }
}

}  // namespace gplz
