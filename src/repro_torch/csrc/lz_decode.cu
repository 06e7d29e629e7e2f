// GPULZ decoder for Hopper: per-chunk aligned flag/payload sections ->
// symbols, one thread block per chunk.
//
// Replaces src/repro/kernels/lz_decode.py:_decode_kernel (launched by
// lz_decode_pallas), with the math of its _decode_values:
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
// The output is zero-filled by the wrapper, so a corrupt container whose
// copy chain ends at a pointer decodes to zeros there, as the reference's
// lit = 0 for pointer tokens does.  Reads of the payload row are clipped
// to it.  Bound on the H100: the bytes moved (the compact sections in, 4
// bytes out per symbol); the doubling rounds stay in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__global__ void __launch_bounds__(kThreads)
decode(const uint8_t* __restrict__ flag_bytes, const uint8_t* __restrict__ payload,
       const int32_t* __restrict__ n_tokens, int C, int S, int rounds,
       int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  uint16_t* src = reinterpret_cast<uint16_t*>(smem);
  uint16_t* nxt = src + C;
  const long long chunk = blockIdx.x;
  const int ps = C * S;
  const uint8_t* fb = flag_bytes + chunk * (C / 8);
  const uint8_t* pay = payload + chunk * ps;
  int32_t* o = out + chunk * C;
  const int ntok = clampi(n_tokens[chunk], 0, C);

  for (int w = threadIdx.x; w < C; w += blockDim.x) src[w] = static_cast<uint16_t>(w);
  __syncthreads();

  int rcarry = 0, wcarry = 0;
  for (int tile = 0; tile < ntok; tile += blockDim.x) {
    const int t = tile + threadIdx.x;
    const bool active = t < ntok;
    const int f = active ? (fb[t >> 3] >> (t & 7)) & 1 : 0;
    int total;
    const int roff = rcarry + block_excl_scan(active ? (f ? 2 : S) : 0, &total, warp_sums);
    rcarry += total;
    int ln = 0, off = 0;
    uint32_t lit = 0;
    if (active) {
      if (f) {
        ln = pay[clampi(roff, 0, ps - 1)];
        off = pay[clampi(roff + 1, 0, ps - 1)];
      } else {
        ln = 1;
        for (int b = 0; b < S; ++b) lit |= static_cast<uint32_t>(pay[clampi(roff + b, 0, ps - 1)]) << (8 * b);
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

}  // namespace

// flag_bytes (nc, C/8) uint8, payload (nc, C*S) uint8, n_tokens (nc,) int32
// -> out (nc, C) int32, which the caller has zero-filled.
extern "C" int lz_decode_launch(const void* flag_bytes, const void* payload, const void* n_tokens,
                                int nc, int C, int S, void* out, void* stream) {
  const size_t smem = 4 * static_cast<size_t>(C);
  cudaError_t err = allow_smem(decode, smem);
  if (err != cudaSuccess) return err;
  int rounds = 0;
  while ((1 << rounds) < C) ++rounds;
  if (rounds < 1) rounds = 1;
  decode<<<nc, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flag_bytes), static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(n_tokens), C, S, rounds, static_cast<int32_t*>(out));
  return cudaGetLastError();
}
