// GPULZ Kernel I for Hopper: matching, greedy token selection and the
// in-chunk (local) prefix sum of token sizes, one thread block per chunk.
//
// Replaces the TPU kernel src/repro/kernels/lz_match.py:_fused_kernel
// (launched by lz_kernel1_pallas).  The TPU layout (chunks on sublanes,
// lane rolls, capped run-length doubling over whole rows) is not carried
// over; this is the paper's own CUDA shape (§3.3.2):
//
//   * the chunk's symbols sit in shared memory at S bytes each, and one
//     length byte and one offset byte per position beside them, so
//     C * (S + 2) bytes fit in a block's 227 KB at every C the port
//     accepts (core/autotune.py);
//   * each thread takes positions i, i + blockDim, ... and walks the window
//     far to near (d = min(i, W) .. 1) comparing symbols directly.  A
//     candidate at offset d is capped at min(d, 255, C - i), a cap that
//     shrinks with d, so the walk stops as soon as the best length reaches
//     it; strict improvement keeps ties at the larger offset, which is the
//     reference's key max(len * (W + 1) + d);
//   * one thread walks the lengths to select tokens (the paper's encode
//     thread); the emitted flags reuse the symbol bytes, which are dead by
//     then;
//   * the block scans token sizes tile by tile for local_off, and sums
//     them for payload_sizes and n_tokens.
//
// Bound on the H100: integer compares in the window walk, at most
// min(i, W) candidate offsets per position plus the run lengths of the
// matches found; the bytes moved (4 bytes in, 13 out per position) are
// small beside them at W = 128.  The early exit makes runs of equal
// symbols cheap (the first, farthest offset already reaches the cap).

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLen = 255;

template <typename Sym>
__global__ void __launch_bounds__(kThreads)
kernel1(const int32_t* __restrict__ symbols, int C, int W, int min_match, int S,
        int32_t* __restrict__ lengths, int32_t* __restrict__ offsets,
        uint8_t* __restrict__ emitted, int32_t* __restrict__ local_off,
        int32_t* __restrict__ payload_sizes, int32_t* __restrict__ n_tokens) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  Sym* sym = reinterpret_cast<Sym*>(smem);
  uint8_t* slen = smem + static_cast<size_t>(C) * sizeof(Sym);
  uint8_t* soff = slen + C;
  const long long base = static_cast<long long>(blockIdx.x) * C;

  for (int i = threadIdx.x; i < C; i += blockDim.x)
    sym[i] = static_cast<Sym>(static_cast<uint32_t>(symbols[base + i]));
  __syncthreads();

  for (int i = threadIdx.x; i < C; i += blockDim.x) {
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
    slen[i] = static_cast<uint8_t>(best_len);
    soff[i] = static_cast<uint8_t>(best_off);
    lengths[base + i] = best_len;
    offsets[base + i] = best_off;
  }
  __syncthreads();

  uint8_t* emit = smem;  // the symbols are dead: reuse their first C bytes
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

  int carry = 0, toks = 0;
  for (int tile = 0; tile < C; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const int e = i < C ? emit[i] : 0;
    const int size = e ? (slen[i] >= min_match ? 2 : S) : 0;
    int total;
    const int excl = carry + block_excl_scan(size, &total, warp_sums);
    if (i < C) {
      local_off[base + i] = excl;
      emitted[base + i] = static_cast<uint8_t>(e);
    }
    toks += e;
    carry += total;
  }
  int n;
  block_excl_scan(toks, &n, warp_sums);
  if (threadIdx.x == 0) {
    payload_sizes[blockIdx.x] = carry;
    n_tokens[blockIdx.x] = n;
  }
}

template <typename Sym>
cudaError_t launch(const void* symbols, int nc, int C, int S, int W, int min_match,
                   void* lengths, void* offsets, void* emitted, void* local_off,
                   void* payload_sizes, void* n_tokens, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(C) * (sizeof(Sym) + 2);
  cudaError_t err = allow_smem(kernel1<Sym>, smem);
  if (err != cudaSuccess) return err;
  kernel1<Sym><<<nc, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(symbols), C, W, min_match, S,
      static_cast<int32_t*>(lengths), static_cast<int32_t*>(offsets),
      static_cast<uint8_t*>(emitted), static_cast<int32_t*>(local_off),
      static_cast<int32_t*>(payload_sizes), static_cast<int32_t*>(n_tokens));
  return cudaGetLastError();
}

}  // namespace

// (nc, C) int32 symbols -> lengths, offsets, local_off (nc, C) int32,
// emitted (nc, C) uint8, payload_sizes, n_tokens (nc,) int32.
// Returns a cudaError_t code (0 on success).
extern "C" int lz_kernel1_launch(const void* symbols, int nc, int C, int S, int W,
                                 int min_match, void* lengths, void* offsets,
                                 void* emitted, void* local_off, void* payload_sizes,
                                 void* n_tokens, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return launch<uint8_t>(symbols, nc, C, S, W, min_match, lengths, offsets,
                             emitted, local_off, payload_sizes, n_tokens, st);
    case 2:
      return launch<uint16_t>(symbols, nc, C, S, W, min_match, lengths, offsets,
                              emitted, local_off, payload_sizes, n_tokens, st);
    case 4:
      return launch<uint32_t>(symbols, nc, C, S, W, min_match, lengths, offsets,
                              emitted, local_off, payload_sizes, n_tokens, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
