// GPULZ Kernel I for Hopper: matching, greedy token selection and the
// in-chunk (local) prefix sum of token sizes, one thread block per chunk;
// and the match-only kernel, the window walk alone.
//
// Kernel I replaces the TPU kernel src/repro/kernels/lz_match.py:_fused_kernel
// (launched by lz_kernel1_pallas); the match-only kernel replaces
// src/repro/kernels/lz_match.py:_match_kernel (launched by lz_match_pallas).
// The TPU layout (chunks on sublanes, lane rolls, capped run-length
// doubling over whole rows) is not carried over, but its order is: offsets
// in lockstep.  The per-chunk steps are in kernel1.cuh:
//
//   * the chunk's symbols sit in shared memory at S bytes each, and one
//     length byte and one offset byte per position beside them, so
//     C * (S + 2) bytes fit in a block's 227 KB at every C the port
//     accepts (core/autotune.py);
//   * each warp takes 64 consecutive positions and walks the window for all
//     of them at once, one offset at a time, three ballots per offset
//     (gplz::walk_chunk); it replaces a per-thread walk whose lanes
//     diverged on runs of different lengths;
//   * one thread walks the lengths to select tokens (the paper's encode
//     thread); the emitted flags reuse the symbol bytes, which are dead by
//     then.  It costs Kernel I 0.26 ms over the match-only kernel at 128 MiB
//     of hurr-quant, under 5% of it, so it stays serial;
//   * the block scans token sizes tile by tile for local_off, and sums
//     them for payload_sizes and n_tokens.
//
// Bound on the H100, both kernels: the issue rate of the walk's integer
// instructions, about 16 warp instructions per offset for 64 positions, at
// most min(p + 63, W) offsets; the bytes moved (4 bytes in, 13 out per
// position for Kernel I, 8 for the match-only kernel) are small beside them
// at W = 128.  The early stop makes runs of equal symbols cheap: the first,
// farthest offset already reaches every cap.  Kernel I is held to 32
// registers so that 8 blocks of 256 threads stay resident on an SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "kernel1.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Sym>
__global__ void __launch_bounds__(kThreads, 8)
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

  gplz::load_chunk(symbols + base, C, sym);
  __syncthreads();

  gplz::walk_chunk(sym, C, W, [&](int i, int len, int off) {
    slen[i] = static_cast<uint8_t>(len);
    soff[i] = static_cast<uint8_t>(off);
    lengths[base + i] = len;
    offsets[base + i] = off;
  });
  __syncthreads();

  uint8_t* emit = smem;  // the symbols are dead: reuse their first C bytes
  gplz::select_tokens(slen, emit, C, min_match);

  int carry = 0, toks = 0;
  for (int tile = 0; tile < C; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const int e = i < C ? emit[i] : 0;
    const int size = gplz::token_size(e, e ? slen[i] : 0, min_match, S);
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

// The window walk alone: lengths and offsets of every position.
template <typename Sym>
__global__ void __launch_bounds__(kThreads)
match_only(const int32_t* __restrict__ symbols, int C, int W, int32_t* __restrict__ lengths,
           int32_t* __restrict__ offsets) {
  extern __shared__ __align__(16) unsigned char smem[];
  Sym* sym = reinterpret_cast<Sym*>(smem);
  const long long base = static_cast<long long>(blockIdx.x) * C;
  gplz::load_chunk(symbols + base, C, sym);
  __syncthreads();
  gplz::walk_chunk(sym, C, W, [&](int i, int len, int off) {
    lengths[base + i] = len;
    offsets[base + i] = off;
  });
}

template <typename Sym>
size_t kernel1_smem(int C) {
  return static_cast<size_t>(C) * (sizeof(Sym) + 2);
}

template <typename Sym>
cudaError_t launch(const void* symbols, int nc, int C, int S, int W, int min_match,
                   void* lengths, void* offsets, void* emitted, void* local_off,
                   void* payload_sizes, void* n_tokens, cudaStream_t stream) {
  const size_t smem = kernel1_smem<Sym>(C);
  cudaError_t err = allow_smem(kernel1<Sym>, smem);
  if (err != cudaSuccess) return err;
  kernel1<Sym><<<nc, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(symbols), C, W, min_match, S,
      static_cast<int32_t*>(lengths), static_cast<int32_t*>(offsets),
      static_cast<uint8_t*>(emitted), static_cast<int32_t*>(local_off),
      static_cast<int32_t*>(payload_sizes), static_cast<int32_t*>(n_tokens));
  return cudaGetLastError();
}

template <typename Sym>
cudaError_t occupancy(int C, int* out) {
  cudaError_t err = kernel_occupancy(kernel1<Sym>, kThreads, kernel1_smem<Sym>(C), out, out + 1);
  if (err != cudaSuccess) return err;
  return kernel_occupancy(match_only<Sym>, kThreads, static_cast<size_t>(C) * sizeof(Sym),
                          out + 2, out + 3);
}

template <typename Sym>
cudaError_t launch_match(const void* symbols, int nc, int C, int W, void* lengths,
                         void* offsets, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(C) * sizeof(Sym);
  cudaError_t err = allow_smem(match_only<Sym>, smem);
  if (err != cudaSuccess) return err;
  match_only<Sym><<<nc, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(symbols), C, W, static_cast<int32_t*>(lengths),
      static_cast<int32_t*>(offsets));
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

// (nc, C) int32 symbols -> lengths, offsets (nc, C) int32.
// Returns a cudaError_t code (0 on success).
extern "C" int lz_match_launch(const void* symbols, int nc, int C, int S, int W, void* lengths,
                               void* offsets, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return launch_match<uint8_t>(symbols, nc, C, W, lengths, offsets, st);
    case 2:
      return launch_match<uint16_t>(symbols, nc, C, W, lengths, offsets, st);
    case 4:
      return launch_match<uint32_t>(symbols, nc, C, W, lengths, offsets, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0..3] = registers a thread and resident blocks per SM of Kernel I,
// then of the match-only kernel, at symbol size S and chunk C.
// Returns a cudaError_t code (0 on success).
extern "C" int lz_match_occupancy(int S, int C, void* out) {
  int* o = static_cast<int*>(out);
  switch (S) {
    case 1:
      return occupancy<uint8_t>(C, o);
    case 2:
      return occupancy<uint16_t>(C, o);
    case 4:
      return occupancy<uint32_t>(C, o);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
