// GPULZ Kernels II and III for Hopper: the global prefix sums and the
// deflate-scatter that writes each chunk's compact bytes into the container.
//
// Kernel II replaces src/repro/kernels/lz_scatter.py:_offsets_kernel
// (launched by lz_global_offsets_pallas).  One thread block per buffer
// walks the nc per-chunk sizes in tiles of blockDim with a running carry:
// first the flag sizes ceil(n_tokens / 8), then the payload sizes, whose
// offsets come out pre-based by the flag total exactly as the TPU kernel's
// do.  Bound on the H100: the 16 bytes per chunk it moves; a single block
// cannot reach the card's memory rate, but nc is small (32,768 at 128 MiB).
//
// Kernel III replaces src/repro/kernels/lz_scatter.py:_scatter_kernel
// (launched by lz_scatter_pallas).  The TPU kernel rebuilt whole sections
// in VMEM with binary searches because Mosaic has no scatter; here one
// thread block per chunk takes positions tile by tile, ranks each emitted
// token with a block scan, sets its flag bit in shared memory (atomicOr on
// the word holding bit rank % 8 of byte rank / 8) and writes its payload
// bytes straight to sec_flags + pay_off[c] + local_off[i].  Chunks write
// disjoint ranges, so blocks never race.  Bound on the H100: the bytes it
// moves, 13 read per position plus the container written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kOffsetThreads = 1024;
constexpr int kScatterThreads = 256;

__global__ void __launch_bounds__(kOffsetThreads)
global_offsets(const int32_t* __restrict__ n_tokens, const int32_t* __restrict__ payload_sizes,
               int nc, int32_t* __restrict__ flag_off, int32_t* __restrict__ pay_off,
               int32_t* __restrict__ totals) {
  __shared__ int warp_sums[32];
  const long long row = static_cast<long long>(blockIdx.x) * nc;
  int flag_total = 0;
  for (int tile = 0; tile < nc; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const int v = i < nc ? (n_tokens[row + i] + 7) / 8 : 0;
    int total;
    const int excl = flag_total + block_excl_scan(v, &total, warp_sums);
    if (i < nc) flag_off[row + i] = excl;
    flag_total += total;
  }
  int pay_total = 0;
  for (int tile = 0; tile < nc; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const int v = i < nc ? payload_sizes[row + i] : 0;
    int total;
    const int excl = pay_total + block_excl_scan(v, &total, warp_sums);
    if (i < nc) pay_off[row + i] = flag_total + excl;
    pay_total += total;
  }
  if (threadIdx.x == 0) {
    totals[2 * blockIdx.x] = flag_total;
    totals[2 * blockIdx.x + 1] = pay_total;
  }
}

__global__ void __launch_bounds__(kScatterThreads)
scatter(const int32_t* __restrict__ symbols, const int32_t* __restrict__ lengths,
        const int32_t* __restrict__ offsets, const uint8_t* __restrict__ emitted,
        const int32_t* __restrict__ local_off, const int32_t* __restrict__ flag_off,
        const int32_t* __restrict__ pay_off, int nc, int C, int S, int min_match,
        long long sec_flags, long long row_stride, uint8_t* __restrict__ blob) {
  extern __shared__ uint32_t flag_words[];
  __shared__ int warp_sums[32];
  const long long chunk = blockIdx.x;
  const long long base = chunk * C;
  uint8_t* section = blob + (chunk / nc) * row_stride + sec_flags;
  uint8_t* pay = section + pay_off[chunk];
  const int nwords = (C + 31) / 32;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) flag_words[w] = 0;
  __syncthreads();

  int ntok = 0;
  for (int tile = 0; tile < C; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const int e = i < C ? emitted[base + i] : 0;
    int total;
    const int rank = ntok + block_excl_scan(e, &total, warp_sums);
    if (e) {
      const int len = lengths[base + i];
      uint8_t* dst = pay + local_off[base + i];
      if (len >= min_match) {
        // little-endian: bit rank % 8 of byte rank / 8 is bit rank % 32 of
        // word rank / 32
        atomicOr(&flag_words[rank >> 5], 1u << (rank & 31));
        dst[0] = static_cast<uint8_t>(len);
        dst[1] = static_cast<uint8_t>(offsets[base + i]);
      } else {
        const uint32_t v = static_cast<uint32_t>(symbols[base + i]);
        for (int b = 0; b < S; ++b) dst[b] = static_cast<uint8_t>(v >> (8 * b));
      }
    }
    ntok += total;
  }
  __syncthreads();
  const uint8_t* flag_bytes = reinterpret_cast<const uint8_t*>(flag_words);
  uint8_t* fdst = section + flag_off[chunk];
  for (int j = threadIdx.x; j < (ntok + 7) / 8; j += blockDim.x) fdst[j] = flag_bytes[j];
}

}  // namespace

// n_tokens, payload_sizes (rows, nc) int32 -> flag_off, pay_off (rows, nc)
// int32 and totals (rows, 2) int32 = (flag_total, pay_total) per row.
extern "C" int lz_global_offsets_launch(const void* n_tokens, const void* payload_sizes,
                                        int rows, int nc, void* flag_off, void* pay_off,
                                        void* totals, void* stream) {
  global_offsets<<<rows, kOffsetThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(n_tokens), static_cast<const int32_t*>(payload_sizes), nc,
      static_cast<int32_t*>(flag_off), static_cast<int32_t*>(pay_off),
      static_cast<int32_t*>(totals));
  return cudaGetLastError();
}

// Kernel-I outputs for rows * nc chunks -> the flag and payload sections of
// each row's container, written into blob (rows, row_stride) uint8 at
// sec_flags + flag_off / sec_flags + pay_off.  Bytes not written keep the
// caller's contents (zeros).
extern "C" int lz_scatter_launch(const void* symbols, const void* lengths, const void* offsets,
                                 const void* emitted, const void* local_off,
                                 const void* flag_off, const void* pay_off, int rows, int nc,
                                 int C, int S, int min_match, long long sec_flags,
                                 long long row_stride, void* blob, void* stream) {
  const size_t smem = 4 * static_cast<size_t>((C + 31) / 32);
  cudaError_t err = allow_smem(scatter, smem);
  if (err != cudaSuccess) return err;
  scatter<<<rows * nc, kScatterThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(symbols), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(offsets), static_cast<const uint8_t*>(emitted),
      static_cast<const int32_t*>(local_off), static_cast<const int32_t*>(flag_off),
      static_cast<const int32_t*>(pay_off), nc, C, S, min_match, sec_flags, row_stride,
      static_cast<uint8_t*>(blob));
  return cudaGetLastError();
}
