// GPULZ decoder for Hopper: per-chunk aligned flag/payload sections ->
// symbols, one thread block per chunk.
//
// Replaces src/repro/kernels/lz_decode.py:_decode_kernel (launched by
// lz_decode_pallas).  The decode chain (token scans, a max-scan that gives
// every position its covering token, in-place pointer doubling to the
// fixed point) is gplz::decode_chunk in decode_chunk.cuh, shared with the
// one-launch decoder.  Here a chunk's sections are its rows of the gathered
// (nc, C/8) flag and (nc, C*S) payload arrays; reads of the payload row are
// clipped to it.  Where the chunk fits (C=2048 at any S), the flag row and
// the payload row's live bytes are staged in shared memory and the output
// row is built there and written once; larger chunks keep the rows layout.
// Bound on the H100: the bytes moved (the compact sections in, 4 bytes out
// per symbol); everything else stays in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "decode_chunk.cuh"

namespace {

constexpr int kThreads = 128;
// Held to 51 registers a thread: 10 blocks of 128 threads an SM (shared
// memory allows 13 at C=2048, S=2; a cap of 42 registers for 12 spilled and
// ran slower).
constexpr int kBlocksPerSM = 10;

template <bool kStaged, int S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode(const uint8_t* __restrict__ flag_bytes, const uint8_t* __restrict__ payload,
       const int32_t* __restrict__ n_tokens, int C, int rounds,
       int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  const long long chunk = blockIdx.x, nc = gridDim.x;
  const long long fw = C / 8, pw = static_cast<long long>(C) * S;  // row widths
  const gplz::Sections sec{flag_bytes + chunk * fw, 0, C / 8, payload + chunk * pw, 0, C * S,
                           -chunk * fw, (nc - chunk) * fw, -chunk * pw, (nc - chunk) * pw};
  gplz::decode_chunk<kStaged, S>(sec, gplz::clampi(n_tokens[chunk], 0, C), C, rounds, smem,
                              warp_sums, out + chunk * C);
}

template <bool kStaged, int S>
cudaError_t launch(const void* flag_bytes, const void* payload, const void* n_tokens, int nc,
                   int C, void* out, cudaStream_t stream, int* occupancy) {
  const size_t smem = kStaged ? gplz::staged_smem<S>(C) : gplz::rows_smem(C);
  if (occupancy) return kernel_occupancy(decode<kStaged, S>, kThreads, smem, occupancy, occupancy + 1);
  cudaError_t err = allow_smem(decode<kStaged, S>, smem);
  if (err != cudaSuccess) return err;
  decode<kStaged, S><<<nc, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(flag_bytes), static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(n_tokens), C, gplz::doubling_rounds(C),
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

// The layout and symbol size of this geometry; with ``occupancy`` set, its
// registers a thread and resident blocks per SM instead of a launch.
template <int S>
cudaError_t dispatch(const void* flag_bytes, const void* payload, const void* n_tokens, int nc,
                     int C, void* out, cudaStream_t stream, int* occupancy) {
  if (gplz::staged_smem<S>(C) <= gplz::kStagedSmemLimit)
    return launch<true, S>(flag_bytes, payload, n_tokens, nc, C, out, stream, occupancy);
  return launch<false, S>(flag_bytes, payload, n_tokens, nc, C, out, stream, occupancy);
}

cudaError_t by_symbol_size(const void* flag_bytes, const void* payload, const void* n_tokens,
                           int nc, int C, int S, void* out, cudaStream_t stream, int* occupancy) {
  switch (S) {
    case 1:
      return dispatch<1>(flag_bytes, payload, n_tokens, nc, C, out, stream, occupancy);
    case 2:
      return dispatch<2>(flag_bytes, payload, n_tokens, nc, C, out, stream, occupancy);
    case 4:
      return dispatch<4>(flag_bytes, payload, n_tokens, nc, C, out, stream, occupancy);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// flag_bytes (nc, C/8) uint8, payload (nc, C*S) uint8, n_tokens (nc,) int32
// -> out (nc, C) int32 (every element written).
extern "C" int lz_decode_launch(const void* flag_bytes, const void* payload, const void* n_tokens,
                                int nc, int C, int S, void* out, void* stream) {
  return by_symbol_size(flag_bytes, payload, n_tokens, nc, C, S, out,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// Registers a thread and resident blocks per SM of the layout this geometry
// launches -> out[0], out[1].
extern "C" int lz_decode_occupancy(int S, int C, void* out) {
  return by_symbol_size(nullptr, nullptr, nullptr, 0, C, S, nullptr, nullptr,
                        static_cast<int*>(out));
}
