// GPULZ decoder for Hopper: per-chunk aligned flag/payload sections ->
// symbols, one thread block per chunk.
//
// Replaces src/repro/kernels/lz_decode.py:_decode_kernel (launched by
// lz_decode_pallas).  The decode chain (flag bits, two block scans, the
// u16 copy-source row, pointer doubling) is gplz::decode_chunk in
// decode_chunk.cuh, shared with the one-launch decoder.  Here a chunk's
// sections are its rows of the gathered (nc, C/8) flag and (nc, C*S)
// payload arrays; reads of the payload row are clipped to it.  Bound on
// the H100: the bytes moved (the compact sections in, 4 bytes out per
// symbol); the doubling rounds stay in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "decode_chunk.cuh"

namespace {

constexpr int kThreads = 256;

// A chunk's rows of the gathered arrays; decode_chunk clips payload reads
// to [0, C*S), so the row holds every byte the chain can ask for.
struct GatheredRow {
  const uint8_t* fb;
  const uint8_t* row;
  __device__ int flag(int j) const { return fb[j]; }
  __device__ int pay(int k) const { return row[k]; }
};

__global__ void __launch_bounds__(kThreads)
decode(const uint8_t* __restrict__ flag_bytes, const uint8_t* __restrict__ payload,
       const int32_t* __restrict__ n_tokens, int C, int S, int rounds,
       int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  uint16_t* src = reinterpret_cast<uint16_t*>(smem);
  const long long chunk = blockIdx.x;
  const GatheredRow sec{flag_bytes + chunk * (C / 8), payload + chunk * C * S};
  gplz::decode_chunk(sec, gplz::clampi(n_tokens[chunk], 0, C), C, S, rounds, src, src + C,
                     warp_sums, out + chunk * C);
}

}  // namespace

// flag_bytes (nc, C/8) uint8, payload (nc, C*S) uint8, n_tokens (nc,) int32
// -> out (nc, C) int32 (every element written).
extern "C" int lz_decode_launch(const void* flag_bytes, const void* payload, const void* n_tokens,
                                int nc, int C, int S, void* out, void* stream) {
  const size_t smem = 4 * static_cast<size_t>(C);
  cudaError_t err = allow_smem(decode, smem);
  if (err != cudaSuccess) return err;
  decode<<<nc, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flag_bytes), static_cast<const uint8_t*>(payload),
      static_cast<const int32_t*>(n_tokens), C, S, gplz::doubling_rounds(C),
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}
