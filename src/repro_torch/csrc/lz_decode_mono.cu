// The one-launch GPULZ decoder for Hopper: container blobs -> symbols,
// one thread block per chunk of every buffer of a batch.
//
// Replaces src/repro/kernels/lz_decode_mono.py:_mono_decode_kernel
// (launched by lz_decode_mono_pallas).  The TPU kernel DMAs fixed-width
// section windows from the HBM-resident blob into VMEM and masks them to
// the chunk's true sizes.  Here no window is staged: the block reads its
// chunk's flag and payload bytes in place from the blob, through an
// accessor that gives 0 for a byte past the chunk's section size or past
// the blob's end (the zero pad of the TPU wrapper), and runs the decode
// chain shared with the split decoder (decode_chunk.cuh).  The section
// offsets of each chunk are the two cumsums of the A/B tables, computed by
// the wrapper as the TPU wrapper computes them outside its kernel.  So the
// section gathers of the split path (two passes over the container) drop
// out.  Bound on the H100: the bytes moved (the compact sections read
// once, 4 bytes written per symbol); the doubling rounds stay in shared
// memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "decode_chunk.cuh"

namespace {

constexpr int kThreads = 256;
// Held to 32 registers a thread, so that 8 blocks stay resident on each SM
// as they do for the split decoder.
constexpr int kBlocksPerSM = 8;

// One chunk's sections, read in place from its buffer's blob row.
struct BlobSections {
  const uint8_t* blob;  // the buffer's row, L bytes
  long long L, fofs, pofs;  // row length; flag / payload section starts
  int fsz, psz;  // the chunk's flag and payload bytes (A/B tables)
  __device__ int flag(int j) const {
    const long long a = fofs + j;
    return j < fsz && a >= 0 && a < L ? blob[a] : 0;
  }
  __device__ int pay(int k) const {
    const long long a = pofs + k;
    return k < psz && a >= 0 && a < L ? blob[a] : 0;
  }
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode_mono(const uint8_t* __restrict__ blobs, long long L, int nc,
            const int32_t* __restrict__ n_tokens, const int32_t* __restrict__ payload_sizes,
            const long long* __restrict__ fofs, const long long* __restrict__ pofs, int C,
            int S, int rounds, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  uint16_t* src = reinterpret_cast<uint16_t*>(smem);
  const long long chunk = blockIdx.x;
  const int nt = n_tokens[chunk];
  const BlobSections sec{blobs + (chunk / nc) * L, L, fofs[chunk], pofs[chunk],
                         nt < 0 ? 0 : (nt + 7) / 8, payload_sizes[chunk]};
  gplz::decode_chunk(sec, gplz::clampi(nt, 0, C), C, S, rounds, src, src + C, warp_sums,
                     out + chunk * C);
}

}  // namespace

// blobs (rows, L) uint8; n_tokens, payload_sizes (rows * nc,) int32; fofs,
// pofs (rows * nc,) int64 section starts within each row -> out
// (rows * nc, C) int32 (every element written).
extern "C" int lz_decode_mono_launch(const void* blobs, long long L, int rows, int nc,
                                     const void* n_tokens, const void* payload_sizes,
                                     const void* fofs, const void* pofs, int C, int S,
                                     void* out, void* stream) {
  const size_t smem = 4 * static_cast<size_t>(C);
  cudaError_t err = allow_smem(decode_mono, smem);
  if (err != cudaSuccess) return err;
  decode_mono<<<rows * nc, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blobs), L, nc, static_cast<const int32_t*>(n_tokens),
      static_cast<const int32_t*>(payload_sizes), static_cast<const long long*>(fofs),
      static_cast<const long long*>(pofs), C, S, gplz::doubling_rounds(C),
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}
