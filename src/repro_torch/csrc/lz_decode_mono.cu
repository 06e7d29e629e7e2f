// The one-launch GPULZ decoder for Hopper: container blobs -> symbols,
// one thread block per chunk of every buffer of a batch.
//
// Replaces src/repro/kernels/lz_decode_mono.py:_mono_decode_kernel
// (launched by lz_decode_mono_pallas).  The TPU kernel DMAs fixed-width
// section windows from the HBM-resident blob into VMEM and masks them to
// the chunk's true sizes.  Here the block copies its chunk's flag and
// payload bytes from the blob into shared memory with aligned 16-byte
// loads, clipped once to the chunk's section sizes and to the blob's end
// (the zero pad of the TPU wrapper), and runs the decode chain shared with
// the split decoder (decode_chunk.cuh); chunks too large to stage read the
// blob in place through the same clip.  The section offsets of each chunk
// come from one inclusive cumsum of each row's flag sizes followed by its
// payload sizes (the A/B tables), taken by the wrapper as the TPU wrapper
// takes its cumsums outside its kernel.  So the section gathers of the
// split path (two passes over the container) drop out.  Bound on the H100:
// the bytes moved (the compact sections read once, 4 bytes written per
// symbol); everything else stays in shared memory.

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

// The bytes [lo, hi) of an n-byte section at ``ofs`` of an L-byte row that
// lie inside the row and the section's ``size``.
__device__ __forceinline__ void clip(long long ofs, long long L, int size, int n, int* lo, int* hi) {
  const long long a = ofs < 0 ? -ofs : 0;
  long long b = L - ofs;
  b = b < size ? b : size;
  b = b < n ? b : n;
  *lo = static_cast<int>(a < n ? a : n);
  *hi = static_cast<int>(b > *lo ? b : *lo);
}

template <bool kStaged, int S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode_mono(const uint8_t* __restrict__ blobs, long long L, int nc,
            const int32_t* __restrict__ n_tokens, const int32_t* __restrict__ payload_sizes,
            const long long* __restrict__ cums, long long sec_flags, int C, int rounds,
            int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  const long long chunk = blockIdx.x;
  const int nt = n_tokens[chunk];
  const long long row0 = (chunk / nc) * L, end = static_cast<long long>(gridDim.x / nc) * L;
  const uint8_t* row = blobs + row0;
  // the cumsum runs over the row's flag sizes ((nt + 7) >> 3, as summed)
  // and then its payload sizes: each section's start is its sum before it
  const long long* cum = cums + (chunk / nc) * 2 * nc;
  const int k = static_cast<int>(chunk % nc), psz = payload_sizes[chunk];
  const long long fo = sec_flags + cum[k] - ((nt + 7) >> 3);
  const long long po = sec_flags + cum[nc + k] - psz;
  // whole words may be read anywhere in the batch's blobs
  gplz::Sections sec{row + fo, 0, 0, row + po, 0, 0,
                     -(row0 + fo), end - (row0 + fo), -(row0 + po), end - (row0 + po)};
  clip(fo, L, nt < 0 ? 0 : (nt + 7) / 8, C / 8, &sec.flo, &sec.fhi);
  clip(po, L, psz, C * S, &sec.plo, &sec.phi);
  gplz::decode_chunk<kStaged, S>(sec, gplz::clampi(nt, 0, C), C, rounds, smem, warp_sums,
                              out + chunk * C);
}

// The launch arguments but the layout and symbol size.
struct Args {
  const void *blobs;
  long long L;
  int rows, nc;
  const void *n_tokens, *payload_sizes, *cums;
  long long sec;
  int C;
  void* out;
  cudaStream_t stream;
};

template <bool kStaged, int S>
cudaError_t launch(const Args& a, int* occupancy) {
  const size_t smem = kStaged ? gplz::staged_smem<S>(a.C) : gplz::rows_smem(a.C);
  if (occupancy)
    return kernel_occupancy(decode_mono<kStaged, S>, kThreads, smem, occupancy, occupancy + 1);
  cudaError_t err = allow_smem(decode_mono<kStaged, S>, smem);
  if (err != cudaSuccess) return err;
  decode_mono<kStaged, S><<<a.rows * a.nc, kThreads, smem, a.stream>>>(
      static_cast<const uint8_t*>(a.blobs), a.L, a.nc, static_cast<const int32_t*>(a.n_tokens),
      static_cast<const int32_t*>(a.payload_sizes), static_cast<const long long*>(a.cums), a.sec,
      a.C, gplz::doubling_rounds(a.C), static_cast<int32_t*>(a.out));
  return cudaGetLastError();
}

// The layout and symbol size of this geometry; with ``occupancy`` set, its
// registers a thread and resident blocks per SM instead of a launch.
template <int S>
cudaError_t dispatch(const Args& a, int* occupancy) {
  if (gplz::staged_smem<S>(a.C) <= gplz::kStagedSmemLimit) return launch<true, S>(a, occupancy);
  return launch<false, S>(a, occupancy);
}

cudaError_t by_symbol_size(const Args& a, int S, int* occupancy) {
  switch (S) {
    case 1:
      return dispatch<1>(a, occupancy);
    case 2:
      return dispatch<2>(a, occupancy);
    case 4:
      return dispatch<4>(a, occupancy);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// blobs (rows, L) uint8; n_tokens, payload_sizes (rows * nc,) int32; cums
// (rows, 2 * nc) int64, each row's inclusive cumsum of its flag section
// sizes ((nt + 7) >> 3) and then its payload sizes; sec the flag section's
// byte offset in a row -> out (rows * nc, C) int32 (every element written).
extern "C" int lz_decode_mono_launch(const void* blobs, long long L, int rows, int nc,
                                     const void* n_tokens, const void* payload_sizes,
                                     const void* cums, long long sec, int C, int S, void* out,
                                     void* stream) {
  const Args a{blobs, L, rows, nc, n_tokens, payload_sizes, cums, sec, C, out,
               static_cast<cudaStream_t>(stream)};
  return by_symbol_size(a, S, nullptr);
}

// Registers a thread and resident blocks per SM of the layout this geometry
// launches -> out[0], out[1].
extern "C" int lz_decode_mono_occupancy(int S, int C, void* out) {
  const Args a{nullptr, 0, 0, 0, nullptr, nullptr, nullptr, 0, C, nullptr, nullptr};
  return by_symbol_size(a, S, static_cast<int*>(out));
}
