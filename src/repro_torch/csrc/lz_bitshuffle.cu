// Bit-plane transpose (bitshuffle) of the lossy-fz container for Hopper.
//
// The wire layout (src/repro/core/bitshuffle.py): the u16 unit stream is
// cut into blocks of 512 units; block plane b (b = 0..15, LSB first) is 64
// bytes, and its byte j packs bit b of units 8j..8j+7, unit 8j in the
// byte's LSB.
//
// bitshuffle replaces src/repro/kernels/lz_bitshuffle.py:_shuffle_kernel
// (launched by bitshuffle_pallas), which widens a tile of blocks to int32
// and builds the planes with shift / mask / sum over iota lattices.  Here
// one thread block of 512 threads owns one bitshuffle block, one unit per
// thread.  For plane b, __ballot_sync over a warp's 32 units is exactly 4
// bytes of that plane (lane i <-> bit i); stored little-endian, unit 8j
// lands in the LSB of byte j.  Lane b of each warp keeps plane b's word
// and writes it, so each warp stores its 16 words, one per plane.
//
// bitunshuffle replaces src/repro/kernels/lz_bitshuffle.py:
// _unshuffle_kernel (launched by bitunshuffle_pallas).  The block's 1,024
// bytes are staged in shared memory; each thread rebuilds one u16 from bit
// (unit & 7) of byte plane * 64 + unit / 8 of the 16 planes.
//
// Bound on the H100, both ways: the bytes moved (2 in and 2 out per unit).

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kUnits = 512;        // u16 units per bitshuffle block
constexpr int kBlockBytes = 1024;  // bytes per bitshuffle block
constexpr int kPlaneBytes = 64;

__global__ void __launch_bounds__(kUnits)
bitshuffle(const uint16_t* __restrict__ units, uint32_t* __restrict__ out) {
  const long long blk = blockIdx.x;
  const uint32_t v = units[blk * kUnits + threadIdx.x];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t mine = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uint32_t bits = __ballot_sync(0xffffffffu, (v >> b) & 1u);
    if (lane == b) mine = bits;
  }
  // plane `lane`, bytes 4 * warp .. 4 * warp + 3 of it
  if (lane < 16) out[blk * (kBlockBytes / 4) + lane * (kPlaneBytes / 4) + warp] = mine;
}

__global__ void __launch_bounds__(kUnits)
bitunshuffle(const uint8_t* __restrict__ in, uint16_t* __restrict__ units) {
  __shared__ uint8_t s[kBlockBytes];
  const long long blk = blockIdx.x;
  const uint8_t* src = in + blk * kBlockBytes;
  s[threadIdx.x] = src[threadIdx.x];
  s[threadIdx.x + kUnits] = src[threadIdx.x + kUnits];
  __syncthreads();
  const int u = threadIdx.x;
  const int byte = u >> 3;
  const int shift = u & 7;
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) v |= ((s[b * kPlaneBytes + byte] >> shift) & 1u) << b;
  units[blk * kUnits + u] = static_cast<uint16_t>(v);
}

}  // namespace

// units (512 * nblocks,) u16 -> out (1024 * nblocks,) uint8.
extern "C" int lz_bitshuffle_launch(const void* units, int nblocks, void* out, void* stream) {
  if (nblocks <= 0) return cudaSuccess;
  bitshuffle<<<nblocks, kUnits, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(units), static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

// in (1024 * nblocks,) uint8 -> units (512 * nblocks,) u16.
extern "C" int lz_bitunshuffle_launch(const void* in, int nblocks, void* units, void* stream) {
  if (nblocks <= 0) return cudaSuccess;
  bitunshuffle<<<nblocks, kUnits, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint16_t*>(units));
  return cudaGetLastError();
}
