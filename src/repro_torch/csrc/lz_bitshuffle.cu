// Bit-plane transpose (bitshuffle) of the lossy-fz container for Hopper.
//
// The wire layout (src/repro/core/bitshuffle.py): the u16 unit stream is
// cut into blocks of 512 units; block plane b (b = 0..15, LSB first) is 64
// bytes, and its byte j packs bit b of units 8j..8j+7, unit 8j in the
// byte's LSB.  So the 16 bytes of units 8j..8j+7 (one 16-byte slot of the
// input) hold exactly byte j of all 16 planes: their low bytes are an 8x8
// bit matrix (row k = unit 8j+k) whose transpose is byte j of planes 0-7,
// their high bytes the same for planes 8-15.  One thread owns one slot.
//
// bitshuffle replaces src/repro/kernels/lz_bitshuffle.py:_shuffle_kernel
// (launched by bitshuffle_pallas), which widens a tile of blocks to int32
// and builds the planes with shift / mask / sum over iota lattices.  Here
// a thread loads its slot with one 16-byte load, gathers the low and the
// high bytes with __byte_perm, transposes both 8x8 bit matrices in
// registers (three delta swaps each, no lane talks to another) and writes
// its 16 plane bytes to shared memory at b * 64 + j; the block then leaves
// as 16-byte stores, neighbouring threads on neighbouring addresses.
//
// bitunshuffle replaces src/repro/kernels/lz_bitshuffle.py:
// _unshuffle_kernel (launched by bitunshuffle_pallas).  The tile is staged
// in shared memory with 16-byte loads and stores; thread j of a block reads
// byte j of the 16 planes (neighbouring lanes, neighbouring bytes), undoes
// the two transposes and writes units 8j..8j+7 as one 16-byte store.
//
// Bound on the H100, both ways: the bytes moved (2 in and 2 out per unit).
// What held the first port (a 512-thread CTA a block, 2-byte loads) at a
// fifth of it was the bytes in flight, about 4 KB an SM.  Here a CTA of 256
// threads owns a tile of kTile = 8 bitshuffle blocks and loads it at once,
// 16 bytes a thread twice, before any transpose: 8 KB a CTA, 8 CTAs an SM,
// 64 KB an SM in flight.  The grid is a CTA a tile; the hardware refills
// an SM as each CTA ends (a persistent grid striding over tiles, and tiles
// of 16 and 32 blocks, measured no faster on the H100: PERF.md §6).  The
// last tile may be partial; slots past the end are neither read nor
// written.  Pointers that are not 16-byte aligned (views at a storage
// offset) take the same kernel with byte loads and stores: exact, slower.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kBlockBytes = 1024;          // bytes per bitshuffle block (512 u16 units)
constexpr int kPlaneBytes = 64;
constexpr int kSlots = kBlockBytes / 16;   // 16-byte slots a block: one a thread
constexpr int kThreads = 256;
constexpr int kTile = 8;                   // bitshuffle blocks a CTA's tile

// Transpose of the 8x8 bit matrix held in (lo, hi): row r is byte r of the
// 64-bit word hi:lo (rows 0-3 in lo), column c is bit c of the row.  Bit c
// of row r goes to bit r of row c.  The transpose is its own inverse.
__device__ __forceinline__ void transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;  // 2x2 blocks
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;  // 4x4 blocks of 2x2
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (hi ^ (lo >> 4)) & 0x0F0F0F0Fu;  // the two off-diagonal 4x4 blocks
  hi ^= t;
  lo ^= t << 4;
}

template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = p[4 * i] | (p[4 * i + 1] << 8) | (p[4 * i + 2] << 16) |
             (static_cast<uint32_t>(p[4 * i + 3]) << 24);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* p, uint4 v) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
}

constexpr int K = kTile * kSlots / kThreads;  // slots a thread

// This CTA's tile: a thread's slots k * kThreads + threadIdx.x of it, so a
// warp's loads are 512 contiguous bytes.  Slots past the stream's end read
// as zeros (and are never stored).
template <bool kVec>
__device__ __forceinline__ void load_tile(const uint8_t* in, long long nslots, uint4 (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long g =
        static_cast<long long>(blockIdx.x) * (K * kThreads) + k * kThreads + threadIdx.x;
    v[k] = g < nslots ? load16<kVec>(in + 16 * g) : make_uint4(0, 0, 0, 0);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bitshuffle(const uint8_t* __restrict__ in, int nblocks, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t sm[kTile * kBlockBytes];
  const long long nslots = static_cast<long long>(nblocks) * kSlots;
  uint4 slot[K];
  load_tile<kVec>(in, nslots, slot);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * kThreads + threadIdx.x;
    const uint4 v = slot[k];
    uint32_t l0 = __byte_perm(v.x, v.y, 0x6420), l1 = __byte_perm(v.z, v.w, 0x6420);
    uint32_t h0 = __byte_perm(v.x, v.y, 0x7531), h1 = __byte_perm(v.z, v.w, 0x7531);
    transpose8(l0, l1);  // byte b: plane b's byte j, b = 0..7
    transpose8(h0, h1);  // planes 8..15
    uint8_t* o = sm + (s / kSlots) * kBlockBytes + (s % kSlots);
    const uint32_t planes[4] = {l0, l1, h0, h1};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      o[b * kPlaneBytes] = static_cast<uint8_t>(planes[b >> 2] >> (8 * (b & 3)));
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * kThreads + threadIdx.x;
    const long long g = static_cast<long long>(blockIdx.x) * (K * kThreads) + s;
    if (g < nslots) store16<kVec>(out + 16 * g, reinterpret_cast<const uint4*>(sm)[s]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bitunshuffle(const uint8_t* __restrict__ in, int nblocks, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t sm[kTile * kBlockBytes];
  const long long nslots = static_cast<long long>(nblocks) * kSlots;
  uint4 slot[K];
  load_tile<kVec>(in, nslots, slot);
#pragma unroll
  for (int k = 0; k < K; ++k) reinterpret_cast<uint4*>(sm)[k * kThreads + threadIdx.x] = slot[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * kThreads + threadIdx.x;
    const uint8_t* p = sm + (s / kSlots) * kBlockBytes + (s % kSlots);
    uint32_t planes[4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
      planes[w] = p[(4 * w) * kPlaneBytes] | (p[(4 * w + 1) * kPlaneBytes] << 8) |
                  (p[(4 * w + 2) * kPlaneBytes] << 16) |
                  (static_cast<uint32_t>(p[(4 * w + 3) * kPlaneBytes]) << 24);
    transpose8(planes[0], planes[1]);  // byte k: the low byte of unit 8j + k
    transpose8(planes[2], planes[3]);  // the high bytes
    const uint4 v = make_uint4(__byte_perm(planes[0], planes[2], 0x5140),
                               __byte_perm(planes[0], planes[2], 0x7362),
                               __byte_perm(planes[1], planes[3], 0x5140),
                               __byte_perm(planes[1], planes[3], 0x7362));
    const long long g = static_cast<long long>(blockIdx.x) * (K * kThreads) + s;
    if (g < nslots) store16<kVec>(out + 16 * g, v);
  }
}

using Kernel = void (*)(const uint8_t*, int, uint8_t*);

Kernel pick(bool unshuffle, bool vec) {
  return unshuffle ? (vec ? bitunshuffle<true> : bitunshuffle<false>)
                   : (vec ? bitshuffle<true> : bitshuffle<false>);
}

cudaError_t launch(bool unshuffle, const void* in, int nblocks, void* out, void* stream) {
  if (nblocks < 0) return cudaErrorInvalidValue;
  if (nblocks == 0) return cudaSuccess;
  const bool vec = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  void* args[] = {&src, &nblocks, &dst};
  const cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<const void*>(pick(unshuffle, vec)),
                       dim3((nblocks + kTile - 1) / kTile), dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// units (512 * nblocks,) u16 -> out (1024 * nblocks,) uint8.
extern "C" int lz_bitshuffle_launch(const void* units, int nblocks, void* out, void* stream) {
  return launch(false, units, nblocks, out, stream);
}

// in (1024 * nblocks,) uint8 -> units (512 * nblocks,) u16.
extern "C" int lz_bitunshuffle_launch(const void* in, int nblocks, void* units, void* stream) {
  return launch(true, in, nblocks, units, stream);
}

// out[0..3]: registers a thread and resident CTAs per SM of bitshuffle,
// then of bitunshuffle, on aligned pointers.
extern "C" int lz_bitshuffle_occupancy(void* out) {
  int* o = static_cast<int*>(out);
  for (int d = 0; d < 2; ++d) {
    const cudaError_t err =
        kernel_occupancy(pick(d == 1, true), kThreads, 0, o + 2 * d, o + 2 * d + 1);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
