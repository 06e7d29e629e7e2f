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
// in VMEM with binary searches because Mosaic has no scatter.  Here one
// thread block takes a chunk: warps rank its tokens with ballots (no block
// scan a tile), pack the pointer bits of each 128 positions with
// __reduce_or_sync, build the payload at local_off in shared memory, and
// the block stores the flag bytes and the payload with 16-byte stores
// (scatter below).  Chunks write disjoint ranges, so blocks never race.
// Bound on the H100: the bytes it moves, 17 read per position (four int32
// fields and the emit byte) and the container written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kOffsetThreads = 1024;
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kGroup = 128;  // positions a warp takes at a time, 4 a lane
// A chunk is staged (payload built in shared memory) where its flag words
// and payload fit in this much, which with the static 64 bytes stays under
// the 48 KB a launch gets without asking; larger chunks write the payload
// straight to the container.
constexpr int kStageBytes = 47 * 1024;

// Flag words of a C-position chunk: a bit a token, and a word of pad.
__host__ __device__ constexpr int flag_words(int C) { return (C + 31) / 32 + 1; }

// Shared memory of the staged layout: the flag words, the payload (at most
// C * S bytes, a multiple of 8) and the word past it that store_span reads.
constexpr long long staged_bytes(int C, int S) {
  return 4ll * flag_words(C) + static_cast<long long>(C) * S + 4;
}

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

// The block's threads copy n bytes from shared memory (src, 4-byte
// aligned; one readable word past the n bytes) to dst at any alignment:
// the head up to a 16-byte boundary and the tail a byte a thread, the body
// in 16-byte stores built from five aligned words by funnel shifts.
__device__ __forceinline__ void store_span(uint8_t* __restrict__ dst, const uint32_t* src, int n) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  const int nbody = (n - head) >> 4;
  const int tail = head + 16 * nbody;
  const uint8_t* s8 = reinterpret_cast<const uint8_t*>(src);
  for (int i = threadIdx.x; i < head + n - tail; i += blockDim.x) {
    const int j = i < head ? i : tail + i - head;
    dst[j] = s8[j];
  }
  const int sh = 8 * (head & 3);
  const uint32_t* w = src + (head >> 2);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nbody; i += blockDim.x) {
    const uint32_t* q = w + 4 * i;
    const uint32_t a = q[0], b = q[1], c = q[2], e = q[3], f = q[4];
    d[i] = make_uint4(__funnelshift_r(a, b, sh), __funnelshift_r(b, c, sh),
                      __funnelshift_r(c, e, sh), __funnelshift_r(e, f, sh));
  }
}

// One chunk a block of kScatterThreads.  Warp w owns the groups of 128
// positions [w * G / 8, (w + 1) * G / 8), G = ceil(C / 128); a lane takes 4
// positions of a group with one int4 load of each int32 field and one
// 4-byte load of `emitted` (C is a multiple of 8, so a lane's 4 positions
// lie all inside the chunk or all past it).
//
//   pass 1  each warp counts its tokens; one barrier; a warp's token carry
//           is the sum of the counts before it.
//   pass 2  per group, four ballots of `emitted` give each token its rank:
//           popc of the lower lanes' bits, then the lane's own in order.
//           The lane's pointer bits (at most 4) sit at that rank in a
//           128-bit string, whose four words come from __reduce_or_sync;
//           lanes 0..3 OR them into the flag words at the carry (an OR
//           can straddle two words, shared with the next warp's range;
//           little-endian, bit r of the flag bytes is bit r % 32 of word
//           r / 32).
//           Each token writes its 2 or S payload bytes at local_off: into
//           shared memory (the staged layout) or straight to the container
//           (the direct layout, for chunks whose payload does not fit).
//   out     after a second barrier the block stores the flag bytes, and in
//           the staged layout the payload, with 16-byte stores.
//
// kStaged is chosen at launch by the chunk's shared-memory need.
template <bool kStaged>
__global__ void __launch_bounds__(kScatterThreads)
scatter(const int32_t* __restrict__ symbols, const int32_t* __restrict__ lengths,
        const int32_t* __restrict__ offsets, const uint8_t* __restrict__ emitted,
        const int32_t* __restrict__ local_off, const int32_t* __restrict__ flag_off,
        const int32_t* __restrict__ pay_off, int nc, int C, int S, int min_match,
        long long sec_flags, long long row_stride, uint8_t* __restrict__ blob) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int warp_tokens[kScatterWarps], warp_end[kScatterWarps];
  const int nfw = flag_words(C);
  uint32_t* flags = smem;
  uint32_t* stage = smem + nfw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long chunk = blockIdx.x;
  const long long base = chunk * C;
  uint8_t* section = blob + (chunk / nc) * row_stride + sec_flags;
  uint8_t* pay = section + pay_off[chunk];
  for (int w = threadIdx.x; w < nfw; w += blockDim.x) flags[w] = 0;
  const int ngroups = (C + kGroup - 1) / kGroup;
  const int g0 = warp * ngroups / kScatterWarps;
  const int g1 = (warp + 1) * ngroups / kScatterWarps;

  int count = 0;
  for (int g = g0; g < g1; ++g) {
    const int p = g * kGroup + 4 * lane;
    if (p < C) {
      const uint32_t e4 = *reinterpret_cast<const uint32_t*>(emitted + base + p);
      count += __popc(__vcmpne4(e4, 0u)) >> 3;
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) warp_tokens[warp] = count;
  __syncthreads();
  int carry = 0, ntok = 0;
#pragma unroll
  for (int w = 0; w < kScatterWarps; ++w) {
    carry += w < warp ? warp_tokens[w] : 0;
    ntok += warp_tokens[w];
  }

  const uint32_t lower = (1u << lane) - 1;
  int end = 0;
  uint8_t* dst0 = kStaged ? reinterpret_cast<uint8_t*>(stage) : pay;
  for (int g = g0; g < g1; ++g) {
    const int p = g * kGroup + 4 * lane;
    int4 sy = make_int4(0, 0, 0, 0), ln = sy, of = sy, lo = sy;
    uint32_t e4 = 0;
    if (p < C) {
      sy = *reinterpret_cast<const int4*>(symbols + base + p);
      ln = *reinterpret_cast<const int4*>(lengths + base + p);
      of = *reinterpret_cast<const int4*>(offsets + base + p);
      lo = *reinterpret_cast<const int4*>(local_off + base + p);
      e4 = __vcmpne4(*reinterpret_cast<const uint32_t*>(emitted + base + p), 0u);
    }
    const int sym[4] = {sy.x, sy.y, sy.z, sy.w}, len[4] = {ln.x, ln.y, ln.z, ln.w};
    const int off[4] = {of.x, of.y, of.z, of.w}, loc[4] = {lo.x, lo.y, lo.z, lo.w};
    int rank = 0, group_tokens = 0, mine = 0;
    uint32_t kinds = 0;  // bit k: the lane's k-th token is a pointer
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool e = (e4 >> (8 * j)) & 1;
      const uint32_t ej = __ballot_sync(0xffffffffu, e);
      rank += __popc(ej & lower);
      group_tokens += __popc(ej);
      if (e) {
        const bool match = len[j] >= min_match;
        uint8_t* dst = dst0 + loc[j];
        if (match) {
          kinds |= 1u << mine;
          dst[0] = static_cast<uint8_t>(len[j]);
          dst[1] = static_cast<uint8_t>(off[j]);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (b < S) dst[b] = static_cast<uint8_t>(static_cast<uint32_t>(sym[j]) >> (8 * b));
        }
        end = max(end, loc[j] + (match ? 2 : S));
        ++mine;
      }
    }
    // the group's pointer bits in rank order: 128 bits, four words
    const int k0 = rank >> 5, sh = rank & 31;
    const uint32_t low = kinds << sh;
    const uint32_t high = sh ? kinds >> (32 - sh) : 0u;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t wk = __reduce_or_sync(
          0xffffffffu, (k == k0 ? low : 0u) | (k == k0 + 1 ? high : 0u));
      if (lane == k) word = wk;
    }
    if (lane < 4 && word) {
      const int bit = carry + 32 * lane;
      atomicOr(&flags[bit >> 5], word << (bit & 31));
      if ((bit & 31) && (word >> (32 - (bit & 31))))
        atomicOr(&flags[(bit >> 5) + 1], word >> (32 - (bit & 31)));
    }
    carry += group_tokens;
  }
  end = __reduce_max_sync(0xffffffffu, end);
  if (lane == 0) warp_end[warp] = end;
  __syncthreads();
  int pay_bytes = 0;
#pragma unroll
  for (int w = 0; w < kScatterWarps; ++w) pay_bytes = max(pay_bytes, warp_end[w]);
  store_span(section + flag_off[chunk], flags, (ntok + 7) / 8);
  if (kStaged) store_span(pay, stage, pay_bytes);
}

// Kernel III's layout at (C, S): staged where its shared memory fits
// kStageBytes, else direct; *smem gets the dynamic shared memory it needs.
decltype(&scatter<true>) scatter_layout(int C, int S, size_t* smem) {
  const bool staged = staged_bytes(C, S) <= kStageBytes;
  *smem = staged ? staged_bytes(C, S) : 4 * static_cast<size_t>(flag_words(C));
  return staged ? scatter<true> : scatter<false>;
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
// caller's contents (zeros).  The int32 fields must be 16-byte aligned and
// emitted 4-byte aligned; C a multiple of 8.
extern "C" int lz_scatter_launch(const void* symbols, const void* lengths, const void* offsets,
                                 const void* emitted, const void* local_off,
                                 const void* flag_off, const void* pay_off, int rows, int nc,
                                 int C, int S, int min_match, long long sec_flags,
                                 long long row_stride, void* blob, void* stream) {
  if (C <= 0 || C % 8) return cudaErrorInvalidValue;
  if (rows <= 0 || nc <= 0) return cudaSuccess;
  size_t smem;
  const auto kernel = scatter_layout(C, S, &smem);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows * nc, kScatterThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(symbols), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(offsets), static_cast<const uint8_t*>(emitted),
      static_cast<const int32_t*>(local_off), static_cast<const int32_t*>(flag_off),
      static_cast<const int32_t*>(pay_off), nc, C, S, min_match, sec_flags, row_stride,
      static_cast<uint8_t*>(blob));
  return cudaGetLastError();
}

// Registers a thread, resident blocks per SM and the layout (1 staged, 0
// direct) of Kernel III at chunk_symbols C and symbol size S -> out[0..2].
extern "C" int lz_scatter_occupancy(int C, int S, void* out) {
  int* o = static_cast<int*>(out);
  size_t smem;
  const auto kernel = scatter_layout(C, S, &smem);
  o[2] = kernel == scatter<true>;
  return kernel_occupancy(kernel, kScatterThreads, smem, o, o + 1);
}
