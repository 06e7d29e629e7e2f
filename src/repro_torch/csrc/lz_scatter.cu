// GPULZ Kernels II and III for Hopper: the global prefix sums and the
// deflate-scatter that writes each chunk's compact bytes into the container.
//
// Kernel II replaces src/repro/kernels/lz_scatter.py:_offsets_kernel
// (launched by lz_global_offsets_pallas).  One thread block of 1,024 takes
// a buffer (a row): the per-chunk flag sizes ceil(n_tokens / 8) and payload
// sizes are read as int4 vectors in warp-striped rounds, every load of a
// tile issued before its scan, and scanned by warp shuffles with one
// cross-warp step a tile (global_offsets below).  Payload offsets come out
// pre-based by the flag total exactly as the TPU kernel's do.  Bound on
// the H100: the 16 bytes per chunk it moves, 0.16 us at nc = 32,768; one
// block cannot reach the card's memory rate, and the launch itself costs
// more than that, so the kernel is held to the launch and a copy of its
// bytes instead.
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

// ------------------------------------------------------------- Kernel II
//
// A block of kOffsetThreads takes a row.  The row is read in a frame that
// starts at the row's start rounded down to 16 bytes: frame index f is
// chunk f - sh, where sh (0..3) is that start's residue mod 16 in int32s,
// so frame vector f (f a multiple of 4) is one aligned int4 of each of the
// four arrays, which start at one residue (the C entry refuses others;
// with rows of nc % 4 != 0 the residue changes from row to row).  Chunks
// outside [0, nc) read as 0 and are not stored; a vector holding one of
// them is read whole (the 16 aligned bytes around a chunk of the row lie
// in its allocation) and stored an int32 at a time.
//
// A tile is up to kTileRounds rounds of every warp, both arrays.  With rr
// rounds, warp w owns frame [w * rr * 128, (w + 1) * rr * 128) of the tile,
// and in round j lane l holds the vector at 128 * (w * rr + j) + 4 * l:
// coalesced, and all of a tile's loads are issued before its scan.
// scan_tile scans each round's lane sums by shuffles with a running warp
// carry, then the warps' totals in one cross-warp step (one barrier).  A
// row of at most kTileChunks frame chunks is one tile, so the flag total
// is known before any pay_off is stored.  A longer row first sums its flag
// sizes (all of a thread's loads in flight, one barrier), then takes its
// tiles with a carry for each array.
//
// Measured on the H100 (PERF.md): one SM moves the row's bytes at 70-85
// GB/s, and a tile's shuffle scan does not overlap its loads and stores,
// so a row costs about 1.5 us of memory and 1.1 us of scan per 16,384
// values beside the launch.  Tiles of 8 or 16 chunks a lane (fewer
// shuffles, strided loads), sweeping the flags and then the payload with
// the next tile in flight (in registers, or by bulk copies into shared
// memory) and 512 threads with 8-round tiles were all slower.

// A lane's chunks a round (one int4), a warp's round, a round of every
// warp, a tile's rounds and the largest tile.
constexpr int kOffsetWarps = kOffsetThreads / 32;
constexpr int kVecChunks = 4;
constexpr int kRoundChunks = 32 * kVecChunks;
constexpr int kBlockRound = kOffsetWarps * kRoundChunks;
constexpr int kTileRounds = 4;
constexpr int kTileChunks = kTileRounds * kBlockRound;
// int4 loads of n_tokens a thread keeps in flight while it sums the flags
constexpr int kReduceLoads = 8;

using Tile = int[2][kTileRounds][kVecChunks];  // [flag sizes, payload sizes]

struct OffsetsRow {
  const int32_t* nt;
  const int32_t* ps;
  int32_t* fo;
  int32_t* po;
  int nc, sh, len;  // len = nc + sh, the frame's length
};

__device__ __forceinline__ int int32_residue(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ OffsetsRow offsets_row(const int32_t* nt, const int32_t* ps,
                                                  int32_t* fo, int32_t* po, int nc) {
  const long long r = static_cast<long long>(blockIdx.x) * nc;
  OffsetsRow row;
  row.nt = nt + r;
  row.ps = ps + r;
  row.fo = fo + r;
  row.po = po + r;
  row.nc = nc;
  row.sh = int32_residue(row.nt);
  row.len = nc + row.sh;
  return row;
}

// Rounds of the tile at frame f0: kTileRounds but for the row's last tile.
__device__ __forceinline__ int tile_rounds(const OffsetsRow& row, int f0) {
  return min(kTileRounds, (row.len - f0 + kBlockRound - 1) / kBlockRound);
}

// Frame index of the lane's vector in round j of a tile at f0 with rr rounds.
__device__ __forceinline__ int vec_frame(int f0, int rr, int j) {
  return f0 + ((threadIdx.x >> 5) * rr + j) * kRoundChunks + kVecChunks * (threadIdx.x & 31);
}

// Every vector of the tile at f0 lies inside the row: no masks.
__device__ __forceinline__ bool tile_inside(const OffsetsRow& row, int f0) {
  return (f0 > 0 || row.sh == 0) && f0 + tile_rounds(row, f0) * kBlockRound <= row.len;
}

// Frame vector f of the row array p as one int4, 0 outside [0, nc);
// kInside: a vector inside the row.
template <bool kInside>
__device__ __forceinline__ void load_vec(const int32_t* p, const OffsetsRow& row, int f,
                                         int (&v)[kVecChunks]) {
  const int e0 = f - row.sh;
  const int4 q = kInside || e0 < row.nc ? __ldg(reinterpret_cast<const int4*>(p + e0))
                                        : make_int4(0, 0, 0, 0);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
  if (!kInside) {
#pragma unroll
    for (int k = 0; k < kVecChunks; ++k)
      if (e0 + k < 0 || e0 + k >= row.nc) v[k] = 0;
  }
}

// Store v + add at frame vector f of the row array p: one int4 where the
// vector lies inside the row, else its chunks inside the row.
template <bool kInside>
__device__ __forceinline__ void store_vec(int32_t* p, const OffsetsRow& row, int f,
                                          const int (&v)[kVecChunks], int add) {
  const int e0 = f - row.sh;
  if (kInside || (e0 >= 0 && e0 + kVecChunks <= row.nc)) {
    *reinterpret_cast<int4*>(p + e0) = make_int4(v[0] + add, v[1] + add, v[2] + add, v[3] + add);
  } else {
#pragma unroll
    for (int k = 0; k < kVecChunks; ++k)
      if (e0 + k >= 0 && e0 + k < row.nc) p[e0 + k] = v[k] + add;
  }
}

__device__ __forceinline__ void flag_sizes(int (&v)[kVecChunks]) {
#pragma unroll
  for (int k = 0; k < kVecChunks; ++k) v[k] = (v[k] + 7) >> 3;  // floor, as the plain version
}

// Exclusive scan, in place, of the tile of rr rounds held as x[v][j][k]
// (value v of chunk k of the lane's vector in round j), plus carry[v];
// carry[v] grows by the tile's sum.  Each round: the lane's partial sums, a
// shuffle scan of the lane sums, and the round's total added to the warp's
// running carry.  Then the warps' totals (sums, 2 x kOffsetWarps ints of
// shared memory) take one cross-warp scan: one barrier.  Consecutive tiles
// use two different sums, so a tile's writes never meet the reads of the
// tile before it.
__device__ __forceinline__ void scan_tile(Tile& x, int rr, int (&carry)[2],
                                          int (*sums)[kOffsetWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int run[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    run[v] = 0;
#pragma unroll
    for (int j = 0; j < kTileRounds; ++j) {
      if (j < rr) {
        int part[kVecChunks];  // the lane's inclusive partial sums
        part[0] = x[v][j][0];
#pragma unroll
        for (int k = 1; k < kVecChunks; ++k) part[k] = part[k - 1] + x[v][j][k];
        const int sum = part[kVecChunks - 1];
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        const int excl = run[v] + incl - sum;
        x[v][j][0] = excl;
#pragma unroll
        for (int k = 1; k < kVecChunks; ++k) x[v][j][k] = excl + part[k - 1];
        run[v] += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
  }
  if (lane == 0) {
    sums[0][warp] = run[0];
    sums[1][warp] = run[1];
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int t = sums[v][lane];
    int incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int base = carry[v] + __shfl_sync(0xffffffffu, incl - t, warp);
    carry[v] += __shfl_sync(0xffffffffu, incl, kOffsetWarps - 1);
#pragma unroll
    for (int j = 0; j < kTileRounds; ++j)
      if (j < rr) {
#pragma unroll
        for (int k = 0; k < kVecChunks; ++k) x[v][j][k] += base;
      }
  }
}

// The tile at f0 of both arrays: its flag sizes into x[0], its payload
// sizes into x[1].
template <bool kInside>
__device__ __forceinline__ void load_tile(const OffsetsRow& row, int f0, Tile& x) {
  const int rr = tile_rounds(row, f0);
#pragma unroll
  for (int j = 0; j < kTileRounds; ++j)
    if (j < rr) {
      const int f = vec_frame(f0, rr, j);
      load_vec<kInside>(row.nt, row, f, x[0][j]);
      load_vec<kInside>(row.ps, row, f, x[1][j]);
    }
#pragma unroll
  for (int j = 0; j < kTileRounds; ++j)
    if (j < rr) flag_sizes(x[0][j]);
}

template <bool kInside>
__device__ __forceinline__ void store_tile(const OffsetsRow& row, int f0, const Tile& x,
                                           int flag_total) {
  const int rr = tile_rounds(row, f0);
#pragma unroll
  for (int j = 0; j < kTileRounds; ++j)
    if (j < rr) {
      const int f = vec_frame(f0, rr, j);
      store_vec<kInside>(row.fo, row, f, x[0][j], 0);
      store_vec<kInside>(row.po, row, f, x[1][j], flag_total);
    }
}

// The row's flag total: each thread sums the flag sizes of its vectors,
// kReduceLoads int4 loads in flight at a time; red is kOffsetWarps ints of
// shared memory.  One barrier.
__device__ __forceinline__ int row_flag_total(const OffsetsRow& row, int* red) {
  int s = 0;
  for (int f0 = 0; f0 < row.len; f0 += kOffsetThreads * kVecChunks * kReduceLoads) {
    int v[kReduceLoads][kVecChunks];
#pragma unroll
    for (int u = 0; u < kReduceLoads; ++u)
      load_vec<false>(row.nt, row, f0 + (u * kOffsetThreads + threadIdx.x) * kVecChunks, v[u]);
#pragma unroll
    for (int u = 0; u < kReduceLoads; ++u) {
      flag_sizes(v[u]);
#pragma unroll
      for (int k = 0; k < kVecChunks; ++k) s += v[u][k];
    }
  }
  s = __reduce_add_sync(0xffffffffu, s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  return __reduce_add_sync(0xffffffffu, red[threadIdx.x & 31]);
}

__global__ void __launch_bounds__(kOffsetThreads, 1)
global_offsets(const int32_t* __restrict__ n_tokens, const int32_t* __restrict__ payload_sizes,
               int nc, int32_t* __restrict__ flag_off, int32_t* __restrict__ pay_off,
               int32_t* __restrict__ totals) {
  __shared__ int sums[2][2][kOffsetWarps];
  const OffsetsRow row = offsets_row(n_tokens, payload_sizes, flag_off, pay_off, nc);
  int carry[2] = {0, 0};
  if (row.len <= kTileChunks) {
    // one tile: its flag total is known before its stores
    Tile x;
    const bool inside = tile_inside(row, 0);
    if (inside) load_tile<true>(row, 0, x);
    else load_tile<false>(row, 0, x);
    scan_tile(x, tile_rounds(row, 0), carry, sums[0]);
    if (inside) store_tile<true>(row, 0, x, carry[0]);
    else store_tile<false>(row, 0, x, carry[0]);
  } else {
    // the flag total first (sums[1] is free until the second tile)
    const int flag_total = row_flag_total(row, sums[1][0]);
    for (int f0 = 0, t = 0; f0 < row.len; f0 += kTileChunks, ++t) {
      Tile x;
      const bool inside = tile_inside(row, f0);
      if (inside) load_tile<true>(row, f0, x);
      else load_tile<false>(row, f0, x);
      scan_tile(x, tile_rounds(row, f0), carry, sums[t & 1]);
      if (inside) store_tile<true>(row, f0, x, flag_total);
      else store_tile<false>(row, f0, x, flag_total);
    }
  }
  if (threadIdx.x == 0) {
    totals[2 * blockIdx.x] = carry[0];
    totals[2 * blockIdx.x + 1] = carry[1];
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
// int32 and totals (rows, 2) int32 = (flag_total, pay_total) per row.  The
// four (rows, nc) arrays start at one residue mod 16 (any multiple of 4).
extern "C" int lz_global_offsets_launch(const void* n_tokens, const void* payload_sizes,
                                        int rows, int nc, void* flag_off, void* pay_off,
                                        void* totals, void* stream) {
  if (rows <= 0) return cudaSuccess;
  const uintptr_t at = reinterpret_cast<uintptr_t>(n_tokens) % 16;
  const void* rest[] = {payload_sizes, flag_off, pay_off};
  for (const void* p : rest)
    if (reinterpret_cast<uintptr_t>(p) % 16 != at) return cudaErrorInvalidValue;
  if (at % 4) return cudaErrorInvalidValue;
  global_offsets<<<rows, kOffsetThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(n_tokens), static_cast<const int32_t*>(payload_sizes), nc,
      static_cast<int32_t*>(flag_off), static_cast<int32_t*>(pay_off),
      static_cast<int32_t*>(totals));
  return cudaGetLastError();
}

// Registers a thread and resident blocks per SM of Kernel II -> out[0..1].
extern "C" int lz_global_offsets_occupancy(void* out) {
  int* o = static_cast<int*>(out);
  return kernel_occupancy(global_offsets, kOffsetThreads, 0, o, o + 1);
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
