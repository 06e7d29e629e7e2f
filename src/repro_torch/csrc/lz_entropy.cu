// Entropy-stage kernels of the deflate-full container for Hopper: the byte
// histogram that feeds the Huffman code lengths, and the gap-array
// parallel canonical-Huffman decoder.
//
// byte_histogram replaces src/repro/kernels/lz_entropy.py:_hist_kernel
// (launched by byte_histogram_pallas).  The TPU kernel walks 1024-byte
// tiles in a sequential grid, widened to int32, one-hot-compares each tile
// with the 256 symbol lanes and accumulates into one revisited block.
// Here one wave of resident blocks reads the range as 16-byte vectors from
// its first 16-byte boundary on, in grid-stride turns of kHistUnroll loads
// a lane, with the next turn's loads in flight while a turn is counted
// (the unaligned ends a byte a thread).  Each warp counts into its own
// 256-bin row of shared memory: a vector of one byte value is one
// atomicAdd of 16, a 4-byte word of one value one of 4 (LZSS flag sections
// are mostly 0x00 / 0xFF runs), any other byte one of 1; each block adds
// its bins to the global histogram with one atomicAdd per non-empty bin.
// The loads are streaming (__ldcs, evict-first in L2), so that reading the
// section evicts its own lines before other dirty ones.  Bound on the H100:
// the bytes read.  With the L2 cold it takes within about 10% of what the
// same loads take with no counting (PERF.md); atomics of one warp that meet
// on one bin cost little on this card.  A row counter holds at most the
// bytes its warp read, so counts stay exact below 2^31 bytes.
//
// huffman_gap_decode replaces src/repro/kernels/lz_entropy.py:
// _gap_decode_kernel (launched by huffman_gap_decode_pallas).  The TPU
// kernel DMAs a fixed window per gap sub-block into VMEM and range-tests
// all 15 lengths at once on vector lanes.  Here one lane owns one
// sub-block and walks exactly `sub` codewords from its bit offset, as the
// reference's scan does.  Read from device memory byte by byte, a
// codeword would cost three loads and put a warp's 32 lanes on 32 cache
// lines (sub-blocks lie ~366 bytes apart): ~96 L1 wavefronts per warp and
// codeword.  So:
//
//   * a block's 64 sub-blocks lie one after another in the stream: the
//     block copies their bytes into shared memory with coalesced, aligned
//     16-byte loads, as big-endian words, 33 KB a round (64 sub-blocks of
//     the stored escape and 1 KB).  A lane decodes while the words it needs
//     are staged; the next round starts at the least word an unfinished
//     lane needs, so a code longer than the escape (up to 15 bits, 960
//     bytes a sub-block) takes more rounds and no more shared memory.
//     Bytes past the blob's end are staged as zeros;
//   * a lane keeps its next 64 stream bits in registers and refills them
//     a staged word at a time (read one word ahead);
//   * each block builds a 2^10-entry table in shared memory from the
//     canonical first / count / base / order tables: for every 10-bit
//     prefix that completes a code of at most 10 bits, (length << 8) |
//     symbol, the first such length as in the reference's range test; 0
//     elsewhere.  Where no code is longer than 10 bits, four codewords
//     decode straight-line, the chain of a codeword one table read and a
//     shift, and a 0 (an incomplete code, or bits past the live ones)
//     sends the four back through the range test; with longer codes each
//     codeword branches to the range test over lengths 11..15 on a 0.  Its
//     "no hit -> length 1" rule (only past a partial last sub-block's live
//     codewords) is the reference's argmax over an all-false row, so the
//     kernel equals its plain version on every lane;
//   * 16 decoded bytes are one 16-byte store (sub is a multiple of 16:
//     the container's sub-block is 512 bytes).
//
// Bound on the H100: the codeword chain inside a sub-block (a table read,
// a shift), 512 codewords a lane; the stream and the output are ~0.02 ms
// of HBM traffic at the main path's size.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kGapThreads = 64;
constexpr int kMaxCodeLen = 15;

constexpr int kHistUnroll = 4;  // 16-byte loads a lane issues a turn

// One vector's 16 bytes into the warp's row h.
__device__ __forceinline__ void count_vec(unsigned int* h, const uint4& v) {
  const uint32_t rep = (v.x & 0xFF) * 0x01010101u;
  if (v.x == rep && v.y == rep && v.z == rep && v.w == rep) {
    atomicAdd(&h[v.x & 0xFF], 16u);
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (w[j] == (w[j] & 0xFF) * 0x01010101u) {
      atomicAdd(&h[w[j] & 0xFF], 4u);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) atomicAdd(&h[(w[j] >> (8 * k)) & 0xFF], 1u);
    }
  }
}

__global__ void __launch_bounds__(kHistThreads)
byte_histogram(const uint8_t* __restrict__ buf, long long head, long long nvec,
               long long length, int32_t* __restrict__ out) {
  __shared__ unsigned int hist[kHistWarps][256];
  unsigned int* flat = &hist[0][0];
  for (int i = threadIdx.x; i < kHistWarps * 256; i += blockDim.x) flat[i] = 0;
  __syncthreads();
  unsigned int* h = hist[threadIdx.x >> 5];
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  // buf points at `start`; [0, head) and [head + 16 * nvec, length) are
  // the unaligned ends, read byte by byte
  for (long long i = tid; i < head; i += nthreads) atomicAdd(&h[buf[i]], 1u);
  for (long long i = head + 16 * nvec + tid; i < length; i += nthreads) atomicAdd(&h[buf[i]], 1u);
  const uint4* v = reinterpret_cast<const uint4*>(buf + head);
  uint4 x[kHistUnroll];
#pragma unroll
  for (int u = 0; u < kHistUnroll; ++u) {
    const long long i = tid + u * nthreads;
    x[u] = i < nvec ? __ldcs(v + i) : make_uint4(0, 0, 0, 0);
  }
  for (long long i0 = tid; i0 < nvec; i0 += kHistUnroll * nthreads) {
    uint4 y[kHistUnroll];  // the next turn, loaded before this one is counted
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const long long i = i0 + (kHistUnroll + u) * nthreads;
      y[u] = i < nvec ? __ldcs(v + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (i0 + u * nthreads < nvec) count_vec(h, x[u]);
      x[u] = y[u];
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    unsigned int s = 0;
#pragma unroll
    for (int w = 0; w < kHistWarps; ++w) s += hist[w][b];
    if (s) atomicAdd(reinterpret_cast<unsigned int*>(out) + b, s);
  }
}

constexpr int kLutBits = 10;
// The staged stream of a block: 64 sub-blocks of the stored escape (512
// bytes each) and 1 KB, in 4-byte words.
constexpr int kStageWords = (kGapThreads * 512 + 1024) / 4;

// Four stream bytes as a big-endian word: the stream is MSB-first.
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// The least ``v`` of the block (64 threads), to every thread.
__device__ __forceinline__ long long block_min(long long v, long long* s_min) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = v;
  __syncthreads();
  return min(s_min[0], s_min[1]);
}

// Four codewords with the range test where the table has no entry: from
// the bits in hi:lo (nb of them valid, at least 17), refilled from
// stage[wi...]; their symbols go into ``word`` a byte at a time, on top.
__device__ __forceinline__ void checked_quad(uint32_t& hi, uint32_t& lo, int& nb, int& wi,
                                             uint32_t& word, const uint32_t* stage,
                                             const uint16_t* lut, const int* s_first,
                                             const int* s_count, const int* s_base,
                                             const uint8_t* s_order) {
  for (int j = 0; j < 4; ++j) {
    if (nb < 32) {
      const uint32_t x = stage[wi++];
      hi |= x >> nb;
      lo |= x << (32 - nb);
      nb += 32;
    }
    const uint32_t e = lut[hi >> (32 - kLutBits)];
    int len = e >> 8;
    uint32_t sym = e;
    if (!e) {  // the range test over the longer lengths
      const int wv = static_cast<int>(hi >> (32 - kMaxCodeLen));
      int sidx = s_base[1] + (wv >> (kMaxCodeLen - 1)) - s_first[1];
      len = 1;
      for (int l = kLutBits + 1; l <= kMaxCodeLen; ++l) {
        const int d = (wv >> (kMaxCodeLen - l)) - s_first[l];
        if (d >= 0 && d < s_count[l]) {
          len = l;
          sidx = s_base[l] + d;
          break;
        }
      }
      sym = s_order[min(max(sidx, 0), 255)];
    }
    hi = __funnelshift_l(lo, hi, len);
    lo <<= len;
    nb -= len;
    word = __byte_perm(word, sym, 0x4321);  // the symbol's byte in on top
  }
}

// One sub-block a lane; 16 decoded bytes a store (sub a multiple of 16).
__global__ void __launch_bounds__(kGapThreads)
gap_decode(const uint8_t* __restrict__ blob, long long blob_len,
           const long long* __restrict__ wstarts, const int32_t* __restrict__ rems, int nsub,
           const int32_t* __restrict__ first, const int32_t* __restrict__ count,
           const int32_t* __restrict__ base, const int32_t* __restrict__ order, int sub,
           uint8_t* __restrict__ out) {
  __shared__ int s_first[kMaxCodeLen + 1], s_count[kMaxCodeLen + 1], s_base[kMaxCodeLen + 1];
  __shared__ uint8_t s_order[256];
  __shared__ uint16_t lut[1 << kLutBits];
  __shared__ __align__(16) uint32_t stage[kStageWords];
  __shared__ long long s_min[kGapThreads / 32];
  if (threadIdx.x <= kMaxCodeLen) {
    s_first[threadIdx.x] = first[threadIdx.x];
    s_count[threadIdx.x] = count[threadIdx.x];
    s_base[threadIdx.x] = base[threadIdx.x];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_order[i] = static_cast<uint8_t>(order[i]);
  __syncthreads();
  for (int p = threadIdx.x; p < (1 << kLutBits); p += blockDim.x) {
    uint16_t e = 0;
    for (int l = 1; l <= kLutBits; ++l) {
      const int d = (p >> (kLutBits - l)) - s_first[l];
      if (d >= 0 && d < s_count[l]) {
        e = static_cast<uint16_t>((l << 8) | s_order[min(max(s_base[l] + d, 0), 255)]);
        break;
      }
    }
    lut[p] = e;
  }
  // Codes longer than the table's bits take the range test a codeword at a
  // time; the others decode four codewords straight-line.
  bool long_codes = false;
  for (int l = kLutBits + 1; l <= kMaxCodeLen; ++l) long_codes |= s_count[l] > 0;
  // Stream words are counted from the aligned 16 bytes at or below the
  // blob's start, so that a staged word of four is one aligned load.
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(blob) & 15);
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long bit = t < nsub ? (lead + wstarts[t]) * 8 + rems[t] : 0;
  long long wnext = bit >> 5;  // the next word the lane reads
  const int skip = static_cast<int>(bit & 31);
  // The lane's next stream bits, from the top of hi down through lo; nb
  // of them are valid (-1 before the first two words are read).
  uint32_t hi = 0, lo = 0, word = 0, q0 = 0, q1 = 0, q2 = 0;
  int nb = -1;
  uint8_t* o = out + t * sub;
  int k = t < nsub ? 0 : sub;
  long long wbase = block_min(k < sub ? wnext : LLONG_MAX, s_min) & ~3ll;
  // Rounds: the block stages kStageWords words from the least word any
  // unfinished lane still needs (its sub-blocks lie one after another, so
  // one round holds them all unless the code is longer than the stored
  // escape), and each lane decodes while its words are staged.
  for (;;) {
    constexpr int kBatch = 4;  // 16-byte words loaded before any is stored
    for (int i0 = threadIdx.x; i0 < kStageWords / 4; i0 += kBatch * blockDim.x) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        const long long b0 = 4 * (wbase + 4 * i) - lead;  // blob byte of the first
        if (i >= kStageWords / 4 || (b0 >= 0 && b0 + 16 <= blob_len)) {
          v[u] = i < kStageWords / 4 ? *reinterpret_cast<const uint4*>(blob + b0) : make_uint4(0, 0, 0, 0);
        } else {  // at the blob's two ends: every byte load issued, clamped into it
          uint32_t x[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const long long q = b0 + j;
            const uint32_t c = blob_len > 0 ? blob[q < 0 ? 0 : (q < blob_len ? q : blob_len - 1)] : 0;
            x[j >> 2] |= (q >= 0 && q < blob_len ? c : 0u) << (8 * (j & 3));
          }
          v[u] = make_uint4(x[0], x[1], x[2], x[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < kStageWords / 4)
          reinterpret_cast<uint4*>(stage)[i] =
              make_uint4(bswap(v[u].x), bswap(v[u].y), bswap(v[u].z), bswap(v[u].w));
      }
    }
    __syncthreads();
    // four codewords need at most two more words: decode while both are staged
    const long long rel = wnext - wbase;
    const bool staged = rel >= 0 && rel < kStageWords;
    int wi = staged ? static_cast<int>(rel) : kStageWords;
    if (k < sub && nb < 0 && wi + 1 < kStageWords) {
      const uint32_t w0 = stage[wi], w1 = stage[wi + 1];
      hi = __funnelshift_l(w1, w0, skip);
      lo = w1 << skip;
      nb = 64 - skip;
      wi += 2;
    }
    uint32_t nx = stage[min(wi, kStageWords - 1)];  // the next word, read ahead
    while (k < sub && nb >= 0 && wi + 1 < kStageWords) {
      if (long_codes) {  // a branch a codeword
        checked_quad(hi, lo, nb, wi, word, stage, lut, s_first, s_count, s_base, s_order);
      } else {
        // Four codewords from the table alone, straight-line: the chain of
        // a codeword is a table read and a shift.  A window no code of the
        // table's bits holds (entry 0: an incomplete code, read past the
        // live bits) sends the quad back to the range test.
        const uint32_t hi0 = hi, lo0 = lo, word0 = word;
        const int nb0 = nb, wi0 = wi;
        bool miss = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nb < 32) {  // nb >= 17 here: the word lands across hi and lo
            hi |= nx >> nb;
            lo |= nx << (32 - nb);
            nb += 32;
            nx = stage[min(++wi, kStageWords - 1)];
          }
          const uint32_t e = lut[hi >> (32 - kLutBits)];
          const int len = e >> 8;
          miss |= e == 0;
          hi = __funnelshift_l(lo, hi, len);
          lo <<= len;
          nb -= len;
          word = __byte_perm(word, e, 0x4321);  // the symbol's byte in on top
        }
        if (miss) {
          hi = hi0, lo = lo0, word = word0, nb = nb0, wi = wi0;
          checked_quad(hi, lo, nb, wi, word, stage, lut, s_first, s_count, s_base, s_order);
          nx = stage[min(wi, kStageWords - 1)];
        }
      }
      k += 4;
      if ((k & 15) == 0) *reinterpret_cast<uint4*>(o + k - 16) = make_uint4(q0, q1, q2, word);
      q0 = q1;
      q1 = q2;
      q2 = word;
    }
    if (staged) wnext = wbase + wi;
    const int more = k < sub;
    if (!__syncthreads_or(more)) break;
    wbase = block_min(more ? wnext : LLONG_MAX, s_min) & ~3ll;
  }
}

}  // namespace

// buf: uint8, the `length` bytes from `start` on are counted into out
// (256,) int32, which the caller has zero-filled.
extern "C" int lz_byte_histogram_launch(const void* buf, long long start, long long length,
                                        void* out, void* stream) {
  if (length <= 0) return cudaSuccess;
  static int wave = 0;  // resident blocks on the whole card, asked once
  if (wave == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, byte_histogram, kHistThreads, 0);
    if (err != cudaSuccess) return err;
    wave = sms * per_sm;
  }
  const uint8_t* p = static_cast<const uint8_t*>(buf) + start;
  long long head = (16 - static_cast<long long>(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  if (head > length) head = length;
  const long long nvec = (length - head) / 16;
  long long blocks = (nvec + kHistUnroll * kHistThreads - 1) / (kHistUnroll * kHistThreads);
  if (blocks < 1) blocks = 1;
  if (blocks > wave) blocks = wave;
  byte_histogram<<<static_cast<int>(blocks), kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, head, nvec, length, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

// Registers a thread and resident blocks per SM of the histogram ->
// out[0], out[1].
extern "C" int lz_byte_histogram_occupancy(void* out) {
  int* o = static_cast<int*>(out);
  return kernel_occupancy(byte_histogram, kHistThreads, 0, o, o + 1);
}

// blob (blob_len,) uint8; wstarts (nsub,) int64 window byte starts; rems
// (nsub,) int32 bit remainders; first/count/base (16,) and order (256,)
// int32 canonical tables -> out (nsub, sub) uint8, sub a multiple of 16.
extern "C" int lz_gap_decode_launch(const void* blob, long long blob_len, const void* wstarts,
                                    const void* rems, int nsub, const void* first,
                                    const void* count, const void* base, const void* order,
                                    int sub, void* out, void* stream) {
  if (sub <= 0 || sub % 16) return cudaErrorInvalidValue;
  if (nsub <= 0) return cudaSuccess;
  const int blocks = (nsub + kGapThreads - 1) / kGapThreads;
  const auto* b = static_cast<const uint8_t*>(blob);
  const auto* ws = static_cast<const long long*>(wstarts);
  const auto* rm = static_cast<const int32_t*>(rems);
  const auto *f = static_cast<const int32_t*>(first), *c = static_cast<const int32_t*>(count);
  const auto *ba = static_cast<const int32_t*>(base), *od = static_cast<const int32_t*>(order);
  auto* o = static_cast<uint8_t*>(out);
  gap_decode<<<blocks, kGapThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b, blob_len, ws, rm, nsub, f, c, ba, od, sub, o);
  return cudaGetLastError();
}

// Registers a thread and resident blocks per SM of the gap decoder ->
// out[0], out[1].
extern "C" int lz_gap_decode_occupancy(void* out) {
  int* o = static_cast<int*>(out);
  return kernel_occupancy(gap_decode, kGapThreads, 0, o, o + 1);
}
