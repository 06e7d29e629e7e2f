// Entropy-stage kernels of the deflate-full container for Hopper: the byte
// histogram that feeds the Huffman code lengths, and the gap-array
// parallel canonical-Huffman decoder.
//
// byte_histogram replaces src/repro/kernels/lz_entropy.py:_hist_kernel
// (launched by byte_histogram_pallas).  The TPU kernel walks 1024-byte
// tiles in a sequential grid, widened to int32, one-hot-compares each tile
// with the 256 symbol lanes and accumulates into one revisited block.
// Here the container is read as bytes, 16 per load where the range is
// aligned, by a grid-stride loop; each warp counts into its own 256-bin
// row of shared memory (LZSS flag and payload bytes are dominated by long
// 0x00 / 0xFF runs, so one row per block would put every thread's atomic
// on one bin), and each block adds its bins to the global histogram with
// one atomicAdd per non-empty bin.  Only positions in [start, start+len)
// count; start need not be aligned.  Bound on the H100: the bytes read.
//
// huffman_gap_decode replaces src/repro/kernels/lz_entropy.py:
// _gap_decode_kernel (launched by huffman_gap_decode_pallas).  The TPU
// kernel DMAs a fixed window per gap sub-block into VMEM and range-tests
// all 15 lengths at once on vector lanes.  Here one thread owns one
// sub-block: it starts at the sub-block's bit offset and walks exactly
// `sub` codewords, reading a 24-bit window from the stream for each and
// testing lengths 1..15 in order against the canonical first/count tables,
// which sit in shared memory with the symbol order map.  The canonical
// prefix property makes the first hit the only one.  A window with no hit
// (only past the live codewords of a partial last sub-block) takes length
// 1, as the reference's argmax over an all-false row does, so the kernel
// equals its plain version on every lane.  Bytes past the end of the blob
// read as zeros.  Four decoded bytes are stored as one word.  Bound on the
// H100: the sequential codeword chain inside a sub-block (latency), far
// above the bytes moved; at 512 bytes per sub-block a 37 MB section is
// only ~73 K threads, which leaves most of the card idle.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kGapThreads = 128;
constexpr int kMaxCodeLen = 15;

__device__ __forceinline__ void count_word(unsigned int* h, uint32_t w) {
  atomicAdd(&h[w & 0xFF], 1u);
  atomicAdd(&h[(w >> 8) & 0xFF], 1u);
  atomicAdd(&h[(w >> 16) & 0xFF], 1u);
  atomicAdd(&h[w >> 24], 1u);
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
  const uint4* v = reinterpret_cast<const uint4*>(buf + head);
  for (long long i = tid; i < nvec; i += nthreads) {
    const uint4 w = v[i];
    count_word(h, w.x);
    count_word(h, w.y);
    count_word(h, w.z);
    count_word(h, w.w);
  }
  for (long long i = head + 16 * nvec + tid; i < length; i += nthreads) atomicAdd(&h[buf[i]], 1u);
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    unsigned int s = 0;
#pragma unroll
    for (int w = 0; w < kHistWarps; ++w) s += hist[w][b];
    if (s) atomicAdd(reinterpret_cast<unsigned int*>(out) + b, s);
  }
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* __restrict__ blob, long long n,
                                            long long p) {
  return (p >= 0 && p < n) ? blob[p] : 0u;
}

__global__ void __launch_bounds__(kGapThreads)
gap_decode(const uint8_t* __restrict__ blob, long long blob_len,
           const long long* __restrict__ wstarts, const int32_t* __restrict__ rems, int nsub,
           const int32_t* __restrict__ first, const int32_t* __restrict__ count,
           const int32_t* __restrict__ base, const int32_t* __restrict__ order, int sub,
           uint8_t* __restrict__ out) {
  __shared__ int s_first[kMaxCodeLen + 1], s_count[kMaxCodeLen + 1], s_base[kMaxCodeLen + 1];
  __shared__ uint8_t s_order[256];
  if (threadIdx.x <= kMaxCodeLen) {
    s_first[threadIdx.x] = first[threadIdx.x];
    s_count[threadIdx.x] = count[threadIdx.x];
    s_base[threadIdx.x] = base[threadIdx.x];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_order[i] = static_cast<uint8_t>(order[i]);
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nsub) return;
  long long bit = wstarts[t] * 8 + rems[t];
  uint32_t* o = reinterpret_cast<uint32_t*>(out + t * sub);
  uint32_t word = 0;
  for (int k = 0; k < sub; ++k) {
    const long long pos = bit >> 3;
    const uint32_t w24 = (byte_at(blob, blob_len, pos) << 16) |
                         (byte_at(blob, blob_len, pos + 1) << 8) |
                         byte_at(blob, blob_len, pos + 2);
    const int win = static_cast<int>((w24 >> (9 - (bit & 7))) & 0x7FFF);
    int len = 1;
    int sidx = s_base[1] + (win >> (kMaxCodeLen - 1)) - s_first[1];
    for (int l = 1; l <= kMaxCodeLen; ++l) {
      const int d = (win >> (kMaxCodeLen - l)) - s_first[l];
      if (d >= 0 && d < s_count[l]) {
        len = l;
        sidx = s_base[l] + d;
        break;
      }
    }
    sidx = min(max(sidx, 0), 255);
    word |= static_cast<uint32_t>(s_order[sidx]) << (8 * (k & 3));
    if ((k & 3) == 3) {
      o[k >> 2] = word;
      word = 0;
    }
    bit += len;
  }
}

}  // namespace

// buf: uint8, the `length` bytes from `start` on are counted into out
// (256,) int32, which the caller has zero-filled.
extern "C" int lz_byte_histogram_launch(const void* buf, long long start, long long length,
                                        void* out, void* stream) {
  if (length <= 0) return cudaSuccess;
  const uint8_t* p = static_cast<const uint8_t*>(buf) + start;
  long long head = (16 - static_cast<long long>(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  if (head > length) head = length;
  const long long nvec = (length - head) / 16;
  long long blocks = (nvec + kHistThreads - 1) / kHistThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  byte_histogram<<<static_cast<int>(blocks), kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, head, nvec, length, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

// blob (blob_len,) uint8; wstarts (nsub,) int64 window byte starts; rems
// (nsub,) int32 bit remainders; first/count/base (16,) and order (256,)
// int32 canonical tables -> out (nsub, sub) uint8, sub a multiple of 4.
extern "C" int lz_gap_decode_launch(const void* blob, long long blob_len, const void* wstarts,
                                    const void* rems, int nsub, const void* first,
                                    const void* count, const void* base, const void* order,
                                    int sub, void* out, void* stream) {
  if (nsub <= 0) return cudaSuccess;
  const int blocks = (nsub + kGapThreads - 1) / kGapThreads;
  gap_decode<<<blocks, kGapThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blob), blob_len, static_cast<const long long*>(wstarts),
      static_cast<const int32_t*>(rems), nsub, static_cast<const int32_t*>(first),
      static_cast<const int32_t*>(count), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(order), sub, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
