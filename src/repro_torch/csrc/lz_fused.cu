// The one-launch GPULZ compressor for Hopper: Kernels I, II and III in one
// persistent cooperative kernel, for every chunk of every buffer of a batch.
//
// Replaces src/repro/kernels/lz_fused.py:_mono_kernel (launched by
// lz_fused_mono_pallas).  The TPU kernel runs its grid in order, so it
// carries both global prefix sums as SMEM scalars from block to block and
// stages the payload past the worst-case flag section, then "slides" it
// down once the flag total is known.  Blocks on Hopper run concurrently and
// in no order, so neither carries over.  Instead the launch is cooperative
// (every block resident at once, at most the occupancy limit times the SM
// count) and runs three phases split by grid-wide barriers:
//
//   A. each block takes chunks from an atomic ticket, so that one whose
//      chunks walk faster takes more of them, and runs Kernel I on each in
//      shared memory (the window walk, the selection thread and the block
//      scan of kernel1.cuh); then the chunk's compact payload bytes and
//      flag bytes go to a staging workspace at fixed per-chunk strides
//      (C*S and C/8 bytes), and its
//      n_tokens / payload_sizes to their tables.  One block scan per tile
//      carries both the payload offset (low 16 bits) and the token rank
//      (high bits).  Literals are re-read from the symbols in device
//      memory: their shared copy holds the emit flags and flag words by
//      then, which keeps the shared need at C * (S + 2) bytes or less;
//   B. one block per buffer scans the per-chunk flag and payload sizes
//      (Kernel II), each thread over a run of chunks, payload offsets
//      pre-based by the flag total;
//   C. each block copies its chunks' staged bytes to their final offsets
//      (Kernel III), and the grid zero-fills the header / table region and
//      everything from the live end to the buffer's capacity.
//
// The separate workspace keeps the phases free of races and leaves no stale
// staging bytes in the container.  Against the split path it saves the
// round trip of Kernel I's (nc, C) outputs through device memory (13 bytes
// written and 17 read per position).  Bound on the H100: the window walk's
// compares, as for Kernel I; the bytes (4 in per position, the container
// written once) are far below them at W = 128.  The kernel is held to 32
// registers a thread so that 8 blocks stay resident on each SM, as they do
// for Kernel I: the walk is latency-bound.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "kernel1.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// Shared bytes ahead of the length / offset rows: the symbols during the
// walk, then the emit flags (C bytes) and the flag words (C / 8 bytes,
// rounded to words).
size_t head_bytes(int C, int S) {
  const size_t sym = static_cast<size_t>(C) * S;
  const size_t flags = static_cast<size_t>(C) + 4 * static_cast<size_t>((C + 31) / 32);
  return sym > flags ? sym : flags;
}

// Zero n bytes at p with the grid's threads: 16-byte stores between an
// unaligned head and tail.
__device__ void zero_bytes(uint8_t* p, long long n, long long tid, long long stride) {
  const long long mis = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  const long long head = min(n, mis);
  for (long long j = tid; j < head; j += stride) p[j] = 0;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  const long long nv = (n - head) / 16;
  for (long long j = tid; j < nv; j += stride) v[j] = make_uint4(0, 0, 0, 0);
  for (long long j = head + 16 * nv + tid; j < n; j += stride) p[j] = 0;
}

template <typename Sym>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_mono(const int32_t* __restrict__ symbols, int rows, int nc, int C, int S, int W,
           int min_match, long long head, long long sec_flags, long long cap,
           int* __restrict__ ticket, uint8_t* __restrict__ stage, int32_t* __restrict__ flag_off,
           int32_t* __restrict__ pay_off, uint8_t* __restrict__ blob,
           int32_t* __restrict__ n_tokens, int32_t* __restrict__ payload_sizes,
           int32_t* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  Sym* sym = reinterpret_cast<Sym*>(smem);
  uint8_t* emit = smem;
  uint32_t* flag_words = reinterpret_cast<uint32_t*>(smem + C);
  uint8_t* slen = smem + head;
  uint8_t* soff = slen + C;
  const long long n_all = static_cast<long long>(rows) * nc;
  const int cb = C / 8;
  const int nwords = (C + 31) / 32;
  uint8_t* stage_flags = stage;
  uint8_t* stage_pay = stage + n_all * cb;
  cg::grid_group grid = cg::this_grid();
  __shared__ long long next;

  // ---- A: Kernel I and the chunk's compact bytes, staged.  Chunks are
  // taken from an atomic ticket: their walks differ in cost, and a block
  // that finishes early takes the next one, as the hardware's block
  // scheduler does for Kernel I.
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1);
    __syncthreads();
    const long long chunk = next;
    if (chunk >= n_all) break;
    const long long base = chunk * C;
    gplz::load_chunk(symbols + base, C, sym);
    __syncthreads();
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      const int2 m = gplz::best_match(sym, i, C, W);
      slen[i] = static_cast<uint8_t>(m.x);
      soff[i] = static_cast<uint8_t>(m.y);
    }
    __syncthreads();  // the symbols are dead from here
    for (int w = threadIdx.x; w < nwords; w += blockDim.x) flag_words[w] = 0;
    gplz::select_tokens(slen, emit, C, min_match);  // its barriers order the zeros too

    uint8_t* pay = stage_pay + chunk * C * S;
    int carry = 0, ntok = 0;
    for (int tile = 0; tile < C; tile += blockDim.x) {
      const int i = tile + threadIdx.x;
      const int e = i < C ? emit[i] : 0;
      const int len = e ? slen[i] : 0;
      const int size = gplz::token_size(e, len, min_match, S);
      int total;
      // a tile's sizes sum to at most 4 * blockDim < 2^16
      const int excl = block_excl_scan(size | (e << 16), &total, warp_sums);
      if (e) {
        const int rank = ntok + (excl >> 16);
        uint8_t* dst = pay + carry + (excl & 0xFFFF);
        if (len >= min_match) {
          // little-endian: bit rank % 8 of byte rank / 8 is bit rank % 32
          // of word rank / 32
          atomicOr(&flag_words[rank >> 5], 1u << (rank & 31));
          dst[0] = static_cast<uint8_t>(len);
          dst[1] = soff[i];
        } else {
          const uint32_t v = static_cast<uint32_t>(symbols[base + i]);
          for (int b = 0; b < S; ++b) dst[b] = static_cast<uint8_t>(v >> (8 * b));
        }
      }
      carry += total & 0xFFFF;
      ntok += total >> 16;
    }
    __syncthreads();  // every flag bit is set
    const uint8_t* fbytes = reinterpret_cast<const uint8_t*>(flag_words);
    for (int j = threadIdx.x; j < (ntok + 7) / 8; j += blockDim.x)
      stage_flags[chunk * cb + j] = fbytes[j];
    if (threadIdx.x == 0) {
      n_tokens[chunk] = ntok;
      payload_sizes[chunk] = carry;
    }
    __syncthreads();  // before the next chunk's symbols overwrite the flags
  }
  grid.sync();

  // ---- B: Kernel II, one block per buffer.  Each thread sums a run of
  // ceil(nc / blockDim) chunks, one block scan of those sums gives each
  // run's base, and the thread writes its run's offsets: two block scans a
  // buffer, not two per tile of chunks.
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long row = static_cast<long long>(r) * nc;
    const int per = (nc + blockDim.x - 1) / blockDim.x;
    const int lo = min(nc, static_cast<int>(threadIdx.x) * per), hi = min(nc, lo + per);
    int fsum = 0, psum = 0;
    for (int i = lo; i < hi; ++i) {
      fsum += (n_tokens[row + i] + 7) / 8;
      psum += payload_sizes[row + i];
    }
    int flag_total, pay_total;
    int f = block_excl_scan(fsum, &flag_total, warp_sums);
    int p = flag_total + block_excl_scan(psum, &pay_total, warp_sums);
    for (int i = lo; i < hi; ++i) {
      flag_off[row + i] = f;
      pay_off[row + i] = p;
      f += (n_tokens[row + i] + 7) / 8;
      p += payload_sizes[row + i];
    }
    if (threadIdx.x == 0) {
      totals[2 * r] = flag_total;
      totals[2 * r + 1] = pay_total;
    }
  }
  grid.sync();

  // ---- C: Kernel III, the staged bytes to their offsets, and the zeros
  for (long long chunk = blockIdx.x; chunk < n_all; chunk += gridDim.x) {
    uint8_t* section = blob + (chunk / nc) * cap + sec_flags;
    const uint8_t* sf = stage_flags + chunk * cb;
    uint8_t* df = section + flag_off[chunk];
    const int fsz = (n_tokens[chunk] + 7) / 8, psz = payload_sizes[chunk];
    for (int j = threadIdx.x; j < fsz; j += blockDim.x) df[j] = sf[j];
    const uint8_t* sp = stage_pay + chunk * C * S;
    uint8_t* dp = section + pay_off[chunk];
    for (int j = threadIdx.x; j < psz; j += blockDim.x) dp[j] = sp[j];
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int r = 0; r < rows; ++r) {
    uint8_t* row = blob + r * cap;
    zero_bytes(row, sec_flags, tid, stride);
    const long long live = sec_flags + totals[2 * r] + totals[2 * r + 1];
    zero_bytes(row + live, cap - live, tid, stride);
  }
}

template <typename Sym>
cudaError_t launch(const void* symbols, int rows, int nc, int C, int S, int W, int min_match,
                   long long sec_flags, long long cap, void* ticket, void* stage, void* flag_off,
                   void* pay_off, void* blob, void* n_tokens, void* payload_sizes,
                   void* totals, cudaStream_t stream) {
  long long head = static_cast<long long>(head_bytes(C, S));
  const size_t smem = static_cast<size_t>(head) + 2 * static_cast<size_t>(C);
  auto kernel = fused_mono<Sym>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long n_all = static_cast<long long>(rows) * nc;
  const long long want = n_all > rows ? n_all : rows;
  const long long most = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(want < most ? want : most);

  const int32_t* sym = static_cast<const int32_t*>(symbols);
  uint8_t* stage_p = static_cast<uint8_t*>(stage);
  int32_t* flag_off_p = static_cast<int32_t*>(flag_off);
  int32_t* pay_off_p = static_cast<int32_t*>(pay_off);
  uint8_t* blob_p = static_cast<uint8_t*>(blob);
  int32_t* n_tokens_p = static_cast<int32_t*>(n_tokens);
  int32_t* payload_sizes_p = static_cast<int32_t*>(payload_sizes);
  int32_t* totals_p = static_cast<int32_t*>(totals);
  int* ticket_p = static_cast<int*>(ticket);
  void* args[] = {&sym, &rows, &nc, &C, &S, &W, &min_match, &head,
                  &sec_flags, &cap, &ticket_p, &stage_p, &flag_off_p, &pay_off_p, &blob_p,
                  &n_tokens_p, &payload_sizes_p, &totals_p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// (rows * nc, C) int32 symbols -> blob (rows, cap) uint8 with each row's
// flag section at sec_flags, its payload section right after, zeros
// elsewhere; n_tokens, payload_sizes (rows * nc,) int32; totals (rows, 2)
// int32 = (flag_total, pay_total).  ticket is one int32 the caller has
// zeroed; stage is rows * nc * (C/8 + C*S) bytes and flag_off, pay_off
// rows * nc int32 of workspace.
// Returns a cudaError_t code (0 on success).
extern "C" int lz_fused_mono_launch(const void* symbols, int rows, int nc, int C, int S, int W,
                                    int min_match, long long sec_flags, long long cap,
                                    void* ticket, void* stage, void* flag_off, void* pay_off,
                                    void* blob, void* n_tokens, void* payload_sizes,
                                    void* totals, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return launch<uint8_t>(symbols, rows, nc, C, S, W, min_match, sec_flags, cap, ticket, stage,
                             flag_off, pay_off, blob, n_tokens, payload_sizes, totals, st);
    case 2:
      return launch<uint16_t>(symbols, rows, nc, C, S, W, min_match, sec_flags, cap, ticket, stage,
                              flag_off, pay_off, blob, n_tokens, payload_sizes, totals, st);
    case 4:
      return launch<uint32_t>(symbols, rows, nc, C, S, W, min_match, sec_flags, cap, ticket, stage,
                              flag_off, pay_off, blob, n_tokens, payload_sizes, totals, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
