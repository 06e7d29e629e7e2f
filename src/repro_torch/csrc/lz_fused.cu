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
//      shared memory (the warp-synchronous window walk, the selection
//      thread and the block scan of kernel1.cuh); then the chunk's compact
//      payload bytes and flag bytes go to a staging workspace at fixed
//      per-chunk strides (C*S and C/8 bytes), its n_tokens / payload_sizes
//      to their tables, and both sizes are added (atomics) to the sums of
//      its segment of 256 chunks.  One block scan per tile carries both the
//      payload offset (low 16 bits) and the token rank (high bits).
//      Literals are re-read from the symbols in device memory: their shared
//      copy holds the emit flags and flag words by then, which keeps the
//      shared need at C * (S + 2) bytes or less.  With each chunk the block
//      also zeroes a slice of the containers (16-byte stores, which overlap
//      the walk);
//   B. Kernel II over the whole grid: each block takes a segment, bases it
//      on the sums of the row's earlier segments and scans its 256 chunks'
//      flag and payload sizes, payload offsets pre-based by the flag total;
//   C. Kernel III: each warp copies one chunk's staged bytes to their final
//      offsets over the zeros, 4-byte stores of words assembled by funnel
//      shifts.
//
// The separate workspace keeps the phases free of races and leaves no stale
// staging bytes in the container.  Against the split path it saves the
// round trip of Kernel I's (nc, C) outputs through device memory (13 bytes
// written and 17 read per position).  Bound on the H100: the window walk,
// as for Kernel I; the bytes (4 in per position, the container written
// once) are far below it at W = 128.  Phases B and C once scanned a
// buffer's sizes in one block and copied one byte per thread, and took
// 0.156 and 0.152 ms at 128 MiB of hurr-quant, waiting on memory latency;
// spread over the grid, and a warp per chunk, they take 0.004 and 0.059 ms
// (globaltimer stamps around the grid barriers, H100).  The kernel is held
// to 32 registers a thread so that 8 blocks stay resident on each SM: with
// the warp walk that spills a little, and is still faster than 6 blocks at
// 40 registers or 4 at 64 (5.82, 5.98 and 6.61 ms at 128 MiB).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "kernel1.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kSeg = kThreads;  // chunks a phase-B item scans

// Shared bytes ahead of the length / offset rows: the symbols during the
// walk, then the emit flags (C bytes) and the flag words (C / 8 bytes,
// rounded to words).
size_t head_bytes(int C, int S) {
  const size_t sym = static_cast<size_t>(C) * S;
  const size_t flags = static_cast<size_t>(C) + 4 * static_cast<size_t>((C + 31) / 32);
  return sym > flags ? sym : flags;
}

// Copy n bytes with the 32 lanes of a warp: 4-byte stores to the aligned
// words of dst, each assembled from two aligned words of src by a funnel
// shift (reading at most 4 bytes past src + n), bytes at the head and tail.
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src, int n, int lane) {
  const int head = min(n, static_cast<int>((4 - (reinterpret_cast<uintptr_t>(dst) & 3)) & 3));
  if (lane < head) dst[lane] = src[lane];
  dst += head;
  src += head;
  n -= head;
  const int sa = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(src - sa);
  uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
  const int nw = n >> 2;
  for (int j = lane; j < nw; j += 32)
    dw[j] = __funnelshift_r(sw[j], sa ? sw[j + 1] : 0u, 8 * sa);
  if (lane < n - 4 * nw) dst[4 * nw + lane] = src[4 * nw + lane];
}

template <typename Sym>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_mono(const int32_t* __restrict__ symbols, int rows, int nc, int C, int S, int W,
           int min_match, long long head, long long sec_flags, long long cap,
           int* __restrict__ work, uint8_t* __restrict__ stage, int32_t* __restrict__ flag_off,
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
  const int nseg = (nc + kSeg - 1) / kSeg;
  int* ticket = work;
  int* seg = work + 1;  // (rows, nseg, 2): flag and payload bytes of kSeg chunks
  cg::grid_group grid = cg::this_grid();
  __shared__ long long next;
  // the container's zeros: a slice with each chunk taken, 16-byte stores
  // that overlap the walk; the sections are written over them in phase C
  const long long zvec = rows * cap / 16;

  // ---- A: Kernel I and the chunk's compact bytes, staged.  Chunks are
  // taken from an atomic ticket: their walks differ in cost, and a block
  // that finishes early takes the next one, as the hardware's block
  // scheduler does for Kernel I.
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1);
    __syncthreads();
    const long long chunk = next;
    if (chunk >= n_all) break;
    uint4* zv = reinterpret_cast<uint4*>(blob);
    for (long long j = chunk * zvec / n_all + threadIdx.x; j < (chunk + 1) * zvec / n_all;
         j += blockDim.x)
      zv[j] = make_uint4(0, 0, 0, 0);
    if (chunk == n_all - 1)
      for (long long j = 16 * zvec + threadIdx.x; j < rows * cap; j += blockDim.x) blob[j] = 0;
    const long long base = chunk * C;
    gplz::load_chunk(symbols + base, C, sym);
    __syncthreads();
    gplz::walk_chunk(sym, C, W, [&](int i, int len, int off) {
      slen[i] = static_cast<uint8_t>(len);
      soff[i] = static_cast<uint8_t>(off);
    });
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
      int* sg = seg + 2 * ((chunk / nc) * nseg + (chunk % nc) / kSeg);
      atomicAdd(sg, (ntok + 7) / 8);
      atomicAdd(sg + 1, carry);
    }
    __syncthreads();  // before the next chunk's symbols overwrite the flags
  }
  grid.sync();

  // ---- B: Kernel II over the whole grid.  Each block takes (row, segment)
  // items: the segment's bases are the sums of the row's earlier segments
  // (added up in phase A), and one block scan of its kSeg = blockDim chunks
  // gives their offsets; payload offsets are pre-based by the flag total.
  for (long long item = blockIdx.x; item < static_cast<long long>(rows) * nseg;
       item += gridDim.x) {
    const int r = static_cast<int>(item / nseg), sg = static_cast<int>(item % nseg);
    const int* srow = seg + 2LL * r * nseg;
    int f_pre = 0, f_all = 0, p_pre = 0, p_all = 0;
    for (int j = threadIdx.x; j < nseg; j += blockDim.x) {
      const int f = srow[2 * j], pz = srow[2 * j + 1];
      f_all += f;
      p_all += pz;
      if (j < sg) {
        f_pre += f;
        p_pre += pz;
      }
    }
    const int flag_total = block_sum(f_all, warp_sums), pay_total = block_sum(p_all, warp_sums);
    f_pre = block_sum(f_pre, warp_sums);
    p_pre = block_sum(p_pre, warp_sums);
    const long long row = static_cast<long long>(r) * nc;
    const int i = sg * kSeg + threadIdx.x;
    const int fs = i < nc ? (n_tokens[row + i] + 7) / 8 : 0;
    const int ps = i < nc ? payload_sizes[row + i] : 0;
    int unused;
    const int fe = block_excl_scan(fs, &unused, warp_sums);
    const int pe = block_excl_scan(ps, &unused, warp_sums);
    if (i < nc) {
      flag_off[row + i] = f_pre + fe;
      pay_off[row + i] = flag_total + p_pre + pe;
    }
    if (sg == 0 && threadIdx.x == 0) {
      totals[2 * r] = flag_total;
      totals[2 * r + 1] = pay_total;
    }
  }
  grid.sync();

  // ---- C: Kernel III, the staged bytes to their offsets, a warp a chunk
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (long long chunk = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5);
       chunk < n_all; chunk += static_cast<long long>(gridDim.x) * warps) {
    uint8_t* section = blob + (chunk / nc) * cap + sec_flags;
    warp_copy(section + flag_off[chunk], stage_flags + chunk * cb, (n_tokens[chunk] + 7) / 8,
              lane);
    warp_copy(section + pay_off[chunk], stage_pay + chunk * C * S, payload_sizes[chunk], lane);
  }
}

size_t smem_bytes(int C, int S) {
  return head_bytes(C, S) + 2 * static_cast<size_t>(C);
}

template <typename Sym>
cudaError_t launch(const void* symbols, int rows, int nc, int C, int S, int W, int min_match,
                   long long sec_flags, long long cap, void* work, void* stage, void* flag_off,
                   void* pay_off, void* blob, void* n_tokens, void* payload_sizes,
                   void* totals, cudaStream_t stream) {
  long long head = static_cast<long long>(head_bytes(C, S));
  const size_t smem = smem_bytes(C, S);
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
  int* work_p = static_cast<int*>(work);
  void* args[] = {&sym, &rows, &nc, &C, &S, &W, &min_match, &head,
                  &sec_flags, &cap, &work_p, &stage_p, &flag_off_p, &pay_off_p, &blob_p,
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
// int32 = (flag_total, pay_total).  work is 1 + 2 * rows * ceil(nc / 256)
// int32 the caller has zeroed (the chunk ticket and the segment sums);
// stage is rows * nc * (C/8 + C*S) + 16 bytes and flag_off, pay_off
// rows * nc int32 of workspace.
// Returns a cudaError_t code (0 on success).
extern "C" int lz_fused_mono_launch(const void* symbols, int rows, int nc, int C, int S, int W,
                                    int min_match, long long sec_flags, long long cap,
                                    void* work, void* stage, void* flag_off, void* pay_off,
                                    void* blob, void* n_tokens, void* payload_sizes,
                                    void* totals, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return launch<uint8_t>(symbols, rows, nc, C, S, W, min_match, sec_flags, cap, work, stage,
                             flag_off, pay_off, blob, n_tokens, payload_sizes, totals, st);
    case 2:
      return launch<uint16_t>(symbols, rows, nc, C, S, W, min_match, sec_flags, cap, work, stage,
                              flag_off, pay_off, blob, n_tokens, payload_sizes, totals, st);
    case 4:
      return launch<uint32_t>(symbols, rows, nc, C, S, W, min_match, sec_flags, cap, work, stage,
                              flag_off, pay_off, blob, n_tokens, payload_sizes, totals, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0..1] = registers a thread and resident blocks per SM of the kernel at
// symbol size S and chunk C.  Returns a cudaError_t code (0 on success).
extern "C" int lz_fused_occupancy(int S, int C, void* out) {
  int* o = static_cast<int*>(out);
  switch (S) {
    case 1:
      return kernel_occupancy(fused_mono<uint8_t>, kThreads, smem_bytes(C, S), o, o + 1);
    case 2:
      return kernel_occupancy(fused_mono<uint16_t>, kThreads, smem_bytes(C, S), o, o + 1);
    case 4:
      return kernel_occupancy(fused_mono<uint32_t>, kThreads, smem_bytes(C, S), o, o + 1);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
