// The GPULZ decode chain of one chunk, shared by the split decoder
// (lz_decode.cu) and the one-launch decoder (lz_decode_mono.cu), with the
// math of src/repro/kernels/lz_decode.py:_decode_values:
//
//   * tokens: a thread owns ceil(ntok / blockDim) consecutive tokens.  The
//     pointers before its first token (popcounts of the flag words, scanned
//     by each warp) give its payload offset, as a token reads [2 | S]
//     bytes; one block scan of the threads' output lengths gives its write
//     position.  A token then marks its first output position with a key,
//     (position << 9) | (pointer << 8) | offset, and a literal writes its
//     symbol there;
//   * fill: a block-wide max-scan of the keys gives every output position
//     the token that covers it (keys grow with the position), and so the
//     position its symbol is copied from: w - offset for a pointer, w for a
//     literal.  No thread walks a long copy alone;
//   * rounds: pointer jumping over that u16 row, in place, up to four jumps
//     a round, until a round changes nothing (__syncthreads_or), at most
//     ceil(log2 C) rounds.  It is exact because every source lies before
//     its copy: the row is a forest rooted at literals, and a value read
//     mid-round is only ever nearer the root;
//   * gather: each position takes its root's symbol.
//
// Two layouts of shared memory, chosen by the launcher from C and S:
//
//   staged  the chunk's flag and payload bytes are first copied into
//           shared memory with aligned 16-byte loads, both at once, so
//           that the token passes read shared memory; the literals are
//           written to a row of shared memory (u16 where S <= 2), and the
//           output row is written once, with 16-byte stores.  4C bytes of
//           keys / sources, the literal row and the two sections: 16.7 KB
//           at C=2048, S=2, so 10 blocks of 128 threads share an SM;
//   rows    for chunks too large for that: the 4C bytes of the key / u16
//           row only, the sections read from device memory, the output
//           zero-filled, its literals written and then gathered in device
//           memory.
//
// A position no token covers, and one whose copy chain ends at a pointer
// (a corrupt container), decodes to zero, as the reference's lit = 0 for
// pointer tokens gives.  The chunk's sections are described by ``Sections``:
// flag byte j (j < C / 8) and payload byte k (0 <= k < C * S), each 0 where
// the section holds no such byte.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "block_scan.cuh"

namespace gplz {

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Output positions a thread owns in the fill, the rounds and the gather
// (C is a multiple of 8).
constexpr int kRun = 8;
// Pointer jumps a thread makes on its positions between two barriers.
constexpr int kJumps = 4;

// ceil(log2 C), at least 1: the most pointer-doubling rounds a chunk needs.
inline int doubling_rounds(int C) {
  int rounds = 0;
  while ((1 << rounds) < C) ++rounds;
  return rounds < 1 ? 1 : rounds;
}

// Bytes of shared memory for ``n`` staged bytes at any address mod 16.
inline __host__ __device__ int staged_bytes(int n) { return ((n + 15) & ~15) + 16; }

// The staged layout is taken where it fits a block beside the 128 bytes of
// static shared memory (232,448 bytes a block on sm_90).
constexpr size_t kStagedSmemLimit = 232448 - 1024;

// A chunk's two sections: flag byte j is f[j] for flo <= j < fhi, payload
// byte k is p[k] for plo <= k < phi, every other byte 0.  Whole 16-byte
// words may be read from f[fsafe_lo .. fsafe_hi) and p[psafe_lo ..
// psafe_hi) (the array the section lies in).
struct Sections {
  const uint8_t* f;
  int flo, fhi;
  const uint8_t* p;
  int plo, phi;
  long long fsafe_lo, fsafe_hi, psafe_lo, psafe_hi;
  __device__ int flag(int j) const { return j >= flo && j < fhi ? f[j] : 0; }
  __device__ int pay(int k) const { return k >= plo && k < phi ? p[k] : 0; }
  // flag bytes 4i .. 4i + 3, little-endian
  __device__ uint32_t flag_word(int i) const {
    return flag(4 * i) | flag(4 * i + 1) << 8 | flag(4 * i + 2) << 16 |
           static_cast<uint32_t>(flag(4 * i + 3)) << 24;
  }
};

// The same sections once staged in shared memory: flag byte j at
// fw[fsh + j] (fw 16-byte aligned), payload byte k at p[k].
struct StagedSections {
  const uint8_t* fw;
  int fsh;
  const uint8_t* p;
  __device__ int flag(int j) const { return fw[fsh + j]; }
  __device__ int pay(int k) const { return p[k]; }
  __device__ uint32_t flag_word(int i) const {
    const int b = fsh + 4 * i;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(fw) + (b >> 2);
    return __funnelshift_r(w[0], w[1], 8 * (b & 3));
  }
};

// ``x`` (the four bytes from k on) with the bytes outside [lo, hi) zeroed.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t x, int k, int lo, int hi) {
  const int below = clampi(lo - k, 0, 4), upto = clampi(hi - k, 0, 4);
  return x & static_cast<uint32_t>((0xFFFFFFFFull << (8 * below)) & ((1ull << (8 * upto)) - 1));
}

// Copy bytes [lo, hi) of the section at ``sec`` to dst[shift + k], and 0 to
// every other k in [0, n), shift being the section's address mod 16, so
// that each 16-byte word is one aligned load: whole where the word lies in
// [lo, hi), masked where it only lies in [safe_lo, safe_hi), byte by byte
// (every load issued, clamped into [lo, hi)) at the array's two ends.
// ``dst`` is 16-byte aligned with staged_bytes(n) bytes.  Returns dst + shift.
__device__ __forceinline__ const uint8_t* stage_section(uint8_t* dst, const uint8_t* sec, int lo,
                                                        int hi, int n, long long safe_lo,
                                                        long long safe_hi) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(sec) & 15);
  const int words = (shift + n + 15) >> 4;
  for (int q = threadIdx.x; q < words; q += blockDim.x) {
    const int k0 = 16 * q - shift;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (hi <= lo || k0 + 16 <= lo || k0 >= hi) {
      // no byte of the section
    } else if (k0 >= safe_lo && k0 + 16 <= safe_hi) {
      v = *reinterpret_cast<const uint4*>(sec + k0);
      if (k0 < lo || k0 + 16 > hi) {
        v.x = keep_bytes(v.x, k0, lo, hi);
        v.y = keep_bytes(v.y, k0 + 4, lo, hi);
        v.z = keep_bytes(v.z, k0 + 8, lo, hi);
        v.w = keep_bytes(v.w, k0 + 12, lo, hi);
      }
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + j;
        const uint32_t b = sec[clampi(k, lo, hi - 1)];
        w[j >> 2] |= (k >= lo && k < hi ? b : 0u) << (8 * (j & 3));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    reinterpret_cast<uint4*>(dst)[q] = v;
  }
  return dst + shift;
}

__device__ __forceinline__ void zero_words(void* p, int bytes) {
  for (int q = threadIdx.x; q < bytes / 16; q += blockDim.x)
    reinterpret_cast<uint4*>(p)[q] = make_uint4(0, 0, 0, 0);
}

// One doubling step of the two u16 sources packed in ``h``; sets ``moved``
// when either moved.
__device__ __forceinline__ uint32_t jump2(const uint16_t* src, uint32_t h, int& moved) {
  const uint32_t lo = h & 0xFFFFu, hi = h >> 16;
  const uint32_t lo2 = src[lo], hi2 = src[hi];
  moved |= (lo2 != lo) | (hi2 != hi);
  return lo2 | (hi2 << 16);
}

template <typename R>
__device__ __forceinline__ int token_flag(const R& sec, int t) {
  return (sec.flag(t >> 3) >> (t & 7)) & 1;
}

// Pointers among tokens [0, t0) of each thread's t0 (t0 <= ntok), with no
// barrier: every warp scans the popcounts of the flag words (a lane m
// words), and each lane adds the words from its owner lane's on.
template <typename R>
__device__ int pointers_before(const R& sec, int t0, int ntok) {
  if (ntok == 0) return 0;
  const int lane = threadIdx.x & 31;
  const int words = (ntok + 31) >> 5, m = (words + 31) >> 5;
  int c = 0;
  for (int i = lane * m; i < min(lane * m + m, words); ++i) c += __popc(sec.flag_word(i));
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  const int q = t0 >> 5, owner = min(q / m, 31);
  int n = __shfl_sync(0xffffffffu, x - c, owner);
  for (int i = owner * m; i < q; ++i) n += __popc(sec.flag_word(i));
  if (t0 & 31) n += __popc(sec.flag_word(q) & ((1u << (t0 & 31)) - 1));
  return n;
}

// Output lengths of tokens [t0, t1), whose payload starts at ``roff``.
template <int S, typename R>
__device__ int token_lengths(const R& sec, int t0, int t1, int roff, int ps) {
  int n = 0;
  for (int t = t0; t < t1; ++t) {
    if (token_flag(sec, t)) {
      n += sec.pay(clampi(roff, 0, ps - 1));
      roff += 2;
    } else {
      n += 1;
      roff += S;
    }
  }
  return n;
}

// Mark the first output position of tokens [t0, t1) with their key and
// write their literals to ``out``.
template <int S, typename R, typename Lit>
__device__ void mark_tokens(const R& sec, int t0, int t1, int roff, int w, int C, int ps,
                            uint32_t* marks, Lit* out) {
  for (int t = t0; t < t1; ++t) {
    if (token_flag(sec, t)) {
      const int ln = sec.pay(clampi(roff, 0, ps - 1));
      const int off = sec.pay(clampi(roff + 1, 0, ps - 1));
      if (ln > 0 && w < C) marks[w] = (static_cast<uint32_t>(w) << 9) | 256u | off;
      roff += 2;
      w += ln;
    } else {
      uint32_t lit = 0;
#pragma unroll
      for (int b = 0; b < S; ++b)
        lit |= static_cast<uint32_t>(sec.pay(clampi(roff + b, 0, ps - 1))) << (8 * b);
      if (w < C) {
        marks[w] = static_cast<uint32_t>(w) << 9;
        out[w] = static_cast<Lit>(lit);
      }
      roff += S;
      w += 1;
    }
  }
}

// The staged layout's literal row: S bytes a symbol, in a u16 where they fit.
template <int S>
using StagedLit = typename std::conditional<(S <= 2), uint16_t, int32_t>::type;

// Dynamic shared memory of the two layouts.
template <int S>
size_t staged_smem(int C) {
  return 4 * static_cast<size_t>(C) + sizeof(StagedLit<S>) * C + staged_bytes(C / 8) +
         staged_bytes(C * S);
}
inline size_t rows_smem(int C) { return 4 * static_cast<size_t>(C); }

// Decode ``ntok`` tokens (already clamped to [0, C]) of one chunk into
// ``o`` (C int32, 16-byte aligned).  ``smem`` is the layout's dynamic
// shared memory (16-byte aligned), ``warp_sums`` the block scans' 32
// shared ints.  Every thread of the block calls it.
template <bool kStaged, int S>
__device__ void decode_chunk(const Sections& sec, int ntok, int C, int rounds,
                             unsigned char* smem, int* warp_sums, int32_t* __restrict__ o) {
  using Lit = typename std::conditional<kStaged, StagedLit<S>, int32_t>::type;
  uint32_t* marks = reinterpret_cast<uint32_t*>(smem);  // C keys, then the u16 row
  uint16_t* src = reinterpret_cast<uint16_t*>(smem);
  Lit* out = kStaged ? reinterpret_cast<Lit*>(smem + 4 * C) : reinterpret_cast<Lit*>(o);
  uint8_t* fstage = smem + 4 * C + sizeof(Lit) * C;
  uint8_t* pstage = fstage + staged_bytes(C / 8);
  const int ps = C * S;
  StagedSections staged{nullptr, 0, nullptr};

  // -- init --
  zero_words(marks, 4 * C);
  zero_words(out, sizeof(Lit) * C);
  if (kStaged) {
    // the tokens read at most max(2, S) payload bytes each
    const int n = min(ps, ntok * (S > 2 ? S : 2));
    staged.fw = fstage;
    staged.fsh = static_cast<int>(
        stage_section(fstage, sec.f, sec.flo, sec.fhi, C / 8, sec.fsafe_lo, sec.fsafe_hi) - fstage);
    staged.p = stage_section(pstage, sec.p, sec.plo, min(sec.phi, n), n, sec.psafe_lo,
                             sec.psafe_hi);
  }
  __syncthreads();

  // -- tokens --
  const int per = (ntok + blockDim.x - 1) / blockDim.x;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, ntok), t1 = min(t0 + per, ntok);
  const int np = kStaged ? pointers_before(staged, t0, ntok) : pointers_before(sec, t0, ntok);
  const int roff = 2 * np + S * (t0 - np);
  int wtotal;
  const int nout = kStaged ? token_lengths<S>(staged, t0, t1, roff, ps)
                           : token_lengths<S>(sec, t0, t1, roff, ps);
  const int wpos = block_excl_scan(nout, &wtotal, warp_sums);
  if (kStaged)
    mark_tokens<S>(staged, t0, t1, roff, wpos, C, ps, marks, out);
  else
    mark_tokens<S>(sec, t0, t1, roff, wpos, C, ps, marks, out);
  if (threadIdx.x == 0 && wtotal < C) marks[wtotal] = static_cast<uint32_t>(wtotal) << 9;
  __syncthreads();

  // -- fill --
  // A thread owns kRun consecutive positions a pass; their keys are loaded
  // before the scan's barriers and their u16 sources stored after, so the
  // row may overlay the keys (a pass stores below the keys it loaded).  A
  // copy longer than its offset (never written by the compressor) would
  // chain through itself; its positions take their first source before the
  // copy's start, start - off + (w - start) % off, an ancestor on the same
  // chain, so the chain is as deep as the tokens it crosses.
  uint32_t carry = 0;
  for (int base = 0; base < C; base += blockDim.x * kRun) {
    const int p0 = base + threadIdx.x * kRun;
    uint32_t m[kRun];
    uint32_t run = 0;
    if (p0 < C) {
      const uint4 a = reinterpret_cast<const uint4*>(marks + p0)[0];
      const uint4 b = reinterpret_cast<const uint4*>(marks + p0)[1];
      m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
      m[4] = b.x; m[5] = b.y; m[6] = b.z; m[7] = b.w;
#pragma unroll
      for (int i = 0; i < kRun; ++i) m[i] = run = max(run, m[i]);
    }
    int total;
    const uint32_t pre = max(carry, static_cast<uint32_t>(
        block_excl_max(static_cast<int>(run), &total, warp_sums)));
    carry = max(carry, static_cast<uint32_t>(total));
    if (p0 < C) {
      uint32_t packed[kRun / 2];
      bool within = false;  // a source inside its own copy
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const uint32_t key = max(pre, m[i]);
        const int w = p0 + i, off = key & 255u, start = key >> 9;
        const bool copy = key & 256u;
        within |= copy && off > 0 && w - off >= start;
        const uint32_t s = copy ? max(w - off, 0) : w;
        packed[i >> 1] = (i & 1) ? packed[i >> 1] | (s << 16) : s;
      }
      if (within) {
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const uint32_t key = max(pre, m[i]);
          const int w = p0 + i, off = key & 255u, start = key >> 9;
          if ((key & 256u) && off > 0 && w - off >= start) {
            const uint32_t s = max(start - off + (w - start) % off, 0);
            const int sh = 16 * (i & 1);
            packed[i >> 1] = (packed[i >> 1] & ~(0xFFFFu << sh)) | (s << sh);
          }
        }
      }
      reinterpret_cast<uint4*>(src + p0)[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
  __syncthreads();

  // -- rounds --
  // Up to kJumps jumps a round.  In place, a jump may already read this
  // round's values; either way it lands on an ancestor at least as far up
  // as a synchronous round's, so ceil(log2 C) rounds stay an upper bound.
  // A group of kRun positions that a jump does not move points at roots
  // only, and is done for good (a root never moves): it is skipped, and the
  // rounds end when every group is.
  uint64_t done = 0;  // bit i: the thread's i-th group (C <= 64 * blockDim * kRun)
  for (int r = 0; r < rounds; ++r) {
    int changed = 0;
    for (int p0 = threadIdx.x * kRun, i = 0; p0 < C; p0 += blockDim.x * kRun, ++i) {
      if (done >> i & 1) continue;
      uint4 v = reinterpret_cast<const uint4*>(src + p0)[0];
      int moved = 1;
      for (int j = 0; j < kJumps && moved; ++j) {
        moved = 0;
        const uint4 u = make_uint4(jump2(src, v.x, moved), jump2(src, v.y, moved),
                                   jump2(src, v.z, moved), jump2(src, v.w, moved));
        if (moved) {
          v = u;
          reinterpret_cast<uint4*>(src + p0)[0] = v;
        }
      }
      if (moved)
        changed = 1;
      else
        done |= 1ull << i;
    }
    if (!__syncthreads_or(changed)) break;
  }

  // -- gather --
  for (int p0 = threadIdx.x * kRun; p0 < C; p0 += blockDim.x * kRun) {
    const uint4 v = reinterpret_cast<const uint4*>(src + p0)[0];
    const uint32_t h[4] = {v.x, v.y, v.z, v.w};
    if (kStaged) {
      int32_t y[kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i) y[i] = out[(h[i >> 1] >> (16 * (i & 1))) & 0xFFFFu];
      reinterpret_cast<int4*>(o + p0)[0] = make_int4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<int4*>(o + p0)[1] = make_int4(y[4], y[5], y[6], y[7]);
    } else {
      // roots are never written here, so every read sees its literal
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int s = (h[i >> 1] >> (16 * (i & 1))) & 0xFFFF;
        if (s != p0 + i) o[p0 + i] = o[s];
      }
    }
  }
}

}  // namespace gplz
