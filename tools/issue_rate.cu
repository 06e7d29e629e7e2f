// Issue cost of single instructions on one card: each pattern below runs in
// 8 independent chains per thread, 4096 times, in 132 * 8 blocks of 256
// threads, and the time is printed as cycles per pattern per SM
// sub-partition at 1.98 GHz.  Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o issue_rate tools/issue_rate.cu
//   ./issue_rate
//
// Read the patterns with their SASS (cuobjdump -sass issue_rate): the
// compiler folds some (iadd, imad) into the loop, and lop3 compiles to two
// LOP3 per pattern.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

#define N 4096
#define CHAINS 8

template <int OP>
__global__ void bench(unsigned* out, unsigned seed, long long* cyc) {
  __shared__ unsigned sm[1024];
  for (int j = threadIdx.x; j < 1024; j += blockDim.x) sm[j] = j * 2654435761u;
  __syncthreads();
  unsigned v[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) v[c] = seed ^ (threadIdx.x * 7 + c * 13);
  long long t0 = clock64();
  for (int it = 0; it < N; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      unsigned x = v[c];
      if (OP == 0) x = x + 0x9e3779b9u;                 // IADD
      if (OP == 1) x = (x ^ 0x5bd1e995u) & (x | 3u);    // LOP3
      if (OP == 2) x = x + __clz(x);                    // FLO + IADD
      if (OP == 3) x = __brev(x) + 1;                   // BREV + IADD
      if (OP == 4) x = x + __popc(x);                   // POPC + IADD
      if (OP == 5) x = x + __ballot_sync(0xffffffffu, x & 1);  // VOTE + IADD
      if (OP == 6) x = x + __any_sync(0xffffffffu, x & 1);     // VOTE.ANY + IADD
      if (OP == 7) x = __funnelshift_l(x, x + 1, x) + 1;       // SHF + IADD
      if (OP == 8) x = x * 0x077CB531u + c;              // IMAD
      if (OP == 9) x = x + sm[(x + threadIdx.x) & 1023];  // LDS + IADD
      if (OP == 10) x = x + (x > 12345u ? 1u : 7u);        // ISETP + SEL + IADD
      v[c] = x;
    }
  }
  long long t1 = clock64();
  unsigned acc = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc ^= v[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

template <int OP>
void run(const char* name, unsigned* out, long long* cyc) {
  const int blocks = 132 * 8, threads = 256;
  bench<OP><<<blocks, threads>>>(out, 1, cyc);
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  bench<OP><<<blocks, threads>>>(out, 2, cyc);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  // warp-instructions of the op's pattern per SMSP
  double warps = blocks * threads / 32.0;
  double per_smsp = warps * (double)N * CHAINS / (132 * 4);
  double clk = 1.98e9;  // boost clock
  printf("[mb] %-28s %8.3f ms  %6.3f cycles per pattern per SMSP (at 1.98 GHz)\n", name, ms,
         ms * 1e-3 * clk / per_smsp);
}

int main() {
  unsigned* out; long long* cyc;
  cudaMalloc(&out, 132 * 8 * 256 * 4); cudaMalloc(&cyc, 132 * 8 * 8);
  run<0>("iadd", out, cyc);
  run<1>("lop3 (and/xor/or)", out, cyc);
  run<2>("clz + iadd", out, cyc);
  run<3>("brev + iadd", out, cyc);
  run<4>("popc + iadd", out, cyc);
  run<5>("ballot + iadd", out, cyc);
  run<6>("any + iadd", out, cyc);
  run<7>("funnelshift + iadd", out, cyc);
  run<8>("imad", out, cyc);
  run<9>("lds + iadd", out, cyc);
  run<10>("isetp + sel + iadd", out, cyc);
  printf("err %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
