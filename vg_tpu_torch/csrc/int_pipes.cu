// Issue rate and latency of the integer instructions the banded DP is made
// of, on the card (sm_90a): what csrc/banded_dp.cu's source note and
// chip_smoke.py's bound are read against. Not on any mapping path.
//
// pipe_rate: one block of `warps` warps an SM (132 blocks), each thread
// running 8 independent chains of one instruction kind; returns the
// median over blocks of (warp-instructions issued) / (SM clock cycles).
// pipe_latency: one warp, one dependent chain; cycles per instruction.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kIters = 1024;
constexpr int kChains = 8;

template <int K>
__device__ __forceinline__ int step(int x, int b, int c) {
  if constexpr (K == 0) return __viaddmax_s32(x, b, c);
  if constexpr (K == 1) return (int)__viaddmax_s16x2((unsigned)x, b, c);
  if constexpr (K == 2) return x * b + c;   // IMAD
  return (int)__vimax3_s16x2((unsigned)x, b, c);
}

template <int K>
__global__ void rate_kernel(int* out, long long* cyc, int b) {
  int x[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) x[j] = threadIdx.x + j;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < kIters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) x[j] = step<K>(x[j], b, j + 3);
  }
  __syncthreads();
  const long long t1 = clock64();
  int s = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

template <int K>
__global__ void latency_kernel(int* out, long long* cyc, int b) {
  int x = threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 64
  for (int i = 0; i < kIters; ++i) x = step<K>(x, b, 3);
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
}

}  // namespace

// kind: 0 __viaddmax_s32, 1 __viaddmax_s16x2, 2 IMAD, 3 __vimax3_s16x2.
// cyc: (132,) int64 scratch; out: (132 * 32 * warps,) int32 scratch.
extern "C" int pipe_rate(int kind, int warps, void* out, void* cyc,
                         int b) {
  const dim3 grid(132), block(32 * warps);
  auto* o = static_cast<int*>(out);
  auto* c = static_cast<long long*>(cyc);
  switch (kind) {
    case 0: rate_kernel<0><<<grid, block>>>(o, c, b); break;
    case 1: rate_kernel<1><<<grid, block>>>(o, c, b); break;
    case 2: rate_kernel<2><<<grid, block>>>(o, c, b); break;
    case 3: rate_kernel<3><<<grid, block>>>(o, c, b); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int pipe_latency(int kind, void* out, void* cyc, int b) {
  auto* o = static_cast<int*>(out);
  auto* c = static_cast<long long*>(cyc);
  switch (kind) {
    case 0: latency_kernel<0><<<1, 32>>>(o, c, b); break;
    case 1: latency_kernel<1><<<1, 32>>>(o, c, b); break;
    case 2: latency_kernel<2><<<1, 32>>>(o, c, b); break;
    case 3: latency_kernel<3><<<1, 32>>>(o, c, b); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Instructions each rate-kernel thread issues in its timed loop.
extern "C" int pipe_instructions() { return kIters * kChains; }
