// Pieces shared by the LSTM recurrence kernels (lstm_fwd.cu, lstm_bwd.cu):
// the split of hidden units over CTAs, type conversions, the gate
// nonlinearities and the grid-wide barrier between time steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace seplstm {

constexpr int HB = 16;                 // hidden units per CTA
constexpr int RB = 16;                 // batch rows per chunk
constexpr int KS = 4;                  // lanes that split a sum
constexpr int THREADS = HB * (RB / 4) * KS;   // 256
constexpr int HS_STRIDE = RB + 4;      // padded row of a transposed (k, row) tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x as the product sees it: rounded to the weight type.
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// All CTAs arrive; thread 0 of each waits until the counter reaches target.
// A wait of more than 10 s can only be a fault: the kernel traps (the launch
// then fails) rather than hang the card.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const unsigned long long start = global_ns();
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
      if (global_ns() - start > 10000000000ull) __trap();
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// Valid step of row b: a prefix mask (t < L) or, for a time-flipped
// direction, a suffix mask (L > T-1-t).
__device__ __forceinline__ bool step_valid(bool suffix, int L, int t, int T) {
  return suffix ? (L > T - 1 - t) : (L > t);
}

}  // namespace seplstm
