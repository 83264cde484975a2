// Pieces shared by the LSTM recurrence kernels (lstm_fwd.cu, lstm_bwd.cu):
// the shared-memory budget of two CTAs per SM, the ring of chunks streamed
// from L2 with cp.async, the ldmatrix / mma.sync fragments of the bf16
// products, type conversions, the gate nonlinearities and the grid-wide
// barrier between time steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace seplstm {

constexpr int SMEM_PER_CTA = 115712; // two CTAs per SM: (228 KB per SM) / 2 - 1 KB reserved
constexpr int SMEM_MAX = 232448;     // 227 KB, the most one CTA may take

// One row of a ring stage: ROW_BYTES of a chunk (by default 128 bf16 or 32
// f32 columns), padded by 16 bytes, so 8 consecutive rows start in distinct
// 16-byte bank groups (conflict-free for ldmatrix and float4 reads).
template <typename WT, int ROW_BYTES = std::is_same<WT, float>::value ? 128 : 256>
struct Ring {
  static constexpr int row_bytes = ROW_BYTES;
  static constexpr int rs = row_bytes + 16;
  static constexpr int kc = row_bytes / (int)sizeof(WT);   // columns per chunk
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// CB-byte copy (16: through L2 only; 8 or 4: also L1), zero-filled when !valid
template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(CB), "r"(valid ? CB : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows 0..n-1 of one chunk (columns col0.. of rows of G elements at src)
// into a stage of ring R, in CB-byte copies by NT threads; columns past G
// are zero-filled.
template <int CB, int NT, typename R, typename WT>
__device__ __forceinline__ void stage_rows(unsigned char* st, const WT* src, int n, int G,
                                           int col0) {
  constexpr int SEG = R::row_bytes / CB;               // copies per stage row
  constexpr int EPC = CB / (int)sizeof(WT);            // elements per copy
  for (int idx = threadIdx.x; idx < n * SEG; idx += NT) {
    const int r = idx / SEG, s = idx % SEG;
    const int col = col0 + s * EPC;
    const bool valid = col < G;
    cp_async<CB>(st + r * R::rs + s * CB, valid ? src + (size_t)r * G + col : src, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// c += a b on the tensor cores: a 16x16 (row), b 16x8 (col), bf16; c f32
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// The launch plan of a kernel whose CTAs take smem bytes of shared memory
// each: the SMs of the current device and how many CTAs one SM holds (0 when
// smem exceeds what one CTA may take). Returns a cudaError_t code.
template <typename K>
int occupancy(K kernel, int threads, size_t smem, int* per_sm, int* sms) {
  *per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess || smem > (size_t)SMEM_MAX) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  return (int)err;
}

}  // namespace seplstm
