// Fused masked chunk attention for Hopper: forward and recompute backward.
//
// Replaces speech_separation_tpu/ops/attention_pallas.py::chunk_attention, its
// forward body _fwd_kernel and its backward body _bwd_kernel (the custom VJP).
// Same contract: q, k, v (N, T, dh) all f32 or all bf16, N independent
// (sequence, head) rows; key_mask (N, T) f32, 1 at valid keys. Per row:
//   s   = (q . k) * scale + (1 - m) * (-1e9)        f32 logits
//   w32 = exp(s - max_k s) / sum_k exp(s - max_k s)  f32 softmax
//   o   = round_T(w32) @ v                            f32 sum, stored as T
// and the backward from do:
//   dv = round_T(w32)^T @ do,  dw = do @ v^T,
//   ds = (w32 * (dw - sum_k dw * w32)) * scale,  dq = ds @ k,  dk = ds^T @ q,
// each summed in f32 and stored as T. A row whose keys are all masked gets
// uniform weights (the mean of v), as on the TPU: every logit of such a row is
// -1e9 + s*scale, rounded in f32 exactly as the reference rounds it (the
// multiply and the add are kept apart, never contracted into an FMA).
//
// What bounds it: at SepFormer's shapes (dh=16, T=100 intra-chunk or the
// number of chunks inter-chunk) a row's whole score matrix is a few tens of
// KB, so no logit needs to touch device memory; the compulsory traffic is q,
// k, v, the mask and o (and do, dq, dk, dv) once, about 42 us (forward) and
// 72 us (backward) at the training shape, N=10624, T=100, bf16. What is left
// above that is one exp (and one division) per (query, key) and the latency
// of each row's softmax.
//
// bf16 (attention_mma.cuh): the products on the tensor cores (mma.sync),
// whole logit rows in registers up to T = 256, passes over streamed key
// tiles above; see that header.
//
// f32 (below): the products stay on the CUDA cores, since the tensor cores
// take f32 only as TF32, which would round the operands to 10 bits. One CTA
// per row n. The keys of the row (or the queries, in the
// backward's second phase) pass through shared memory in f32 tiles of
// TILE_ELEMS / dh rows, so T has no cap in the forward. Each thread owns one
// query: pass 1 takes the row max, pass 2 the sum of exp(s - max), pass 3 the
// weights and the AV sum, recomputing the logits each pass (the max-exp-divide
// arithmetic of the reference, not an online softmax). The backward keeps no
// atomics and is deterministic: phase 1, one thread per query, takes max, sum
// and D_q = sum_k dw * w32 (kept in shared memory for the row, 12 bytes per
// query, hence the cap on T) and then dq; phase 2, one thread per key, loops
// over the queries for dk and dv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

constexpr int TILE_ELEMS = 4096;   // f32 values of one staged tile of rows
constexpr int MAX_THREADS = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// the weight as the value type holds it, back in f32 (the reference's cast
// of the weights to v's dtype before AV)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32<T>(from_f32<T>(x)); }

// a (registers) . b (shared memory, 16-byte aligned), summed over d in order
template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(a[d], x.x, s);
    s = fmaf(a[d + 1], x.y, s);
    s = fmaf(a[d + 2], x.z, s);
    s = fmaf(a[d + 3], x.w, s);
  }
  return s;
}

// s * scale + (1 - m) * (-1e9): mneg is the second term, the two steps
// rounded apart
__device__ __forceinline__ float logit(float s, float scale, float mneg) {
  return __fadd_rn(__fmul_rn(s, scale), mneg);
}

template <typename T, int DH>
__device__ __forceinline__ void load_row(float (&dst)[DH], const T* src, bool ok) {
#pragma unroll
  for (int d = 0; d < DH; ++d) dst[d] = ok ? to_f32<T>(src[d]) : 0.f;
}

// rows [r0, r0 + n) of a (T, DH) array, to f32 in shared memory
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n) {
  const T* s = src + (size_t)r0 * DH;
  for (int i = threadIdx.x; i < n * DH; i += blockDim.x) dst[i] = to_f32<T>(s[i]);
}

// the masks' additive terms (1 - m) * (-1e9) of rows [r0, r0 + n)
__device__ __forceinline__ void stage_mask(float* dst, const float* m, int r0, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __fmul_rn(__fsub_rn(1.f, m[r0 + i]), -1e9f);
}

template <typename T, int DH>
__global__ void __launch_bounds__(MAX_THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ mask, T* __restrict__ o, int Tn, int kt,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // kt x DH
  float* vs = ks + kt * DH;         // kt x DH
  float* mn = vs + kt * DH;         // kt
  const size_t row = (size_t)blockIdx.x * Tn;
  const T* qr = q + row * DH;
  const T* kr = k + row * DH;
  const T* vr = v + row * DH;
  const float* mr = mask + row;
  T* orow = o + row * DH;
  const bool one_tile = Tn <= kt;
  if (one_tile) {
    stage<T, DH>(ks, kr, 0, Tn);
    stage<T, DH>(vs, vr, 0, Tn);
    stage_mask(mn, mr, 0, Tn);
    __syncthreads();
  }

  for (int q0 = 0; q0 < Tn; q0 += blockDim.x) {
    const int i = q0 + threadIdx.x;
    const bool act = i < Tn;
    float qf[DH];
    load_row<T, DH>(qf, qr + (size_t)(act ? i : 0) * DH, act);

    float mx = -INFINITY;
    for (int j0 = 0; j0 < Tn; j0 += kt) {
      const int n = min(kt, Tn - j0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ks, kr, j0, n);
        stage_mask(mn, mr, j0, n);
        __syncthreads();
      }
      if (act)
        for (int j = 0; j < n; ++j) mx = fmaxf(mx, logit(dot<DH>(qf, ks + j * DH), scale, mn[j]));
    }

    float sum = 0.f;
    for (int j0 = 0; j0 < Tn; j0 += kt) {
      const int n = min(kt, Tn - j0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ks, kr, j0, n);
        stage_mask(mn, mr, j0, n);
        __syncthreads();
      }
      if (act)
        for (int j = 0; j < n; ++j)
          sum += expf(__fsub_rn(logit(dot<DH>(qf, ks + j * DH), scale, mn[j]), mx));
    }

    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j0 = 0; j0 < Tn; j0 += kt) {
      const int n = min(kt, Tn - j0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ks, kr, j0, n);
        stage<T, DH>(vs, vr, j0, n);
        stage_mask(mn, mr, j0, n);
        __syncthreads();
      }
      if (act)
        for (int j = 0; j < n; ++j) {
          const float e = expf(__fsub_rn(logit(dot<DH>(qf, ks + j * DH), scale, mn[j]), mx));
          const float wv = round_to<T>(__fdiv_rn(e, sum));
          const float* vj = vs + j * DH;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(wv, vj[d], acc[d]);
        }
    }
    if (act) {
#pragma unroll
      for (int d = 0; d < DH; ++d) orow[(size_t)i * DH + d] = from_f32<T>(acc[d]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(MAX_THREADS)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ mask, const T* __restrict__ dout,
                T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int Tn, int kt,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ta = smem;                 // kt x DH: key rows (phase 1), query rows (phase 2)
  float* tb = ta + kt * DH;         // kt x DH: value rows (phase 1), do rows (phase 2)
  float* mn = tb + kt * DH;         // kt: the keys' mask terms (phase 1)
  float* smax = mn + kt;            // Tn each: per query max, sum and D
  float* ssum = smax + Tn;
  float* sD = ssum + Tn;
  const size_t row = (size_t)blockIdx.x * Tn;
  const T* qr = q + row * DH;
  const T* kr = k + row * DH;
  const T* vr = v + row * DH;
  const T* dor = dout + row * DH;
  const float* mr = mask + row;
  const bool one_tile = Tn <= kt;

  // ---- phase 1, one thread per query: max, sum, D, then dq
  if (one_tile) {
    stage<T, DH>(ta, kr, 0, Tn);
    stage<T, DH>(tb, vr, 0, Tn);
    stage_mask(mn, mr, 0, Tn);
    __syncthreads();
  }
  for (int q0 = 0; q0 < Tn; q0 += blockDim.x) {
    const int i = q0 + threadIdx.x;
    const bool act = i < Tn;
    float qf[DH], dof[DH];
    load_row<T, DH>(qf, qr + (size_t)(act ? i : 0) * DH, act);
    load_row<T, DH>(dof, dor + (size_t)(act ? i : 0) * DH, act);

    float mx = -INFINITY;
    for (int j0 = 0; j0 < Tn; j0 += kt) {
      const int n = min(kt, Tn - j0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ta, kr, j0, n);
        stage_mask(mn, mr, j0, n);
        __syncthreads();
      }
      if (act)
        for (int j = 0; j < n; ++j) mx = fmaxf(mx, logit(dot<DH>(qf, ta + j * DH), scale, mn[j]));
    }
    float sum = 0.f;
    for (int j0 = 0; j0 < Tn; j0 += kt) {
      const int n = min(kt, Tn - j0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ta, kr, j0, n);
        stage_mask(mn, mr, j0, n);
        __syncthreads();
      }
      if (act)
        for (int j = 0; j < n; ++j)
          sum += expf(__fsub_rn(logit(dot<DH>(qf, ta + j * DH), scale, mn[j]), mx));
    }
    float D = 0.f;
    for (int j0 = 0; j0 < Tn; j0 += kt) {
      const int n = min(kt, Tn - j0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ta, kr, j0, n);
        stage<T, DH>(tb, vr, j0, n);
        stage_mask(mn, mr, j0, n);
        __syncthreads();
      }
      if (act)
        for (int j = 0; j < n; ++j) {
          const float e = expf(__fsub_rn(logit(dot<DH>(qf, ta + j * DH), scale, mn[j]), mx));
          const float w32 = __fdiv_rn(e, sum);
          D = fmaf(dot<DH>(dof, tb + j * DH), w32, D);
        }
    }
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j0 = 0; j0 < Tn; j0 += kt) {
      const int n = min(kt, Tn - j0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ta, kr, j0, n);
        stage<T, DH>(tb, vr, j0, n);
        stage_mask(mn, mr, j0, n);
        __syncthreads();
      }
      if (act)
        for (int j = 0; j < n; ++j) {
          const float* kj = ta + j * DH;
          const float e = expf(__fsub_rn(logit(dot<DH>(qf, kj), scale, mn[j]), mx));
          const float w32 = __fdiv_rn(e, sum);
          const float dw = dot<DH>(dof, tb + j * DH);
          const float ds = __fmul_rn(__fmul_rn(w32, __fsub_rn(dw, D)), scale);
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, kj[d], acc[d]);
        }
    }
    if (act) {
      smax[i] = mx;
      ssum[i] = sum;
      sD[i] = D;
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[row * DH + (size_t)i * DH + d] = from_f32<T>(acc[d]);
    }
  }
  __syncthreads();

  // ---- phase 2, one thread per key: dk and dv over all queries
  if (one_tile) {
    stage<T, DH>(ta, qr, 0, Tn);
    stage<T, DH>(tb, dor, 0, Tn);
    __syncthreads();
  }
  for (int k0 = 0; k0 < Tn; k0 += blockDim.x) {
    const int j = k0 + threadIdx.x;
    const bool act = j < Tn;
    float kf[DH], vf[DH];
    load_row<T, DH>(kf, kr + (size_t)(act ? j : 0) * DH, act);
    load_row<T, DH>(vf, vr + (size_t)(act ? j : 0) * DH, act);
    const float mneg = act ? __fmul_rn(__fsub_rn(1.f, mr[j]), -1e9f) : 0.f;
    float dka[DH], dva[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dka[d] = dva[d] = 0.f;
    for (int i0 = 0; i0 < Tn; i0 += kt) {
      const int n = min(kt, Tn - i0);
      if (!one_tile) {
        __syncthreads();
        stage<T, DH>(ta, qr, i0, n);
        stage<T, DH>(tb, dor, i0, n);
        __syncthreads();
      }
      if (act)
        for (int ii = 0; ii < n; ++ii) {
          const int i = i0 + ii;
          const float* qi = ta + ii * DH;
          const float* doi = tb + ii * DH;
          const float e = expf(__fsub_rn(logit(dot<DH>(kf, qi), scale, mneg), smax[i]));
          const float w32 = __fdiv_rn(e, ssum[i]);
          const float wv = round_to<T>(w32);
          const float dw = dot<DH>(vf, doi);
          const float ds = __fmul_rn(__fmul_rn(w32, __fsub_rn(dw, sD[i])), scale);
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dva[d] = fmaf(wv, doi[d], dva[d]);
            dka[d] = fmaf(ds, qi[d], dka[d]);
          }
        }
    }
    if (act) {
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[row * DH + (size_t)j * DH + d] = from_f32<T>(dka[d]);
        dv[row * DH + (size_t)j * DH + d] = from_f32<T>(dva[d]);
      }
    }
  }
}

int threads_for(int Tn) {
  const int t = ((Tn + 31) / 32) * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// Devices whose shared-memory opt-in is cached; others opt in on every launch.
constexpr int MAX_DEVICES = 64;

// Opt a kernel into more than 48 KB of dynamic shared memory, once per size
// and device (``allowed`` holds MAX_DEVICES entries).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  // the opt-in holds for the current device only: one entry per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
  return err;
}

template <typename T, int DH>
int launch_fwd(const void* q, const void* k, const void* v, const float* mask, void* o, int N,
               int Tn, float scale, cudaStream_t stream) {
  static size_t allowed[MAX_DEVICES] = {};
  const int kt = Tn < TILE_ELEMS / DH ? Tn : TILE_ELEMS / DH;
  const size_t smem = (size_t)(2 * kt * DH + kt) * sizeof(float);
  cudaError_t err = allow_smem(attn_fwd_kernel<T, DH>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_kernel<T, DH><<<N, threads_for(Tn), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), Tn, kt, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const float* mask, const void* dout,
               void* dq, void* dk, void* dv, int N, int Tn, float scale, cudaStream_t stream) {
  static size_t allowed[MAX_DEVICES] = {};
  const int kt = Tn < TILE_ELEMS / DH ? Tn : TILE_ELEMS / DH;
  const size_t smem = (size_t)(2 * kt * DH + kt + 3 * Tn) * sizeof(float);
  cudaError_t err = allow_smem(attn_bwd_kernel<T, DH>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<T, DH><<<N, threads_for(Tn), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), Tn, kt, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_dh(const void* q, const void* k, const void* v, const float* mask, void* o, int N,
           int Tn, int dh, float scale, cudaStream_t s) {
  switch (dh) {
    case 4: return launch_fwd<T, 4>(q, k, v, mask, o, N, Tn, scale, s);
    case 8: return launch_fwd<T, 8>(q, k, v, mask, o, N, Tn, scale, s);
    case 16: return launch_fwd<T, 16>(q, k, v, mask, o, N, Tn, scale, s);
    case 32: return launch_fwd<T, 32>(q, k, v, mask, o, N, Tn, scale, s);
    case 64: return launch_fwd<T, 64>(q, k, v, mask, o, N, Tn, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_dh(const void* q, const void* k, const void* v, const float* mask, const void* dout,
           void* dq, void* dk, void* dv, int N, int Tn, int dh, float scale, cudaStream_t s) {
  switch (dh) {
    case 4: return launch_bwd<T, 4>(q, k, v, mask, dout, dq, dk, dv, N, Tn, scale, s);
    case 8: return launch_bwd<T, 8>(q, k, v, mask, dout, dq, dk, dv, N, Tn, scale, s);
    case 16: return launch_bwd<T, 16>(q, k, v, mask, dout, dq, dk, dv, N, Tn, scale, s);
    case 32: return launch_bwd<T, 32>(q, k, v, mask, dout, dq, dk, dv, N, Tn, scale, s);
    case 64: return launch_bwd<T, 64>(q, k, v, mask, dout, dq, dk, dv, N, Tn, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code, 0 on success. Tensors are contiguous; q,
// k, v, o (and do, dq, dk, dv) share one type: bf16 when bf16 != 0, else f32.
int sep_attn_fwd(const void* q, const void* k, const void* v, const float* mask, void* o,
                 int bf16, int N, int T, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return fwd_dh<float>(q, k, v, mask, o, N, T, dh, scale, s);
  if (N <= 0 || T <= 0) return 0;
  switch (dh) {
    case 4: return sepattn::fwd_mma<4>(q, k, v, mask, o, N, T, scale, s);
    case 8: return sepattn::fwd_mma<8>(q, k, v, mask, o, N, T, scale, s);
    case 16: return sepattn::fwd_mma<16>(q, k, v, mask, o, N, T, scale, s);
    case 32: return sepattn::fwd_mma<32>(q, k, v, mask, o, N, T, scale, s);
    case 64: return sepattn::fwd_mma<64>(q, k, v, mask, o, N, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int sep_attn_bwd(const void* q, const void* k, const void* v, const float* mask,
                 const void* dout, void* dq, void* dk, void* dv, int bf16, int N, int T, int dh,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return bwd_dh<float>(q, k, v, mask, dout, dq, dk, dv, N, T, dh, scale, s);
  if (N <= 0 || T <= 0) return 0;
  switch (dh) {
    case 4: return sepattn::bwd_mma<4>(q, k, v, mask, dout, dq, dk, dv, N, T, scale, s);
    case 8: return sepattn::bwd_mma<8>(q, k, v, mask, dout, dq, dk, dv, N, T, scale, s);
    case 16: return sepattn::bwd_mma<16>(q, k, v, mask, dout, dq, dk, dv, N, T, scale, s);
    case 32: return sepattn::bwd_mma<32>(q, k, v, mask, dout, dq, dk, dv, N, T, scale, s);
    case 64: return sepattn::bwd_mma<64>(q, k, v, mask, dout, dq, dk, dv, N, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 launch of a shape, as attention_plan computes it: path (0
// registers, 1 passes), rows and warps a CTA, shared bytes a CTA, CTAs.
int sep_attn_plan(int backward, int N, int T, int dh, int* path, int* rows, int* warps,
                  int* smem, int* ctas) {
  const sepattn::Plan p = sepattn::plan_mma(backward != 0, N, T, dh);
  *path = p.path;
  *rows = p.rows;
  *warps = p.warps;
  *smem = p.smem;
  *ctas = p.ctas;
  return 0;
}

const char* sep_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
