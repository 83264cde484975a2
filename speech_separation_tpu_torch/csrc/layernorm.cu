// Channelwise LayerNorm for Hopper (K6): one kernel forward, one backward.
//
// Replaces no TPU kernel: the JAX package leaves its channelwise norm
// (speech_separation_tpu/models/tcn.py::_cln) to XLA, which fuses it. On the
// card the same formula in PyTorch is about ten kernels forward and two dozen
// backward, each a float32 pass over every value. Here, with
// models/tcn.py::_cln's arithmetic, for each row of H values:
//   mu   = mean(x)                            f32, then a second pass over the
//   var  = mean((x - mu)^2)                   registers (not E[x^2] - mu^2)
//   rstd = rsqrt(var + eps)
//   y    = ((x - mu) * rstd) * g + b          f32, rounded once to x's type
// saving only mu and rstd (f32, one of each a row). The backward recomputes
// xhat = (x - mu) * rstd and, with dyg = dy * g,
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))
//   dg = sum over rows of dy * xhat,   db = sum over rows of dy
// in f32, dx rounded once to x's type. x, y, dy and dx share one type (bf16
// or f32); g, b, dg, db, mu and rstd are f32.
//
// What bounds it: bytes. The forward reads x and writes y (4 bytes a value in
// bf16), the backward reads x and dy and writes dx (6); g, b, the statistics
// and the parameter gradients are small beside them. Design: one warp a row,
// the whole row in registers (16-byte loads where H and the pointers allow,
// else one value a lane), so each value crosses device memory once each way.
// A grid of the CTAs that fit the card at once walks the rows; each warp keeps
// g and b (in the backward g and its partial dg and db) in registers across
// its rows. (A warp with two, four or eight rows' loads in flight at once was
// no faster at H = 256 in bf16, and slower at 257.) The parameter gradients:
// the warps of a CTA add their partial sums in warp order through shared
// memory into one row of 2H floats a CTA in a scratch buffer, and a second
// launch sums those rows in index order, column by column. No atomics: two
// launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // rows in flight a CTA, one a warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_H = 1024;
constexpr int CTAS_CAP = 2048;         // CTAs of a launch at most (the scratch's rows)
constexpr int PARAM_ROWS = 32;         // row groups of a parameter-sum CTA (x 32 columns)
constexpr int MAX_DEVICES = 64;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC values from p: one 16-byte load when VEC > 1 (p 16-byte aligned)
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32<T>(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32<T>(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// the sum over the warp, the same bits in every lane (a + b == b + a)
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// A lane holds values (j * 32 + lane) * VEC + i of its row, j < NV, i < VEC;
// those at or past H are off. Warp w of the grid takes rows w, w + S, w + 2S,
// ... (S the grid's warps).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
    chan_ln_fwd(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu_out,
                float* __restrict__ rstd_out, int R, int H, float eps) {
  const int lane = threadIdx.x & 31;
  float gv[NV][VEC], bv[NV][VEC];
  bool on[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * VEC;
    on[j] = c < H;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      gv[j][i] = on[j] ? g[c + i] : 0.f;
      bv[j][i] = on[j] ? b[c + i] : 0.f;
    }
  }
  const float h = (float)H;
  for (long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); row < R;
       row += (long long)gridDim.x * WARPS) {
    const T* xr = x + row * H;
    T* yr = y + row * H;
    float v[NV][VEC];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (on[j]) {
        load<T, VEC>(xr + (j * 32 + lane) * VEC, v[j]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += v[j][i];
      }
    }
    const float mu = warp_sum(s) / h;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (on[j]) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[j][i] -= mu;
          ss += v[j][i] * v[j][i];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) / h + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (on[j]) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[j][i] = (v[j][i] * rstd) * gv[j][i] + bv[j][i];
        store<T, VEC>(yr + (j * 32 + lane) * VEC, v[j]);
      }
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// part: this launch's CTAs x 2H floats, the CTA's partial dg then db
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
    chan_ln_bwd(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ g,
                const float* __restrict__ mu, const float* __restrict__ rstd,
                T* __restrict__ dx, float* __restrict__ part, int R, int H) {
  __shared__ float acc[2 * MAX_H];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float gv[NV][VEC], pg[NV][VEC], pb[NV][VEC];
  bool on[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * VEC;
    on[j] = c < H;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      gv[j][i] = on[j] ? g[c + i] : 0.f;
      pg[j][i] = 0.f;
      pb[j][i] = 0.f;
    }
  }
  const float h = (float)H;
  for (long long row = (long long)blockIdx.x * WARPS + warp; row < R;
       row += (long long)gridDim.x * WARPS) {
    const long long base = row * H;
    const float m = mu[row], r = rstd[row];
    float xh[NV][VEC], d[NV][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (on[j]) {
        const int c = (j * 32 + lane) * VEC;
        load<T, VEC>(x + base + c, xh[j]);
        load<T, VEC>(dy + base + c, d[j]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          xh[j][i] = (xh[j][i] - m) * r;
          pg[j][i] += d[j][i] * xh[j][i];
          pb[j][i] += d[j][i];
          d[j][i] *= gv[j][i];
          s1 += d[j][i];
          s2 += d[j][i] * xh[j][i];
        }
      }
    }
    const float mean_dyg = warp_sum(s1) / h, mean_dyg_xh = warp_sum(s2) / h;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (on[j]) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          d[j][i] = r * (d[j][i] - mean_dyg - xh[j][i] * mean_dyg_xh);
        store<T, VEC>(dx + base + (j * 32 + lane) * VEC, d[j]);
      }
    }
  }
  // the CTA's partial sums, warp after warp in a fixed order
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (on[j]) {
          const int c = (j * 32 + lane) * VEC;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[c + i] = w == 0 ? pg[j][i] : acc[c + i] + pg[j][i];
            acc[H + c + i] = w == 0 ? pb[j][i] : acc[H + c + i] + pb[j][i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < 2 * H; c += THREADS) out[c] = acc[c];
}

// dg and db: the n rows of part summed column by column, each column's rows
// in a fixed order (row group ty takes rows ty, ty + PARAM_ROWS, ..., then the
// groups are added in order)
__global__ void __launch_bounds__(32 * PARAM_ROWS)
    chan_ln_bwd_params(const float* __restrict__ part, float* __restrict__ dg,
                       float* __restrict__ db, int n, int H) {
  __shared__ float s[PARAM_ROWS][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  float a = 0.f;
  if (col < 2 * H) {
    for (int k = ty; k < n; k += PARAM_ROWS) a += part[(long long)k * 2 * H + col];
  }
  s[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < 2 * H) {
    float t = s[0][tx];
    for (int w = 1; w < PARAM_ROWS; ++w) t += s[w][tx];
    if (col < H) {
      dg[col] = t;
    } else {
      db[col - H] = t;
    }
  }
}

// The CTAs of a launch: as many as fit the card at once (cached a device and
// kernel), at most one a WARPS rows and at most CTAS_CAP.
template <typename K>
cudaError_t grid_for(K kernel, int* cache, int R, int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int fit = dev < MAX_DEVICES ? cache[dev] : 0;
  if (fit == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    fit = per_sm * sms;
    fit = fit < 1 ? 1 : (fit > CTAS_CAP ? CTAS_CAP : fit);
    if (dev < MAX_DEVICES) cache[dev] = fit;
  }
  const long long need = ((long long)R + WARPS - 1) / WARPS;
  *ctas = need < fit ? (int)need : fit;
  return cudaSuccess;
}

template <typename T, int VEC, int NV>
int launch_fwd(const void* x, const float* g, const float* b, void* y, float* mu, float* rstd,
               int R, int H, float eps, cudaStream_t stream) {
  static int fit[MAX_DEVICES] = {};
  int ctas = 0;
  cudaError_t err = grid_for(chan_ln_fwd<T, VEC, NV>, fit, R, &ctas);
  if (err != cudaSuccess) return (int)err;
  chan_ln_fwd<T, VEC, NV><<<ctas, THREADS, 0, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), mu, rstd, R, H, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int NV>
int launch_bwd(const void* x, const void* dy, const float* g, const float* mu, const float* rstd,
               void* dx, float* dg, float* db, float* part, int R, int H, cudaStream_t stream) {
  static int fit[MAX_DEVICES] = {};
  int ctas = 0;
  if (R > 0) {
    cudaError_t err = grid_for(chan_ln_bwd<T, VEC, NV>, fit, R, &ctas);
    if (err != cudaSuccess) return (int)err;
    chan_ln_bwd<T, VEC, NV><<<ctas, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), g, mu, rstd, static_cast<T*>(dx),
        part, R, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // with no rows, ctas is 0 and dg, db come out zero
  chan_ln_bwd_params<<<(2 * H + 31) / 32, 32 * PARAM_ROWS, 0, stream>>>(part, dg, db, ctas, H);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// values a lane at the widest load the row and pointers allow: VEC values a
// load, NV loads a lane (a power of two)
template <typename T>
int lanes_plan(int H, bool vec) {
  const int per = vec ? 32 * (int)(16 / sizeof(T)) : 32;
  const int need = (H + per - 1) / per;
  int nv = 1;
  while (nv < need) nv *= 2;
  return nv;
}

template <typename T>
int fwd_any(const void* x, const float* g, const float* b, void* y, float* mu, float* rstd,
            int R, int H, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = H % V == 0 && aligned(x) && aligned(y);
  switch (lanes_plan<T>(H, vec) * (vec ? -1 : 1)) {
    case -1: return launch_fwd<T, V, 1>(x, g, b, y, mu, rstd, R, H, eps, s);
    case -2: return launch_fwd<T, V, 2>(x, g, b, y, mu, rstd, R, H, eps, s);
    case -4: return launch_fwd<T, V, 4>(x, g, b, y, mu, rstd, R, H, eps, s);
    case -8: return launch_fwd<T, V, 8>(x, g, b, y, mu, rstd, R, H, eps, s);
    case 1: return launch_fwd<T, 1, 1>(x, g, b, y, mu, rstd, R, H, eps, s);
    case 2: return launch_fwd<T, 1, 2>(x, g, b, y, mu, rstd, R, H, eps, s);
    case 4: return launch_fwd<T, 1, 4>(x, g, b, y, mu, rstd, R, H, eps, s);
    case 8: return launch_fwd<T, 1, 8>(x, g, b, y, mu, rstd, R, H, eps, s);
    case 16: return launch_fwd<T, 1, 16>(x, g, b, y, mu, rstd, R, H, eps, s);
    case 32: return launch_fwd<T, 1, 32>(x, g, b, y, mu, rstd, R, H, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_any(const void* x, const void* dy, const float* g, const float* mu, const float* rstd,
            void* dx, float* dg, float* db, float* part, int R, int H, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = H % V == 0 && aligned(x) && aligned(dy) && aligned(dx);
  switch (lanes_plan<T>(H, vec) * (vec ? -1 : 1)) {
    case -1: return launch_bwd<T, V, 1>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case -2: return launch_bwd<T, V, 2>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case -4: return launch_bwd<T, V, 4>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case -8: return launch_bwd<T, V, 8>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case 1: return launch_bwd<T, 1, 1>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case 2: return launch_bwd<T, 1, 2>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case 4: return launch_bwd<T, 1, 4>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case 8: return launch_bwd<T, 1, 8>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case 16: return launch_bwd<T, 1, 16>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    case 32: return launch_bwd<T, 1, 32>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code, 0 on success. x, y (dy, dx) are contiguous
// (R, H) rows of one type, bf16 when bf16 != 0, else f32, 1 <= H <= 1024; g,
// b, dg, db (H,) f32; mu, rstd (R,) f32. part holds at least
// min(ceil(R / 8), 2048) x 2H floats of scratch (sep_ln_part_rows).
int sep_ln_fwd(const void* x, const float* g, const float* b, void* y, float* mu, float* rstd,
               int bf16, int R, int H, float eps, void* stream) {
  if (H < 1 || H > MAX_H || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd_any<__nv_bfloat16>(x, g, b, y, mu, rstd, R, H, eps, s)
              : fwd_any<float>(x, g, b, y, mu, rstd, R, H, eps, s);
}

int sep_ln_bwd(const void* x, const void* dy, const float* g, const float* mu,
               const float* rstd, void* dx, float* dg, float* db, float* part, int bf16, int R,
               int H, void* stream) {
  if (H < 1 || H > MAX_H || R < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd_any<__nv_bfloat16>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s)
              : bwd_any<float>(x, dy, g, mu, rstd, dx, dg, db, part, R, H, s);
}

// The rows of scratch a backward of R rows needs (each 2H floats).
int sep_ln_part_rows(int R) {
  const long long need = ((long long)R + WARPS - 1) / WARPS;
  return need < CTAS_CAP ? (int)need : CTAS_CAP;
}

const char* sep_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
