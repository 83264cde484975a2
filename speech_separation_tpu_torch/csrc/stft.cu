// Fused framing + windowed real-DFT STFT for Hopper.
//
// Replaces speech_separation_tpu/ops/stft_pallas.py::stft_pallas (the Pallas
// kernel built by _make_kernel). Same contract: xp (B, Lp) f32 rows, each
// center-padded; frame t of row b is xp[b, t*hop : t*hop + n_fft]; the output
// is frames @ A with A the (n_fft, 2*n_bins) windowed rDFT matrix, split into
// re and im (each (B, n_t, n_bins) f32), or fused into |X| when magnitude != 0.
//
// What bounds it: an f32 product of (B*n_t, n_fft) by (n_fft, 2*n_bins). At
// the serving shape (B=16, n_t=513, n_fft=512) that is 4.3 GFLOP against 22 MB
// of compulsory traffic, so on the CUDA cores (no TF32: the reference uses
// Precision.HIGHEST) it is bound by the f32 FMA rate, not by memory. The
// design keeps the 4x frame expansion out of device memory: a CTA computes a
// 128-frame x 32-bin tile of both re and im, loading each frame slice straight
// from the padded row (framing is address arithmetic in the load, no gather
// tensor), staging 16-deep slices of the frames and of A in shared memory, and
// accumulating 8 frames x 2 bins x (re, im) per thread in registers. re and im
// of a bin stay in one thread, so the magnitude is fused into the epilogue.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;             // frames per CTA
constexpr int BNB = 32;             // bins per CTA (re and im each)
constexpr int BK = 16;              // depth of one shared-memory slice
constexpr int TPB = 256;
constexpr int AS_STRIDE = BM + 4;   // padded to spread the transposed stores

__global__ void __launch_bounds__(TPB)
stft_kernel(const float* __restrict__ xp, const float* __restrict__ A,
            float* __restrict__ out_a, float* __restrict__ out_b,
            int B, int Lp, int n_t, int n_fft, int hop, int magnitude) {
  __shared__ __align__(16) float As[BK][AS_STRIDE];
  __shared__ __align__(16) float Bs[BK][2 * BNB];

  const int n_bins = n_fft / 2 + 1;
  const int M = B * n_t;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BNB;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // frame starts of the 8 rows this thread loads
  const int kk_load = tid & (BK - 1);
  long long base[8];
  bool row_ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (tid >> 4) + 16 * i;
    row_ok[i] = m < M;
    const int b = row_ok[i] ? m / n_t : 0;
    const int t = row_ok[i] ? m - b * n_t : 0;
    base[i] = (long long)b * Lp + (long long)t * hop;
  }

  float acc_re[8][2], acc_im[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    acc_re[r][0] = acc_re[r][1] = 0.f;
    acc_im[r][0] = acc_im[r][1] = 0.f;
  }

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    const int k = k0 + kk_load;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      As[kk_load][(tid >> 4) + 16 * i] =
          (row_ok[i] && k < n_fft) ? __ldg(xp + base[i] + k) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + TPB * i;
      const int c = idx & (2 * BNB - 1);
      const int kk = idx >> 6;
      const int kb = k0 + kk;
      const int bin = n0 + (c & (BNB - 1));
      const int col = (c < BNB) ? bin : n_bins + bin;
      Bs[kk][c] = (kb < n_fft && bin < n_bins) ? __ldg(A + (size_t)kb * 2 * n_bins + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float2 br = *reinterpret_cast<const float2*>(&Bs[kk][tx * 2]);
      const float2 bi = *reinterpret_cast<const float2*>(&Bs[kk][BNB + tx * 2]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc_re[r][0] = fmaf(a[r], br.x, acc_re[r][0]);
        acc_re[r][1] = fmaf(a[r], br.y, acc_re[r][1]);
        acc_im[r][0] = fmaf(a[r], bi.x, acc_im[r][0]);
        acc_im[r][1] = fmaf(a[r], bi.y, acc_im[r][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + ty * 8 + r;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int bin = n0 + tx * 2 + q;
      if (bin >= n_bins) continue;
      const size_t o = (size_t)m * n_bins + bin;
      const float re = acc_re[r][q];
      const float im = acc_im[r][q];
      if (magnitude) {
        out_a[o] = sqrtf(re * re + im * im);
      } else {
        out_a[o] = re;
        out_b[o] = im;
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 on success. out_b is unused when magnitude != 0.
int sep_stft(const float* xp, const float* A, float* out_a, float* out_b, int B, int Lp,
             int n_t, int n_fft, int hop, int magnitude, void* stream) {
  const int n_bins = n_fft / 2 + 1;
  const long long M = (long long)B * n_t;
  const dim3 grid((unsigned int)((M + BM - 1) / BM), (unsigned int)((n_bins + BNB - 1) / BNB));
  stft_kernel<<<grid, TPB, 0, static_cast<cudaStream_t>(stream)>>>(xp, A, out_a, out_b, B, Lp,
                                                                    n_t, n_fft, hop, magnitude);
  return (int)cudaGetLastError();
}

const char* sep_stft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
