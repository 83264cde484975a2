// Fused framing + Hann window + real DFT (STFT) for Hopper.
//
// Replaces speech_separation_tpu/ops/stft_pallas.py::stft_pallas (:77, body
// _make_kernel :46). Same contract: xp (B, Lp) f32 rows, each center-padded;
// frame t of row b is xp[b, t*hop : t*hop + n_fft]; the output is frames @ A
// with A the (n_fft, 2*n_bins) windowed rDFT matrix, split into re and im
// (each (B, n_t, n_bins) f32, n_bins = n_fft/2 + 1), or fused into |X| when
// magnitude != 0. Frames past a row's true length are computed from its
// padding (garbage but finite); the callers mask them.
//
// What bounds it: memory. An FFT takes about 2.5 n log2 n operations a frame
// (11.5 k at n_fft=512) where the dense product takes 4 n (n/2 + 1) (526 k).
// The least traffic is each padded row read once and each output written
// once: at the serving shape (B=16, n_t=513, n_fft=512, hop=128) 4.23 MB in
// and 16.88 MB of re/im out, 6.3 us at 3.35 TB/s (magnitude: 12.7 MB,
// 3.8 us); at the uPIT on-device-features shape (300 rows, n_t=384,
// Lp=49536) 59.4 MB in and 237 MB out (magnitude 178 MB, 53 us). Two paths,
// chosen by plan_stft (ops/stft_kernel.py's stft_plan is the same function):
//
// "fft": n_fft a power of two, FFT_MIN <= n_fft <= N_FFT_CAP. A CTA owns one
//   row b and F = min(64, 4096 / (n_fft/2)) consecutive frames (16 at 512),
//   so a CTA transforms 4096 complex points with 256 threads of 16 points
//   each (fewer threads for F*n_fft/2 < 4096). The row span the tile reads,
//   xp[b, t0*hop : (t0+F-1)*hop + n_fft], crosses from device memory once:
//   16-byte cp.async for its aligned body, scalar loads for the misaligned
//   head and tail (rows need not be 16-byte aligned; nothing is copied to
//   pad), zeros past the row. Each frame's real n_fft-point DFT is one
//   complex FFT of M = n_fft/2 points, z[n] = w[2n] x[2n] + i w[2n+1]
//   x[2n+1] (the window applied as the first stage reads the span), by
//   Stockham stages of radix 16 while 16 divides what is left, then one 8,
//   4 or 2 (512: 16, 16), each thread taking one 16-point butterfly a stage
//   in registers, twiddled from the f32 table, the stage's output written
//   back in place after a barrier; the buffer is padded one float2 in 16
//   against bank conflicts. The real split pairs bins k and M-k in one
//   thread, X[k] = E[k] + W^k O[k], X[M-k] = conj(E[k] - W^k O[k]), with |X|
//   fused in (a template parameter); the tile's output is staged in the
//   buffer as the one contiguous run of F*n_bins floats it is in each output
//   tensor, then stored with 16-byte stores between a scalar head and tail.
//   Window and twiddles come from one f32 table rounded from float64 on the
//   host (window n_fft floats, then exp(-2 pi i k / n_fft), k < n_fft); no
//   __sinf/__cosf. N_FFT_CAP: one frame of 8192 fills a CTA's 4096-point
//   buffer; a larger power of two takes the direct path. Radix 16 over 8-8-4 and the staged stores over stores straight
//   from the split were measured on the card (PERF.md). Magnitude mode,
//   with 40% fewer bytes, takes about 90% of the re/im time: the FFT's
//   instructions and barriers hold the kernel above its bytes bound more
//   than its stores.
//
// "direct": every other n_fft with hop | n_fft, up to DIRECT_N_FFT_CAP. The
//   dense f32 product frames @ A, the port's first STFT kernel unchanged: a
//   CTA computes a 128-frame x 32-bin tile of re and im, framing as address
//   arithmetic in its loads, 16-deep slices of frames and A in shared
//   memory, 8 frames x 2 bins x (re, im) a thread. It is bound by the f32
//   FMA rate; it serves the sizes an FFT of this design does not take.
//   DIRECT_N_FFT_CAP: the grid's y dimension holds at most 65535 tiles of
//   32 bins.
//
// Every sum has a fixed order, so a second launch is bit-identical.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int N_FFT_CAP = 8192;     // largest n_fft the FFT path takes
constexpr int FFT_MIN = 32;         // smallest power of two on the FFT path
constexpr int FFT_POINTS = 4096;    // complex points a CTA transforms
constexpr int PTS = 16;             // points a thread holds in one stage
constexpr int MAX_FRAMES = 64;

enum Path { REFUSED = -1, FFT = 0, DIRECT = 1 };

struct Plan {
  int path, frames, warps, smem, ctas;
};

// floats of shared memory for a tile's span: (F-1)*hop + n_fft samples
// after up to 3 floats of head, rounded to 16 bytes
int span_floats(int F, int hop, int n_fft) { return ((F - 1) * hop + n_fft + 6) / 4 * 4; }

// ------------------------------------------------------------ direct path

constexpr int BM = 128;             // frames per CTA
constexpr int BNB = 32;             // bins per CTA (re and im each)
constexpr int BK = 16;              // depth of one shared-memory slice
constexpr int TPB = 256;
constexpr int AS_STRIDE = BM + 4;   // padded to spread the transposed stores
// largest n_fft the direct path takes: n_fft/2 + 1 bins in 65535 tiles
constexpr int DIRECT_N_FFT_CAP = 2 * (65535 * BNB - 1);

__global__ void __launch_bounds__(TPB)
stft_direct_kernel(const float* __restrict__ xp, const float* __restrict__ A,
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

// --------------------------------------------------------------- FFT path

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// -i z
__device__ __forceinline__ float2 mul_mi(float2 z) { return make_float2(z.y, -z.x); }
// z (c - i s)
__device__ __forceinline__ float2 rot(float2 z, float c, float s) {
  return make_float2(c * z.x + s * z.y, c * z.y - s * z.x);
}

// one float2 of padding after every 16: the strided stores of the first
// stage and the contiguous reads of every stage fall in distinct banks
__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

// forward 4-point DFT of (a, b, c, d), in natural order
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 s0 = cadd(a, c), d0 = csub(a, c), s1 = cadd(b, d), d1 = mul_mi(csub(b, d));
  a = cadd(s0, s1);
  c = csub(s0, s1);
  b = cadd(d0, d1);
  d = csub(d0, d1);
}

constexpr float SQRT_HALF = 0.70710678118654752f;
constexpr float COS_PI_8 = 0.92387953251128676f;
constexpr float SIN_PI_8 = 0.38268343236508977f;

__device__ __forceinline__ void dft8(float2* v) {
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = make_float2(SQRT_HALF * (o1.x + o1.y), SQRT_HALF * (o1.y - o1.x));    // exp(-i pi/4)
  o2 = mul_mi(o2);                                                          // exp(-i pi/2)
  o3 = make_float2(SQRT_HALF * (o3.y - o3.x), -SQRT_HALF * (o3.x + o3.y));   // exp(-3i pi/4)
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// 16 = 4 x 4: DFT4 over n1 of x[4 n1 + n2] for each n2, twiddle by
// exp(-2 pi i n2 k1 / 16), DFT4 over n2 for each k1; X[k1 + 4 k2]
__device__ __forceinline__ void dft16(float2* v) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
  // v[4 k1 + n2] now holds Y[n2][k1]
  v[5] = rot(v[5], COS_PI_8, SIN_PI_8);
  v[6] = make_float2(SQRT_HALF * (v[6].x + v[6].y), SQRT_HALF * (v[6].y - v[6].x));
  v[7] = rot(v[7], SIN_PI_8, COS_PI_8);
  v[9] = make_float2(SQRT_HALF * (v[9].x + v[9].y), SQRT_HALF * (v[9].y - v[9].x));
  v[10] = mul_mi(v[10]);
  v[11] = make_float2(SQRT_HALF * (v[11].y - v[11].x), -SQRT_HALF * (v[11].x + v[11].y));
  v[13] = rot(v[13], SIN_PI_8, COS_PI_8);
  v[14] = make_float2(SQRT_HALF * (v[14].y - v[14].x), -SQRT_HALF * (v[14].x + v[14].y));
  v[15] = rot(v[15], -COS_PI_8, -SIN_PI_8);
  float2 t[16];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 a = v[4 * k1], b = v[4 * k1 + 1], c = v[4 * k1 + 2], d = v[4 * k1 + 3];
    dft4(a, b, c, d);
    t[k1] = a;
    t[k1 + 4] = b;
    t[k1 + 8] = c;
    t[k1 + 12] = d;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = t[k];
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 16) dft16(v);
  else if constexpr (R == 8) dft8(v);
  else if constexpr (R == 4) dft4(v[0], v[1], v[2], v[3]);
  else dft2(v);
}

template <int R> struct Log2;
template <> struct Log2<2> { static constexpr int v = 1; };
template <> struct Log2<4> { static constexpr int v = 2; };
template <> struct Log2<8> { static constexpr int v = 3; };
template <> struct Log2<16> { static constexpr int v = 4; };

// The tile of a transform size: M = 2^LM points a frame, F frames, NT
// threads of PTS points.
template <int LM>
struct Tile {
  static constexpr int M = 1 << LM;
  static constexpr int F = (FFT_POINTS >> LM) < MAX_FRAMES ? (FFT_POINTS >> LM) : MAX_FRAMES;
  static constexpr int NT = F * M / PTS;
};

// One Stockham stage over the tile's F frames of M = 2^LM points, after
// stages of Ns = 2^LNS points: butterfly g of the tile (frame f, index
// j < M/R) reads points j + r*M/R, multiplies point r by exp(-2 pi i r
// (j mod Ns) / (Ns R)) (table entry 2 r (j mod Ns) M / (Ns R)), takes their
// R-point DFT and writes point r to (j - j mod Ns) R + (j mod Ns) + r Ns. The
// first stage (Ns = 1, R = 16) reads the windowed frame from the span
// instead. Reads all precede the barrier, writes follow it. Every stride is
// a multiple of 16 points, so a padded address is a base plus a constant.
template <int R, int LM, int LNS>
__device__ __forceinline__ void fft_stage(float2* buf, const float* span,
                                          const float2* __restrict__ win2,
                                          const float2* __restrict__ tw, int hop) {
  constexpr int M = Tile<LM>::M, NT = Tile<LM>::NT;
  constexpr int NB = PTS / R;
  constexpr int BPF = M / R;                     // butterflies a frame
  constexpr int NS = 1 << LNS;
  constexpr bool FIRST = LNS == 0;
  static_assert(!FIRST || R == 16, "the first stage is radix 16");
  static_assert(FIRST || (BPF % 16 == 0 && NS % 16 == 0), "strides of whole pad groups");
  float2 v[NB][R];
  float2* dst[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int g = threadIdx.x + q * NT;
    const int f = g / BPF;
    const int j = g % BPF;
    if constexpr (FIRST) {
      const float* x = span + f * hop + 2 * j;
      const float2* w = win2 + j;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 wr = __ldg(w + r * BPF);
        v[q][r] = make_float2(wr.x * x[2 * r * BPF], wr.y * x[2 * r * BPF + 1]);
      }
      dst[q] = buf + pad(f * M + j * R);         // + r: within one pad group
    } else {
      const int jm = j % NS;
      const float2* src = buf + pad(f * M + j);
#pragma unroll
      for (int r = 0; r < R; ++r) v[q][r] = src[r * (BPF + BPF / 16)];
      const int step = jm * (2 * M / (NS * R));
#pragma unroll
      for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], __ldg(tw + r * step));
      dst[q] = buf + pad(f * M + (j - jm) * R + jm);
    }
    dft<R>(v[q]);
  }
  if constexpr (!FIRST) __syncthreads();
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) dst[q][FIRST ? r : r * (NS + NS / 16)] = v[q][r];
  __syncthreads();
}

// The stages after the first: radix 16 while 16 divides what is left, then
// one 8, 4 or 2
template <int LM, int LNS>
__device__ __forceinline__ void fft_stages(float2* buf, const float2* __restrict__ tw) {
  if constexpr (LM - LNS >= 4) {
    fft_stage<16, LM, LNS>(buf, nullptr, nullptr, tw, 0);
    fft_stages<LM, LNS + 4>(buf, tw);
  } else if constexpr (LM - LNS == 3) {
    fft_stage<8, LM, LNS>(buf, nullptr, nullptr, tw, 0);
  } else if constexpr (LM - LNS == 2) {
    fft_stage<4, LM, LNS>(buf, nullptr, nullptr, tw, 0);
  } else if constexpr (LM - LNS == 1) {
    fft_stage<2, LM, LNS>(buf, nullptr, nullptr, tw, 0);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// at most 64 registers a thread, so four CTAs of 256 threads share an SM:
// the serving shape's 528 CTAs are then one wave
template <int LM, bool MAG>
__global__ void __launch_bounds__(Tile<LM>::NT, 1024 / Tile<LM>::NT)
stft_fft_kernel(const float* __restrict__ xp, const float* __restrict__ table,
                float* __restrict__ out_a, float* __restrict__ out_b, int Lp, int n_t,
                int hop, int tiles, int span_len) {
  constexpr int M = Tile<LM>::M, F = Tile<LM>::F, NT = Tile<LM>::NT;
  constexpr int n_fft = 2 * M;
  extern __shared__ __align__(16) float smem[];
  float* span = smem;
  float2* buf = reinterpret_cast<float2*>(smem + span_len);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * F;
  const float2* win2 = reinterpret_cast<const float2*>(table);
  const float2* tw = reinterpret_cast<const float2*>(table + n_fft);

  // the tile's span of the row, once, into span[head ...]
  {
    const float* src = xp + (long long)b * Lp + (long long)t0 * hop;
    const int head = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const float* abase = src - head;   // 16-byte aligned
    const int S = (F - 1) * hop + n_fft;
    const int valid = min(S, Lp - t0 * hop);
    const int end = head + valid;
    const int lo = min((head + 3) & ~3, end);
    const int hi = max(lo, end & ~3);
    for (int c = (lo >> 2) + tid; c < (hi >> 2); c += NT) cp_async16(span + 4 * c, abase + 4 * c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = head + tid; i < lo; i += NT) span[i] = __ldg(abase + i);
    for (int i = hi + tid; i < end; i += NT) span[i] = __ldg(abase + i);
    for (int i = end + tid; i < head + S; i += NT) span[i] = 0.f;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    span += head;
  }

  fft_stage<16, LM, 0>(buf, span, win2, tw, hop);
  fft_stages<LM, 4>(buf, tw);

  // the real split: the M/16 threads of frame f take the pairs
  // k = l + (M/16) i, i < 8, with X[k] = E + W^k O and X[M-k] =
  // conj(E - W^k O), E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i
  // (pair 0 gives X[0] and X[M]); thread 0 of a frame also X[M/2] = conj
  // Z[M/2]. |X| is taken here in magnitude mode.
  constexpr int TPF = M / 16;                    // threads a frame
  const int f = tid / TPF;
  const int l = tid % TPF;
  float2 xs[8], ys[8];
  const float2* z = buf + pad(f * M);            // M is a multiple of 16
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = l + i * TPF;
    const int kc = (M - k) & (M - 1);
    const float2 a = z[k + (k >> 4)], c = z[kc + (kc >> 4)];
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 od = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
    const float2 wo = cmul(__ldg(tw + k), od);
    xs[i] = cadd(e, wo);                                // X[k]
    ys[i] = make_float2(e.x - wo.x, wo.y - e.y);        // X[M - k]
    if (MAG) {
      xs[i].x = sqrtf(xs[i].x * xs[i].x + xs[i].y * xs[i].y);
      ys[i].x = sqrtf(ys[i].x * ys[i].x + ys[i].y * ys[i].y);
    }
  }
  float2 mid = z[(M >> 1) + (M >> 5)];
  mid.y = -mid.y;
  if (MAG) mid.x = sqrtf(mid.x * mid.x + mid.y * mid.y);

  // Stage the tile's output in the buffer as the run it is in each output
  // tensor (element i at sa[i] and sb[i], which sit at out_a's phase in 16
  // bytes), then store the run with 16-byte stores between a scalar head and
  // tail.
  const int n_bins = M + 1;
  const int nf = min(F, n_t - t0);
  const int run = nf * n_bins;
  const long long o0 = ((long long)b * n_t + t0) * n_bins;
  float* oa = out_a + o0;
  float* ob = out_b + o0;
  const int pa = (int)((reinterpret_cast<uintptr_t>(oa) >> 2) & 3);
  float* sa = reinterpret_cast<float*>(buf) + pa;
  float* sb = sa + ((F * n_bins + 7) & ~3);
  __syncthreads();                               // every read of the transform is done
  if (f < nf) {
    float* ra = sa + f * n_bins;
    float* rb = sb + f * n_bins;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = l + i * TPF;
      ra[k] = xs[i].x;
      ra[M - k] = ys[i].x;
      if (!MAG) {
        rb[k] = xs[i].y;
        rb[M - k] = ys[i].y;
      }
    }
    if (l == 0) {
      ra[M >> 1] = mid.x;
      if (!MAG) rb[M >> 1] = mid.y;
    }
  }
  __syncthreads();
  const int head = min((4 - pa) & 3, run);
  const int body = (run - head) & ~3;
  for (int c = tid; c < (body >> 2); c += NT) {
    const int i = head + 4 * c;
    *reinterpret_cast<float4*>(oa + i) = *reinterpret_cast<const float4*>(sa + i);
    if (!MAG) *reinterpret_cast<float4*>(ob + i) = *reinterpret_cast<const float4*>(sb + i);
  }
  for (int r = tid; r < run - body; r += NT) {
    const int i = r < head ? r : body + r;
    oa[i] = sa[i];
    if (!MAG) ob[i] = sb[i];
  }
}

// devices whose shared-memory opt-in is cached; others opt in on every launch
constexpr int MAX_DEVICES = 64;

template <int LM, bool MAG>
int launch_fft(int smem, int ctas, const float* xp, const float* table, float* out_a,
               float* out_b, int Lp, int n_t, int hop, cudaStream_t s) {
  // the opt-in holds for the current device only: one entry per device
  static int smem_set[MAX_DEVICES] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || smem > smem_set[dev]) {
      e = cudaFuncSetAttribute(stft_fft_kernel<LM, MAG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) smem_set[dev] = smem;
    }
  }
  constexpr int F = Tile<LM>::F;
  stft_fft_kernel<LM, MAG><<<ctas, Tile<LM>::NT, smem, s>>>(
      xp, table, out_a, out_b, Lp, n_t, hop, (n_t + F - 1) / F, span_floats(F, hop, 2 << LM));
  return (int)cudaGetLastError();
}

using Launch = int (*)(int, int, const float*, const float*, float*, float*, int, int, int,
                       cudaStream_t);
// by magnitude, then log2(n_fft / 2) - 4: n_fft = 32 .. N_FFT_CAP
constexpr Launch LAUNCH[2][9] = {
    {launch_fft<4, false>, launch_fft<5, false>, launch_fft<6, false>, launch_fft<7, false>,
     launch_fft<8, false>, launch_fft<9, false>, launch_fft<10, false>, launch_fft<11, false>,
     launch_fft<12, false>},
    {launch_fft<4, true>, launch_fft<5, true>, launch_fft<6, true>, launch_fft<7, true>,
     launch_fft<8, true>, launch_fft<9, true>, launch_fft<10, true>, launch_fft<11, true>,
     launch_fft<12, true>}};
static_assert(2 << 12 == N_FFT_CAP && 2 << 4 == FFT_MIN, "LAUNCH covers the FFT path");

// The launch for a shape, or path REFUSED. ops/stft_kernel.py's stft_plan is
// the same function.
Plan plan_stft(int B, int Lp, int n_t, int n_fft, int hop) {
  Plan p{REFUSED, 0, 0, 0, 0};
  if (B < 1 || n_t < 1 || hop < 1 || n_fft < 2 || n_fft > DIRECT_N_FFT_CAP ||
      n_fft % hop != 0 || (long long)Lp < (long long)(n_t - 1) * hop + n_fft)
    return p;
  const int n_bins = n_fft / 2 + 1;
  if ((n_fft & (n_fft - 1)) == 0 && n_fft >= FFT_MIN && n_fft <= N_FFT_CAP) {
    const int M = n_fft / 2;
    const int F = FFT_POINTS / M < MAX_FRAMES ? FFT_POINTS / M : MAX_FRAMES;
    const int threads = F * M / PTS;
    // floats of the buffer: the padded transform, or the staged output
    const int fft = 2 * (F * M + F * M / 16), staged = 2 * F * (M + 1) + 12;
    return Plan{FFT, F, threads / 32, 4 * (span_floats(F, hop, n_fft) + max(fft, staged)),
                B * ((n_t + F - 1) / F)};
  }
  const long long M = (long long)B * n_t;
  const long long ctas = (M + BM - 1) / BM * ((n_bins + BNB - 1) / BNB);
  if (ctas > INT_MAX) return p;
  return Plan{DIRECT, BM, TPB / 32, (int)(sizeof(float) * BK * (AS_STRIDE + 2 * BNB)),
              (int)ctas};
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 on success. table is the windowed rDFT matrix
// A (n_fft, 2*n_bins) on the direct path, the window and twiddle table
// (3*n_fft floats) on the FFT path. out_b is unused when magnitude != 0.
int sep_stft(const float* xp, const float* table, float* out_a, float* out_b, int B, int Lp,
             int n_t, int n_fft, int hop, int magnitude, void* stream) {
  const Plan p = plan_stft(B, Lp, n_t, n_fft, hop);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.path == REFUSED) return (int)cudaErrorInvalidValue;
  if (p.path == DIRECT) {
    const int n_bins = n_fft / 2 + 1;
    const long long M = (long long)B * n_t;
    const dim3 grid((unsigned int)((M + BM - 1) / BM), (unsigned int)((n_bins + BNB - 1) / BNB));
    stft_direct_kernel<<<grid, TPB, 0, s>>>(xp, table, out_a, out_b, B, Lp, n_t, n_fft, hop,
                                            magnitude);
    return (int)cudaGetLastError();
  }
  // both outputs share the 16-byte phase the store loop takes from out_a
  const uintptr_t phase = reinterpret_cast<uintptr_t>(out_a) ^ reinterpret_cast<uintptr_t>(out_b);
  if (!magnitude && (phase & 15))
    return (int)cudaErrorMisalignedAddress;
  const int lm = 30 - __builtin_clz((unsigned)n_fft);     // log2(n_fft / 2), 4..12
  return LAUNCH[magnitude != 0][lm - 4](p.smem, p.ctas, xp, table, out_a, out_b, Lp, n_t, hop, s);
}

// The plan of a shape: path (0 fft, 1 direct, -1 refused), frames a CTA,
// warps a CTA, shared bytes a CTA, CTAs, and the largest n_fft of the path
// taken (N_FFT_CAP, or DIRECT_N_FFT_CAP on the direct path or when refused).
// Returns 0, or 1 when no path takes the shape.
int sep_stft_plan(int B, int Lp, int n_t, int n_fft, int hop, int magnitude, int* path,
                  int* frames, int* warps, int* smem, int* ctas, int* cap) {
  (void)magnitude;
  const Plan p = plan_stft(B, Lp, n_t, n_fft, hop);
  *path = p.path;
  *frames = p.frames;
  *warps = p.warps;
  *smem = p.smem;
  *ctas = p.ctas;
  *cap = p.path == FFT ? N_FFT_CAP : DIRECT_N_FFT_CAP;
  return p.path == REFUSED ? 1 : 0;
}

const char* sep_stft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
