// LSTM forward recurrence for Hopper: all T steps of both directions of one
// BLSTM layer in one cooperative launch. One source, two instances chosen at
// compile time, so the two cannot drift:
//
//   SAVE = false  the inference forward. Replaces speech_separation_tpu/ops/
//                 lstm_pallas.py::lstm_seq_infer (_fwd_infer_kernel).
//   SAVE = true   the training forward. Replaces lstm_pallas.py::lstm_seq_fwd
//                 (_fwd_kernel): the same recurrence, and also the saves the
//                 backward (lstm_bwd.cu) reads.
//
// Contract:
//   xw      (T, D, B, 4H)  gate inputs x @ W_ih + b, bf16 or f32
//   w_hh    (D, H, 4H)     recurrent weights, the same type as xw
//   h0, c0  (D, B, H)      f32
//   lengths (B,)           int32
//   ys      (T, D, B, H)   m * h_new (zero at masked steps): f32 without
//                          saves, the weight type with them
//   cs      (T, D, B, H)   SAVE only: the carried cell state, weight type
//   gates   (T, D, B, 4H)  SAVE only: post-activation (i, f, tanh g, o),
//                          weight type
//   h_last, c_last (D, B, H) f32
// The save type is the weight type: the only pairing the training path makes
// (models/blstm.py), and the one the backward's exchange relies on.
// Direction d uses a suffix mask (valid iff lengths[b] > T-1-t) when bit d of
// suffix_mask is set, a prefix mask (valid iff lengths[b] > t) otherwise. At a
// masked step the carry passes through. Gates are (i, f, g, o); the product
// takes h_{t-1} rounded to the weight type and accumulates in f32; the cell
// state and the nonlinearities stay f32.
//
// What bounds it: the recurrence is a chain of T dependent steps, each a
// (B, H) x (H, 4H) product per direction. At H=600 a direction's W_hh is
// 2.88 MB in bf16, far more than one SM's 227 KB of shared memory, and
// re-reading it from L2 every step would make each step L2-bound. So the
// weights are split by hidden unit: a grid of D * ceil(H/16) CTAs, each owning
// 16 units of one direction (gate columns j, H+j, 2H+j, 3H+j), keeps its slice
// of W_hh resident in shared memory for the whole sequence (76.8 KB in bf16,
// 153.6 KB in f32 at H=600). i, f, g and o of a unit stay in one CTA, so the
// cell update needs nothing from other CTAs. Per step a CTA stages h_{t-1}
// (B x H, f32, from a double-buffered global buffer in L2) transposed into
// shared memory, computes its 4 x 16 gate columns for all rows with f32 FMAs,
// updates c and h of its units, and writes h_t (and, with saves, ys, cs and
// the gates). A grid-wide barrier (global counter, release/acquire) separates
// the steps. The cooperative launch refuses a grid that cannot be co-resident
// instead of deadlocking in the barrier. Per step what is left is latency
// (staging h_{t-1} from L2, the barrier) and the FMA work of the product on
// the CUDA cores; the tensor cores (wgmma) are not used yet.

#include <type_traits>

#include "lstm_common.cuh"

namespace {

using namespace seplstm;

// The four gate weights of one unit at one k, stored contiguously.
__device__ __forceinline__ void load_w4(const float* p, float w[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float w[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

template <typename WT, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const WT* __restrict__ xw, const WT* __restrict__ w_hh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const int* __restrict__ lengths,
                std::conditional_t<SAVE, WT, float>* __restrict__ ys,
                WT* __restrict__ cs, WT* __restrict__ gates_out,
                float* __restrict__ h_last, float* __restrict__ c_last,
                float* hbuf, unsigned int* barrier,
                int T, int D, int B, int H, unsigned int suffix_mask) {
  using YT = std::conditional_t<SAVE, WT, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (H + HB - 1) / HB;
  const int d = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * HB;
  const size_t G = 4 * (size_t)H;
  const size_t DBH = (size_t)D * B * H;

  WT* Ws = reinterpret_cast<WT*>(smem);                                   // (H, HB, 4)
  float* Hs = reinterpret_cast<float*>(smem + (size_t)H * HB * 4 * sizeof(WT));  // (H, HS_STRIDE)

  // this CTA's slice of W_hh, resident for the whole sequence
  const WT* wd = w_hh + (size_t)d * H * G;
  for (int idx = threadIdx.x; idx < H * HB * 4; idx += THREADS) {
    const int g = idx & 3;
    const int jl = (idx >> 2) % HB;
    const int k = idx / (4 * HB);
    const int j = j0 + jl;
    Ws[idx] = (j < H) ? wd[(size_t)k * G + (size_t)g * H + j] : from_f<WT>(0.f);
  }

  const int tid = threadIdx.x;
  const int ks = tid & (KS - 1);         // slice of the sum over H
  const int jl = (tid >> 2) & (HB - 1);  // unit within the CTA
  const int rq = tid >> 6;               // quad of rows within a chunk
  const int j = j0 + jl;
  const bool suffix = (suffix_mask >> d) & 1u;
  const unsigned int nblocks = gridDim.x;

  for (int t = 0; t < T; ++t) {
    const float* hsrc = (t == 0) ? h0 : hbuf + (size_t)(t & 1) * DBH;
    float* hdst = hbuf + (size_t)((t + 1) & 1) * DBH;
    for (int b0 = 0; b0 < B; b0 += RB) {
      __syncthreads();  // the previous chunk's readers are done with Hs
      for (int idx = tid; idx < RB * H; idx += THREADS) {
        const int r = idx / H;
        const int k = idx - r * H;
        const int b = b0 + r;
        const float v = (b < B) ? __ldcg(hsrc + ((size_t)d * B + b) * H + k) : 0.f;
        Hs[k * HS_STRIDE + r] = round_like(v, WT());
      }
      __syncthreads();

      // after the reduction this thread owns row b, unit j
      const int b = b0 + rq * 4 + ks;
      const bool owner = (b < B) && (j < H);
      float xg[4] = {0.f, 0.f, 0.f, 0.f};
      if (owner) {
        const WT* xp = xw + (((size_t)t * D + d) * B + b) * G + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = to_f(xp[(size_t)g * H]);
      }

      float acc[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[g][r] = 0.f;
      for (int k = ks; k < H; k += KS) {
        float w[4];
        load_w4(Ws + ((size_t)k * HB + jl) * 4, w);
        const float4 hv = *reinterpret_cast<const float4*>(Hs + k * HS_STRIDE + rq * 4);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g][0] = fmaf(w[g], hv.x, acc[g][0]);
          acc[g][1] = fmaf(w[g], hv.y, acc[g][1]);
          acc[g][2] = fmaf(w[g], hv.z, acc[g][2]);
          acc[g][3] = fmaf(w[g], hv.w, acc[g][3]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], 1);
          acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], 2);
        }

      if (owner) {
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g] = ks == 0 ? acc[g][0] : ks == 1 ? acc[g][1] : ks == 2 ? acc[g][2] : acc[g][3];
        const size_t o = ((size_t)d * B + b) * H + j;
        const bool valid = step_valid(suffix, lengths[b], t, T);
        const float h_prev = __ldcg(hsrc + o);
        const float c_prev = (t == 0) ? c0[o] : c_last[o];
        const float ia = sigmoidf(xg[0] + pre[0]);
        const float fa = sigmoidf(xg[1] + pre[1]);
        const float ga = tanhf(xg[2] + pre[2]);
        const float oa = sigmoidf(xg[3] + pre[3]);
        const float c_new = fa * c_prev + ia * ga;
        const float h_new = oa * tanhf(c_new);
        const float h_out = valid ? h_new : h_prev;
        const float c_out = valid ? c_new : c_prev;
        const size_t so = ((size_t)t * D + d) * B + b;
        hdst[o] = h_out;
        c_last[o] = c_out;
        ys[so * H + j] = from_f<YT>(valid ? h_new : 0.f);
        if constexpr (SAVE) {
          cs[so * H + j] = from_f<WT>(c_out);
          WT* gp = gates_out + so * G + j;
          gp[0] = from_f<WT>(ia);
          gp[(size_t)H] = from_f<WT>(fa);
          gp[2 * (size_t)H] = from_f<WT>(ga);
          gp[3 * (size_t)H] = from_f<WT>(oa);
        }
        if (t == T - 1) h_last[o] = h_out;
      }
    }
    // every CTA's h_t must be visible before any CTA stages it for step t+1
    if (t + 1 < T) grid_barrier(barrier, (unsigned int)(t + 1) * nblocks);
  }
}

template <typename WT, bool SAVE>
int launch(const void* xw, const void* w_hh, const float* h0, const float* c0,
           const int* lengths, void* ys, void* cs, void* gates, float* h_last,
           float* c_last, float* hbuf, unsigned int* barrier, int T, int D, int B, int H,
           unsigned int suffix_mask, cudaStream_t stream) {
  using YT = std::conditional_t<SAVE, WT, float>;
  const size_t smem = (size_t)H * HB * 4 * sizeof(WT) + (size_t)H * HS_STRIDE * sizeof(float);
  auto kernel = lstm_fwd_kernel<WT, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const WT* xw_t = static_cast<const WT*>(xw);
  const WT* w_t = static_cast<const WT*>(w_hh);
  YT* ys_t = static_cast<YT*>(ys);
  WT* cs_t = static_cast<WT*>(cs);
  WT* gates_t = static_cast<WT*>(gates);
  void* args[] = {(void*)&xw_t, (void*)&w_t, (void*)&h0, (void*)&c0, (void*)&lengths,
                  (void*)&ys_t, (void*)&cs_t, (void*)&gates_t, (void*)&h_last,
                  (void*)&c_last, (void*)&hbuf, (void*)&barrier,
                  (void*)&T, (void*)&D, (void*)&B, (void*)&H, (void*)&suffix_mask};
  const dim3 grid(D * ((H + HB - 1) / HB));
  const dim3 block(THREADS);
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 on success. xw and w_hh are bf16 when
// bf16 != 0, f32 otherwise; ys is f32; hbuf is (2, D, B, H) f32 scratch,
// barrier one zeroed uint32.
int sep_lstm_infer(const void* xw, const void* w_hh, int bf16, const float* h0,
                   const float* c0, const int* lengths, float* ys, float* h_last,
                   float* c_last, float* hbuf, unsigned int* barrier, int T, int D, int B,
                   int H, unsigned int suffix_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, false>(xw, w_hh, h0, c0, lengths, ys, nullptr, nullptr,
                                        h_last, c_last, hbuf, barrier, T, D, B, H,
                                        suffix_mask, s);
  return launch<float, false>(xw, w_hh, h0, c0, lengths, ys, nullptr, nullptr, h_last,
                              c_last, hbuf, barrier, T, D, B, H, suffix_mask, s);
}

// The training forward: as sep_lstm_infer, and ys, cs and gates are written in
// the weight type.
int sep_lstm_fwd(const void* xw, const void* w_hh, int bf16, const float* h0,
                 const float* c0, const int* lengths, void* ys, void* cs, void* gates,
                 float* h_last, float* c_last, float* hbuf, unsigned int* barrier, int T,
                 int D, int B, int H, unsigned int suffix_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, true>(xw, w_hh, h0, c0, lengths, ys, cs, gates, h_last,
                                       c_last, hbuf, barrier, T, D, B, H, suffix_mask, s);
  return launch<float, true>(xw, w_hh, h0, c0, lengths, ys, cs, gates, h_last, c_last,
                             hbuf, barrier, T, D, B, H, suffix_mask, s);
}

const char* sep_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
