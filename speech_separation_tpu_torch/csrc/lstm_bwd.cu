// LSTM backward recurrence for Hopper: all T steps of both directions of one
// BLSTM layer, in reverse time, in one cooperative launch.
//
// Replaces speech_separation_tpu/ops/lstm_pallas.py::lstm_seq_bwd (the Pallas
// kernel _bwd_kernel). Same contract:
//   w_hh    (D, H, 4H)     recurrent weights, bf16 or f32
//   c0      (D, B, H)      f32
//   lengths (B,)           int32
//   cs      (T, D, B, H)   saved carried cell states, weight type
//   gates   (T, D, B, 4H)  saved post-activation (i, f, tanh g, o), weight type
//   dys     (T, D, B, H)   cotangent of ys, weight type
//   dh_last, dc_last (D, B, H) f32
//   dxw     (T, D, B, 4H)  pre-activation gate gradients, weight type, exactly
//                          zero at masked steps
//   dh0, dc0 (D, B, H)     f32
// The save type must be the weight type (the only pairing the training path
// makes): the TPU kernel rounds dgates to the weight type before the product
// dgates @ W_hh^T, and that rounded value is exactly what dxw holds, so dxw
// itself is the exchange buffer between CTAs. Mask rule as in lstm_fwd.cu.
// Per step, mirroring _bwd_kernel:
//   dh_new = m (dh + dys_t);  tanh_c = tanh(cs_t)
//   dc_new = m dc + dh_new o (1 - tanh_c^2)
//   c_prev = cs_{t-1} (saved, rounded), or c0 at t = 0
//   dgates = (dc_new g i(1-i), dc_new c_prev f(1-f), dc_new i (1-g^2),
//             dh_new tanh_c o(1-o))
//   dh <- (1-m) dh + round(dgates) @ W_hh^T;  dc <- (1-m) dc + dc_new f
//
// What bounds it: a chain of T dependent steps, each a (B, 4H) x (4H, H)
// product per direction. The dh of one hidden unit needs the dgates of all 4H
// columns of its direction, so what must be exchanged per step is dgates
// (B x 4H), four times the forward's h. The design keeps the forward's split
// by unit: a grid of D * ceil(H/16) CTAs, each owning 16 units of one
// direction, keeps the rows j0..j0+15 of W_hh (all 4H columns) resident in
// shared memory (76.8 KB in bf16, 153.6 KB in f32 at H=600). Per step a CTA
//   A. computes the 64 dgate columns of its units from its own dh and dc (kept
//      in dh0/dc0, which only this CTA touches), the saved gates and cs, and
//      writes them to dxw[t];
//   -- grid barrier --
//   B. stages the direction's whole dxw[t] (through L2), in chunks of rows
//      and columns, transposed into shared memory, and forms dh of its units
//      with f32 FMAs on the CUDA cores.
// One grid barrier per step; tensor cores are not used yet.

#include "lstm_common.cuh"

namespace {

using namespace seplstm;

constexpr int KC = 800;   // dgate columns staged per pass (64 KB of f32)

template <typename WT>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const WT* __restrict__ w_hh, const float* __restrict__ c0,
                const int* __restrict__ lengths, const WT* __restrict__ cs,
                const WT* __restrict__ gates, const WT* __restrict__ dys,
                const float* __restrict__ dh_last, const float* __restrict__ dc_last,
                WT* dxw, float* dh0, float* dc0, unsigned int* barrier,
                int T, int D, int B, int H, unsigned int suffix_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (H + HB - 1) / HB;
  const int d = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * HB;
  const int G = 4 * H;

  WT* Ws = reinterpret_cast<WT*>(smem);                                     // (4H, HB)
  float* Ds = reinterpret_cast<float*>(smem + (size_t)G * HB * sizeof(WT));  // (KC, HS_STRIDE)

  // rows j0..j0+15 of this direction's W_hh, all 4H columns, resident
  const WT* wd = w_hh + (size_t)d * H * G;
  for (int idx = threadIdx.x; idx < G * HB; idx += THREADS) {
    const int c = idx % G;
    const int jl = idx / G;
    const int j = j0 + jl;
    Ws[c * HB + jl] = (j < H) ? wd[(size_t)j * G + c] : from_f<WT>(0.f);
  }

  const int tid = threadIdx.x;
  const bool suffix = (suffix_mask >> d) & 1u;
  const unsigned int nblocks = gridDim.x;
  // phase A: thread -> (row in chunk, unit); phase B as in lstm_fwd.cu
  const int a_r = tid >> 4, a_j = j0 + (tid & (HB - 1));
  const int ks = tid & (KS - 1), jl = (tid >> 2) & (HB - 1), rq = tid >> 6;
  const int j = j0 + jl;

  for (int t = T - 1; t >= 0; --t) {
    // ---- A: this CTA's dgate columns at step t
    for (int b0 = 0; b0 < B; b0 += RB) {
      const int b = b0 + a_r;
      if (b >= B || a_j >= H) continue;
      const size_t o = ((size_t)d * B + b) * H + a_j;
      const size_t so = ((size_t)t * D + d) * B + b;
      const float dh = (t == T - 1) ? dh_last[o] : dh0[o];
      const float dc = (t == T - 1) ? dc_last[o] : dc0[o];
      WT* dp = dxw + so * G + a_j;
      if (step_valid(suffix, lengths[b], t, T)) {
        const WT* gp = gates + so * G + a_j;
        const float ia = to_f(gp[0]);
        const float fa = to_f(gp[(size_t)H]);
        const float ga = to_f(gp[2 * (size_t)H]);
        const float oa = to_f(gp[3 * (size_t)H]);
        const float c_t = to_f(cs[so * H + a_j]);
        const float c_prev =
            (t > 0) ? to_f(cs[(so - (size_t)D * B) * H + a_j]) : c0[o];
        const float dh_new = dh + to_f(dys[so * H + a_j]);
        const float tanh_c = tanhf(c_t);
        const float dc_new = dc + dh_new * oa * (1.f - tanh_c * tanh_c);
        dp[0] = from_f<WT>(dc_new * ga * ia * (1.f - ia));
        dp[(size_t)H] = from_f<WT>(dc_new * c_prev * fa * (1.f - fa));
        dp[2 * (size_t)H] = from_f<WT>(dc_new * ia * (1.f - ga * ga));
        dp[3 * (size_t)H] = from_f<WT>(dh_new * tanh_c * oa * (1.f - oa));
        dc0[o] = dc_new * fa;
        dh0[o] = 0.f;   // phase B adds the product
      } else {
        const WT z = from_f<WT>(0.f);
        dp[0] = z; dp[(size_t)H] = z; dp[2 * (size_t)H] = z; dp[3 * (size_t)H] = z;
        dc0[o] = dc;
        dh0[o] = dh;
      }
    }
    // every CTA's dgates at step t must be visible before any CTA reads them
    grid_barrier(barrier, (unsigned int)(T - t) * nblocks);

    // ---- B: dh of this CTA's units += dxw[t] @ W_hh[j0:j0+16]^T
    const WT* drow = dxw + ((size_t)t * D + d) * B * G;
    for (int b0 = 0; b0 < B; b0 += RB) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0_ = 0; c0_ < G; c0_ += KC) {
        const int kc = min(KC, G - c0_);
        __syncthreads();  // the previous pass's readers are done with Ds
        for (int idx = tid; idx < RB * kc; idx += THREADS) {
          const int r = idx / kc;
          const int c = idx - r * kc;
          const int b = b0 + r;
          Ds[c * HS_STRIDE + r] =
              (b < B) ? to_f(__ldcg(drow + (size_t)b * G + c0_ + c)) : 0.f;
        }
        __syncthreads();
        for (int c = ks; c < kc; c += KS) {
          const float w = to_f(Ws[(c0_ + c) * HB + jl]);
          const float4 dv = *reinterpret_cast<const float4*>(Ds + c * HS_STRIDE + rq * 4);
          acc[0] = fmaf(w, dv.x, acc[0]);
          acc[1] = fmaf(w, dv.y, acc[1]);
          acc[2] = fmaf(w, dv.z, acc[2]);
          acc[3] = fmaf(w, dv.w, acc[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
      }
      const int b = b0 + rq * 4 + ks;
      if (b < B && j < H) {
        const float s = ks == 0 ? acc[0] : ks == 1 ? acc[1] : ks == 2 ? acc[2] : acc[3];
        dh0[((size_t)d * B + b) * H + j] += s;
      }
    }
    __syncthreads();  // dh0 of this CTA's units is complete for step t-1's phase A
  }
}

template <typename WT>
int launch(const void* w_hh, const float* c0, const int* lengths, const void* cs,
           const void* gates, const void* dys, const float* dh_last, const float* dc_last,
           void* dxw, float* dh0, float* dc0, unsigned int* barrier, int T, int D, int B,
           int H, unsigned int suffix_mask, cudaStream_t stream) {
  const size_t smem = (size_t)4 * H * HB * sizeof(WT) + (size_t)KC * HS_STRIDE * sizeof(float);
  auto kernel = lstm_bwd_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const WT* w_t = static_cast<const WT*>(w_hh);
  const WT* cs_t = static_cast<const WT*>(cs);
  const WT* gates_t = static_cast<const WT*>(gates);
  const WT* dys_t = static_cast<const WT*>(dys);
  WT* dxw_t = static_cast<WT*>(dxw);
  void* args[] = {(void*)&w_t, (void*)&c0, (void*)&lengths, (void*)&cs_t, (void*)&gates_t,
                  (void*)&dys_t, (void*)&dh_last, (void*)&dc_last, (void*)&dxw_t,
                  (void*)&dh0, (void*)&dc0, (void*)&barrier,
                  (void*)&T, (void*)&D, (void*)&B, (void*)&H, (void*)&suffix_mask};
  const dim3 grid(D * ((H + HB - 1) / HB));
  const dim3 block(THREADS);
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 on success. w_hh, cs, gates, dys and dxw are
// bf16 when bf16 != 0, f32 otherwise; barrier is one zeroed uint32.
int sep_lstm_bwd(const void* w_hh, int bf16, const float* c0, const int* lengths,
                 const void* cs, const void* gates, const void* dys, const float* dh_last,
                 const float* dc_last, void* dxw, float* dh0, float* dc0,
                 unsigned int* barrier, int T, int D, int B, int H, unsigned int suffix_mask,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(w_hh, c0, lengths, cs, gates, dys, dh_last, dc_last, dxw,
                                 dh0, dc0, barrier, T, D, B, H, suffix_mask, s);
  return launch<float>(w_hh, c0, lengths, cs, gates, dys, dh_last, dc_last, dxw, dh0, dc0,
                       barrier, T, D, B, H, suffix_mask, s);
}

const char* sep_lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
