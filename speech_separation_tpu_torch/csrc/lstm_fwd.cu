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
// (B, H) x (H, 4H) product per direction, far too little work per step to
// fill the card (the bound, 0.28 ms at T=384, B=100, H=600 in bf16, is the
// bytes of xw and the saves). What sets the pace is the latency of one step:
// every CTA must see all of h_{t-1} of its direction before it can form its
// gates. One direction's W_hh (2.88 MB in bf16 at H=600) is far more than an
// SM's shared memory, so the weights are split by hidden unit and stay
// resident, and h is what the CTAs exchange, through L2, once per step.
//
// The design (as lstm_bwd.cu's). The grid is D * ceil(H/8) CTAs (150 at
// H=600), each owning U = 8 units of one direction (gate columns j, H+j,
// 2H+j, 3H+j of its units: i, f, g and o of a unit stay in one CTA, so the
// cell update needs nothing from other CTAs), at two CTAs per SM, each within
// 113 KB of shared memory whatever B, so all 132 SMs work. The launch is
// cooperative with one grid barrier per step; the wrapper checks
// co-residency (sep_lstm_fwd_plan) and raises, naming the cap, for a grid
// that cannot be resident: on an H100, H above 1056 (more than 264 CTAs), or
// in f32 above 848 (W no longer fits beside the smallest ring at two CTAs per
// SM). A CTA keeps in shared memory
//   - its 32 gate columns of W_hh, one row per column (row g*8 + u: gate g of
//     unit j0+u), k contiguous, a row an odd number of 16-byte units so
//     ldmatrix and float4 reads of 8 rows hit distinct banks: 39.4 KB in
//     bf16, 78.3 KB in f32 at H=600;
//   - a 2-stage ring of h_{t-1} chunks, each one group of batch rows by 256
//     bytes, 128 bf16 or 64 f32 columns (Ring in lstm_common.cuh). A group
//     is the most rows (whole m-tiles in bf16, at most 128) whose ring and xw
//     buffer fit beside W at two CTAs per SM: at B=100, H=600 the whole batch
//     in bf16 (5 chunks per step), groups of 48 rows in f32 (10 chunks each);
//   - the group's 32 columns of xw[t], fetched with cp.async a group ahead
//     (for the first group of step t+1, before step t's grid barrier), so
//     xw is off the critical path.
// The exchange buffer hbuf (2, D, B, Hp) is in the weight type, its rows
// padded to Hp, a multiple of 8 elements, so every row is 16-byte aligned at
// any H and is streamed with 16-byte cp.async (through L2 only: other CTAs
// wrote it). The product rounds h_{t-1} to the weight type anyway, so its
// operands are what an f32 exchange would give; the carry stays f32: each
// (row, unit) has one owning thread, which keeps h and c in h_last and c_last
// (h0 and c0 at t = 0), so the masked pass-through and h_last are exact. The
// owner of a pad column (H <= j < Hp) writes zero to hbuf.
// Per step a CTA, for each group of rows, streams h_{t-1} through the ring,
// the next chunk in flight while one is consumed, and forms its 32 gate
// columns:
//   bf16: mma.sync m16n8k16 (bf16 x bf16, f32 sums) on the tensor cores.
//     Warp w owns m-tile w of the group and all four gate n-tiles, A = 16 h
//     rows of the stage, B = 8 resident W rows, both by ldmatrix; so a
//     thread's accumulators hold i, f, g and o of the same (row, unit)s and
//     the cell update needs no shuffle. Each chunk's sum starts from zero
//     and is added to the total in f32 (closer to the exact sum than one
//     chain of tensor-core sums over all k, at no cost in time). Each sum
//     has one owner and a fixed order: no atomics, bit-identical from run to
//     run.
//   f32: FMAs on the CUDA cores (TF32 would round the operands). A thread
//     takes one unit's four gates for a quad of 4 rows, over one of S slices
//     of the k (S = 1 at 128 rows up to 8 at 16, so all 256 threads work
//     whatever B): per 4 k, 4 float4 loads of W and 4 of h feed 64 FMAs. The
//     slices' sums are added across lanes by shuffles in a fixed order.
// Then the owners update c and h, write h_t to hbuf and ys (and, with saves,
// cs and the gates: bf16 pairs of units where H is even), and the grid
// barrier separates the steps. What is left per step is latency: the chunk
// round trips to L2, one __syncthreads per chunk, the epilogue and the
// barrier.

#include "lstm_common.cuh"

namespace {

using namespace seplstm;

constexpr int U = 8;                 // hidden units per CTA
constexpr int NT = 256;              // threads per CTA (8 warps)
constexpr int MAX_GROUP = 128;       // rows per group: 1 m-tile per warp (bf16), 32 quads of rows (f32)
constexpr int MAX_SLICES = 8;        // f32: most threads that split one product's k

template <typename WT> struct Layout {
  using R = Ring<WT, 256>;           // a stage row: 128 bf16 or 64 f32 columns
  int Hp, kpad, ws, rows, nchunks;   // rows: batch rows of one group (one ring stage)
  size_t w_bytes, stage_bytes;
  static constexpr int rs = R::rs;
  static constexpr int kc = R::kc;
  static constexpr int xrs = 4 * U * (int)sizeof(WT) + 16;   // a row of the xw buffer
  __host__ __device__ Layout(int B, int H) {
    constexpr bool bf16 = !std::is_same<WT, float>::value;
    Hp = (H + U - 1) / U * U;
    kpad = (H + 15) / 16 * 16;                 // k padded to whole mma k-steps
    ws = kpad + 16 / (int)sizeof(WT);          // odd count of 16-byte units per row
    nchunks = (kpad + kc - 1) / kc;
    w_bytes = (size_t)4 * U * ws * sizeof(WT);
    // the most rows (whole m-tiles in bf16, multiples of 8 in f32) whose ring
    // and xw buffer fit beside W at two CTAs per SM; at least one step of
    // rows (the plan then finds one CTA per SM)
    const int step = bf16 ? 16 : 8;
    const long long left = (long long)SMEM_PER_CTA - (long long)w_bytes;
    int fit = left > 0 ? (int)(left / (2 * rs + xrs)) / step * step : 0;
    fit = fit < step ? step : (fit > MAX_GROUP ? MAX_GROUP : fit);
    const int need = bf16 ? (B + 15) / 16 * 16 : B;
    rows = need < fit ? need : fit;
    stage_bytes = (size_t)rows * rs;
  }
  __host__ __device__ size_t smem() const {
    return w_bytes + 2 * stage_bytes + (size_t)rows * xrs;
  }
};

// Rows 0..n-1 of the CTA's 32 xw columns (gate g, units j0..j0+7 of each of
// the rows of 4H elements at src) into the xw buffer, in CB-byte copies, or
// by plain loads (CB = 0: bf16 at an odd H, 2-byte aligned only); units past
// H are zero-filled.
template <int CB, typename WT>
__device__ __forceinline__ void stage_xw_rows(unsigned char* xs, const WT* __restrict__ src,
                                              int n, int H, int j0) {
  constexpr int E = CB ? CB / (int)sizeof(WT) : 1;   // elements per copy
  constexpr int PER_ROW = 4 * U / E;
  const size_t G = 4 * (size_t)H;
  for (int idx = threadIdx.x; idx < n * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW, s = idx % PER_ROW;
    const int g = s / (U / E), e = (s % (U / E)) * E;
    const bool valid = j0 + e < H;
    const WT* p = src + r * G + (size_t)g * H + j0 + e;
    unsigned char* dst = xs + r * Layout<WT>::xrs + (g * U + e) * (int)sizeof(WT);
    if constexpr (CB == 0)
      *reinterpret_cast<WT*>(dst) = valid ? *p : from_f<WT>(0.f);
    else
      cp_async<CB>(dst, valid ? p : src, valid);
  }
}

// Two adjacent units' values at p (2-element aligned).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename WT, bool SAVE>
__global__ void __launch_bounds__(NT, 2)
lstm_fwd_kernel(const WT* __restrict__ xw, const WT* __restrict__ w_hh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const int* __restrict__ lengths,
                std::conditional_t<SAVE, WT, float>* __restrict__ ys,
                WT* __restrict__ cs, WT* __restrict__ gates_out,
                float* __restrict__ h_last, float* __restrict__ c_last,
                WT* hbuf, unsigned int* barrier,
                int T, int D, int B, int H, unsigned int suffix_mask, int xw_copy) {
  using YT = std::conditional_t<SAVE, WT, float>;
  constexpr bool kTensorCores = std::is_same<WT, __nv_bfloat16>::value;
  constexpr int RS = Layout<WT>::rs;
  constexpr int XRS = Layout<WT>::xrs;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<WT> L(B, H);
  const int Hp = L.Hp;
  const int tiles = Hp / U;
  const int d = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * U;
  const size_t G = 4 * (size_t)H;
  const size_t DBHp = (size_t)D * B * Hp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  WT* Ws = reinterpret_cast<WT*>(smem);                      // (4U, ws)
  unsigned char* ring = smem + L.w_bytes;                     // 2 x (rows, RS)
  unsigned char* xs = ring + 2 * L.stage_bytes;               // (rows, XRS)

  // this CTA's 32 gate columns of W_hh, one row per column, zero past H;
  // neighbouring threads read neighbouring units
  const WT* wd = w_hh + (size_t)d * H * G;
  for (int idx = tid; idx < 4 * U * L.ws; idx += NT) {
    const int c = idx % (4 * U), k = idx / (4 * U);
    const int j = j0 + (c % U);
    Ws[c * L.ws + k] = (j < H && k < H) ? wd[(size_t)k * G + (size_t)(c / U) * H + j]
                                        : from_f<WT>(0.f);
  }
  // h0 rounded to the weight type into hbuf's first slot (zero in the pad)
  for (int idx = tid; idx < B * U; idx += NT) {
    const int b = idx / U, j = j0 + idx % U;
    hbuf[((size_t)d * B + b) * Hp + j] =
        from_f<WT>(j < H ? h0[((size_t)d * B + b) * H + j] : 0.f);
  }

  // xw of (step t, the group from row g0), into the xw buffer
  auto stage_xw = [&](int t, int g0) {
    const int n = min(L.rows, B - g0);
    const WT* src = xw + (((size_t)t * D + d) * B + g0) * G;
    switch (xw_copy) {
      case 16: stage_xw_rows<16>(xs, src, n, H, j0); break;
      case 8: stage_xw_rows<8>(xs, src, n, H, j0); break;
      case 4: stage_xw_rows<4>(xs, src, n, H, j0); break;
      default: stage_xw_rows<0>(xs, src, n, H, j0); break;
    }
    cp_async_commit();
  };
  stage_xw(0, 0);

  const bool suffix = (suffix_mask >> d) & 1u;
  const unsigned int nblocks = gridDim.x;
  // every CTA's share of round(h0) must be visible before any CTA stages it
  grid_barrier(barrier, nblocks);

  // bf16: warp w owns m-tile w of a group; the lane's ldmatrix row addresses
  // in W (gates 0 and 1; gates 2 and 3 are 16 rows on) and in a stage
  const unsigned w_addr =
      smem_u32(Ws) + (((lane >> 4) * U + (lane & 7)) * L.ws + ((lane >> 3) & 1) * 8) * 2;
  const unsigned w_gates23 = 2 * U * L.ws * 2;
  const unsigned a_off = (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 16;

  for (int t = 0; t < T; ++t) {
    const WT* hsrc = hbuf + (size_t)(t & 1) * DBHp + (size_t)d * B * Hp;
    WT* hdst = hbuf + (size_t)((t + 1) & 1) * DBHp + (size_t)d * B * Hp;
    for (int g0 = 0; g0 < B; g0 += L.rows) {
      const int n = min(L.rows, B - g0);
      const WT* hrow = hsrc + (size_t)g0 * Hp;
      auto stage_chunk = [&](int c) {
        stage_rows<16, NT, typename Layout<WT>::R>(ring + (c & 1) * L.stage_bytes, hrow, n,
                                                   Hp, c * L.kc);
        cp_async_commit();
      };
      // A stage's rows past n (up to the m-tile edge) are not copied: a
      // product row depends on its own h row alone, and those rows'
      // products are dropped.
      stage_chunk(0);
      float acc[4][4] = {};     // bf16: (gate, fragment); f32: (row, gate)
      // f32: thread = (slice sl of the k, unit jl, quad q of 4 rows), with
      // as many slices as keep all threads busy: 1 at 128 rows, 8 at 16
      const int quads = (n + 3) / 4;
      int S = 1;
      while (S < MAX_SLICES && quads * U * S * 2 <= NT) S *= 2;
      const int sl = tid % S, jl = (tid / S) % U, q = tid / (S * U);
      for (int c = 0; c < L.nchunks; ++c) {
        cp_async_wait_all();
        __syncthreads();   // chunk c (and the group's xw) landed; chunk c-1's stage is free
        if (c + 1 < L.nchunks) stage_chunk(c + 1);
        const unsigned char* st = ring + (c & 1) * L.stage_bytes;
        const int k0 = c * L.kc;
        const int kn = min(L.kc, L.kpad - k0);
        if constexpr (kTensorCores) {
          if (warp * 16 < n) {
            // the chunk's sum starts from zero and is added to the total in
            // f32: shorter chains of tensor-core sums, closer to the exact sum
            const unsigned a_addr = smem_u32(st) + a_off;
            float part[4][4] = {};
            for (int ks = 0; ks < kn; ks += 16) {
              unsigned af[4], b01[4], b23[4];
              ldmatrix_x4(af, a_addr + ks * 2);
              ldmatrix_x4(b01, w_addr + (k0 + ks) * 2);
              ldmatrix_x4(b23, w_addr + w_gates23 + (k0 + ks) * 2);
              mma_bf16(part[0], af, b01);
              mma_bf16(part[1], af, b01 + 2);
              mma_bf16(part[2], af, b23);
              mma_bf16(part[3], af, b23 + 2);
            }
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[g][i] += part[g][i];
          }
        } else if (q < quads) {
          // blocks of 4 k, slice sl taking every S-th: per block 4 float4 of
          // W and one float4 of h per row feed 16 FMAs per row
          const float* wrow = reinterpret_cast<const float*>(Ws) + jl * L.ws + k0;
          for (int k = 4 * sl; k < kn; k += 4 * S) {
            float4 w[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              w[g] = *reinterpret_cast<const float4*>(wrow + g * U * L.ws + k);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = 4 * q + i;
              if (r >= n) break;
              const float4 v = *reinterpret_cast<const float4*>(st + r * RS + k * 4);
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                float a = acc[i][g];
                a = fmaf(w[g].x, v.x, a);
                a = fmaf(w[g].y, v.y, a);
                a = fmaf(w[g].z, v.z, a);
                a = fmaf(w[g].w, v.w, a);
                acc[i][g] = a;
              }
            }
          }
        }
      }

      // The owners' cell update of NU (a compile-time count) adjacent units
      // u.. of group row r, pre[q][g] the product of gate g of unit u + q.
      auto update = [&](int r, int u, const float (*pre)[4], auto nu_count) {
        constexpr int NU = decltype(nu_count)::value;
        const int b = g0 + r;
        const size_t row = (size_t)d * B + b;
        const size_t so = ((size_t)t * D + d) * B + b;
        const bool valid = step_valid(suffix, lengths[b], t, T);
        const WT* xr = reinterpret_cast<const WT*>(xs + r * XRS);
        float h_out[NU] = {}, y[NU], c_out[NU], act[NU][4];
#pragma unroll
        for (int q = 0; q < NU; ++q) {
          const int j = j0 + u + q;
          if (j >= H) break;                  // a pad column: h stays zero
          const size_t o = row * H + j;
          const float h_prev = t ? h_last[o] : h0[o];
          const float c_prev = t ? c_last[o] : c0[o];
          const float ia = sigmoidf(to_f(xr[u + q]) + pre[q][0]);
          const float fa = sigmoidf(to_f(xr[U + u + q]) + pre[q][1]);
          const float ga = tanhf(to_f(xr[2 * U + u + q]) + pre[q][2]);
          const float oa = sigmoidf(to_f(xr[3 * U + u + q]) + pre[q][3]);
          const float c_new = fa * c_prev + ia * ga;
          const float h_new = oa * tanhf(c_new);
          h_out[q] = valid ? h_new : h_prev;
          c_out[q] = valid ? c_new : c_prev;
          y[q] = valid ? h_new : 0.f;
          act[q][0] = ia; act[q][1] = fa; act[q][2] = ga; act[q][3] = oa;
          h_last[o] = h_out[q];
          c_last[o] = c_out[q];
        }
        const int j = j0 + u;
        WT* hp = hdst + (size_t)b * Hp + j;
        if constexpr (NU == 2) store2(hp, h_out[0], h_out[1]);   // Hp, j even: aligned
        else hp[0] = from_f<WT>(h_out[0]);
        if (j >= H) return;
        if constexpr (NU == 2) {
          if (!(H & 1)) {                               // j + 1 < H, pairs aligned
            store2(ys + so * H + j, y[0], y[1]);
            if constexpr (SAVE) {
              store2(cs + so * H + j, c_out[0], c_out[1]);
#pragma unroll
              for (int g = 0; g < 4; ++g)
                store2(gates_out + so * G + (size_t)g * H + j, act[0][g], act[1][g]);
            }
            return;
          }
        }
#pragma unroll
        for (int q = 0; q < NU; ++q) {
          if (j + q >= H) break;
          ys[so * H + j + q] = from_f<YT>(y[q]);
          if constexpr (SAVE) {
            cs[so * H + j + q] = from_f<WT>(c_out[q]);
#pragma unroll
            for (int g = 0; g < 4; ++g)
              gates_out[so * G + (size_t)g * H + j + q] = from_f<WT>(act[q][g]);
          }
        }
      };

      if constexpr (!kTensorCores) {
        // the slices' partial sums, added across lanes in a fixed order
        for (int m = 1; m < S; m <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[i][g] += __shfl_xor_sync(0xffffffffu, acc[i][g], m);
      }
      if constexpr (kTensorCores) {
        // the thread's fragments: rows lane/4 and lane/4 + 8 of the m-tile,
        // units 2 (lane % 4) and the next, of each gate
        if (warp * 16 < n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + (lane >> 2) + 8 * half;
            if (r >= n) break;
            float pre[2][4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              pre[0][g] = acc[g][2 * half];
              pre[1][g] = acc[g][2 * half + 1];
            }
            update(r, 2 * (lane & 3), pre, std::integral_constant<int, 2>());
          }
        }
      } else if (q < quads) {
        // row i of the quad goes to slice i % S
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * q + i;
          if (r < n && i % S == sl) update(r, jl, &acc[i], std::integral_constant<int, 1>());
        }
      }
      // the ring and the xw buffer are free; fetch the xw of the next group
      // of this step, or of the first group of the next step (in flight
      // through the grid barrier)
      __syncthreads();
      if (g0 + L.rows < B) stage_xw(t, g0 + L.rows);
      else if (t + 1 < T) stage_xw(t + 1, 0);
    }
    // every CTA's h_t must be visible before any CTA stages it for step t+1
    if (t + 1 < T) grid_barrier(barrier, (unsigned int)(t + 2) * nblocks);
  }
}

// The widest copy that keeps every xw row's gate columns of a CTA aligned:
// 16, 8 or 4 bytes, or 0 (plain loads: bf16 at an odd H).
int xw_copy_bytes(const void* xw, int H, int elem) {
  for (int cb = 16; cb >= 4; cb /= 2) {
    const int e = cb / elem;
    if (e >= 1 && H % e == 0 && reinterpret_cast<uintptr_t>(xw) % cb == 0) return cb;
  }
  return 0;
}

// The launch of one shape: its CTAs, how many can be resident on one SM (the
// fewer of the two instances'), the SMs, the shared memory of one CTA and the
// rows of one group; a cudaError_t.
template <typename WT>
int plan(int D, int B, int H, int* ctas, int* per_sm, int* sms, int* smem, int* rows) {
  const Layout<WT> L(B, H);
  *ctas = D * (L.Hp / U);
  *smem = (int)L.smem();
  *rows = L.rows;
  int train = 0, infer = 0;
  int err = occupancy(lstm_fwd_kernel<WT, true>, NT, L.smem(), &train, sms);
  if (err == 0) err = occupancy(lstm_fwd_kernel<WT, false>, NT, L.smem(), &infer, sms);
  *per_sm = train < infer ? train : infer;
  return err;
}

template <typename WT, bool SAVE>
int launch(const void* xw, const void* w_hh, const float* h0, const float* c0,
           const int* lengths, void* ys, void* cs, void* gates, float* h_last,
           float* c_last, void* hbuf, unsigned int* barrier, int T, int D, int B, int H,
           unsigned int suffix_mask, cudaStream_t stream) {
  using YT = std::conditional_t<SAVE, WT, float>;
  const Layout<WT> L(B, H);
  const size_t smem = L.smem();
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_fwd_kernel<WT, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const WT* xw_t = static_cast<const WT*>(xw);
  const WT* w_t = static_cast<const WT*>(w_hh);
  YT* ys_t = static_cast<YT*>(ys);
  WT* cs_t = static_cast<WT*>(cs);
  WT* gates_t = static_cast<WT*>(gates);
  WT* hbuf_t = static_cast<WT*>(hbuf);
  int xw_copy = xw_copy_bytes(xw, H, (int)sizeof(WT));
  void* args[] = {(void*)&xw_t, (void*)&w_t, (void*)&h0, (void*)&c0, (void*)&lengths,
                  (void*)&ys_t, (void*)&cs_t, (void*)&gates_t, (void*)&h_last,
                  (void*)&c_last, (void*)&hbuf_t, (void*)&barrier,
                  (void*)&T, (void*)&D, (void*)&B, (void*)&H, (void*)&suffix_mask,
                  (void*)&xw_copy};
  const dim3 grid(D * (L.Hp / U));
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(NT), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 on success. xw and w_hh are bf16 when
// bf16 != 0, f32 otherwise; ys is f32; hbuf is (2, D, B, Hp) scratch in the
// weight type, Hp = H rounded up to a multiple of 8; barrier one zeroed
// uint32.
int sep_lstm_infer(const void* xw, const void* w_hh, int bf16, const float* h0,
                   const float* c0, const int* lengths, float* ys, float* h_last,
                   float* c_last, void* hbuf, unsigned int* barrier, int T, int D, int B,
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
                 float* h_last, float* c_last, void* hbuf, unsigned int* barrier, int T,
                 int D, int B, int H, unsigned int suffix_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, true>(xw, w_hh, h0, c0, lengths, ys, cs, gates, h_last,
                                       c_last, hbuf, barrier, T, D, B, H, suffix_mask, s);
  return launch<float, true>(xw, w_hh, h0, c0, lengths, ys, cs, gates, h_last, c_last,
                             hbuf, barrier, T, D, B, H, suffix_mask, s);
}

// The launch a shape gets on the current device, for both instances: its
// CTAs, how many can be resident per SM (0 when one CTA's shared memory
// exceeds an SM's), the SMs, the shared memory of one CTA and the batch rows
// of one group of its ring. Returns a cudaError_t code.
int sep_lstm_fwd_plan(int bf16, int D, int B, int H, int* ctas, int* per_sm, int* sms,
                      int* smem, int* rows) {
  if (bf16) return plan<__nv_bfloat16>(D, B, H, ctas, per_sm, sms, smem, rows);
  return plan<float>(D, B, H, ctas, per_sm, sms, smem, rows);
}

const char* sep_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
