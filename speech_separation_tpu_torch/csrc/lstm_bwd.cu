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
// The design. The dh of one hidden unit needs the dgates of all 4H columns of
// its direction, so what the CTAs exchange per step is dgates (B x 4H), and
// it goes through dxw[t] in L2. The grid is D * ceil(H/8) CTAs (150 at H=600),
// each owning U = 8 units of one direction, at two CTAs per SM (each within
// 113 KB of shared memory whatever B), so all 132 SMs work. The launch stays
// cooperative with one grid barrier per step; the wrapper checks co-residency
// (sep_lstm_bwd_plan) and raises, naming the cap, for a grid that cannot be
// resident: on an H100, H above 1056 (more than 264 CTAs), or in f32 above
// 864 (W no longer fits beside the smallest ring at two CTAs per SM). A CTA
// keeps in shared memory
//   - rows j0..j0+7 of W_hh (all 4H columns, k contiguous; a row is an odd
//     number of 16-byte units, so ldmatrix and float4 reads of 8 rows hit
//     distinct banks): 38.5 KB in bf16, 76.9 KB in f32 at H=600;
//   - a 2-stage ring of dxw[t] chunks, each one group of batch rows by 128
//     bf16 or 32 f32 columns, every row padded by 16 bytes (conflict-free
//     for ldmatrix and float4). A group is the most rows (whole m-tiles, at
//     most 128) whose ring fits beside W: at B=100, H=600 the whole batch,
//     so each step streams 19 chunks (bf16) or 75 (f32).
// dh and dc of its units (f32) live in dh0 and dc0, each entry read and
// written by this CTA alone, so the shared memory does not grow with B.
// Per step a CTA
//   A. computes the 32 dgate columns of its units (arithmetic as _bwd_kernel)
//      and writes them to dxw[t];
//   -- grid barrier --
//   B. for each group of rows, streams dxw[t] through the ring with cp.async
//      (16-byte copies; 8-byte in bf16 at an odd H, where a row of dxw is
//      only 8-byte aligned), the next chunk in flight while one is consumed,
//      and forms dh of its units.
//      bf16: mma.sync m16n8k16 (bf16 x bf16, f32 sums) on the tensor cores,
//      A = 16 dgate rows of the stage, B = the 8 resident W_hh rows, both by
//      ldmatrix. Warp w takes the k-steps w % 4, w % 4 + 4, ... of each chunk
//      and the m-tiles of parity w / 4 (B=100: 7 m-tiles, 1 n-tile, 150
//      k-steps); after the group's last chunk the four k-classes' partial
//      sums meet in the free ring and are added in a fixed order, so the
//      result is bit-identical from run to run with no atomics. f32: FMAs on
//      the CUDA cores, one thread per (row, unit) summing over k in order;
//      the tensor cores have no f32 form that keeps the operands exact (TF32
//      rounds them), and the f32 path is shared-load bound, not L2 bound.
// What bounds it (bf16, H100): per step the stream of dxw[t] through the
// ring, every CTA reading its direction's whole dxw[t] from L2 (480 KB at
// B=100, H=600; 72 MB per step over the grid) with one __syncthreads per
// chunk, then phase A and the grid barrier. On the card, 2 stages of
// 128-column bf16 chunks (256 contiguous bytes per row) ran faster than
// deeper rings of narrower chunks, and faster than each warp staging only
// its own k-steps without the CTA-wide sync. The products are off the
// critical path.

#include <type_traits>

#include "lstm_common.cuh"

namespace {

using namespace seplstm;

constexpr int U = 8;                 // hidden units per CTA
constexpr int NT = 256;              // threads per CTA (8 warps)
constexpr int RPT = NT / U;          // rows apart of one thread's (row, unit) entries
constexpr int MAX_GROUP = 128;       // rows per group: 4 m-tiles per warp (bf16), 4 rows per thread (f32)
constexpr int SMEM_PER_CTA = 115712; // two CTAs per SM: (228 KB per SM) / 2 - 1 KB reserved
constexpr int SMEM_MAX = 232448;     // 227 KB, the most one CTA may take

template <typename WT> struct Layout {
  int G, kpad, ws, rows, nchunks;    // rows: batch rows of one group (one ring stage)
  size_t w_bytes, stage_bytes;
  // one row of a ring stage: 128 bf16 or 32 f32 columns, padded by 16 bytes
  static constexpr int row_bytes = std::is_same<WT, float>::value ? 128 : 256;
  static constexpr int rs = row_bytes + 16;
  static constexpr int kc = row_bytes / (int)sizeof(WT);   // columns per chunk
  __host__ __device__ Layout(int B, int H) {
    G = 4 * H;
    kpad = (G + 15) / 16 * 16;                 // k padded to whole mma k-steps
    ws = kpad + 16 / (int)sizeof(WT);          // odd count of 16-byte units per row
    nchunks = (kpad + kc - 1) / kc;
    w_bytes = (size_t)U * ws * sizeof(WT);
    // the most rows, in whole m-tiles, whose 2-stage ring fits beside W at
    // two CTAs per SM; at least one m-tile (the plan then finds one CTA per SM)
    const long long left = (long long)SMEM_PER_CTA - (long long)w_bytes;
    int fit = left > 0 ? (int)(left / (2 * rs)) / 16 * 16 : 0;
    fit = fit < 16 ? 16 : (fit > MAX_GROUP ? MAX_GROUP : fit);
    const int need = std::is_same<WT, float>::value ? B : (B + 15) / 16 * 16;
    rows = need < fit ? need : fit;
    stage_bytes = (size_t)rows * rs;
  }
  __host__ __device__ size_t smem() const { return w_bytes + 2 * stage_bytes; }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// CB-byte copy, zero-filled when !valid
template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows 0..n-1 of one chunk (columns col0.. of rows of G columns at src) into
// a ring stage, in CB-byte copies; columns past G are zero-filled.
template <int CB, typename WT>
__device__ __forceinline__ void stage_rows(unsigned char* st, const WT* src, int n, int G,
                                           int col0) {
  constexpr int SEG = Layout<WT>::row_bytes / CB;      // copies per stage row
  constexpr int EPC = CB / (int)sizeof(WT);            // elements per copy
  for (int idx = threadIdx.x; idx < n * SEG; idx += NT) {
    const int r = idx / SEG, s = idx % SEG;
    const int col = col0 + s * EPC;
    const bool valid = col < G;
    cp_async<CB>(st + r * Layout<WT>::rs + s * CB, valid ? src + (size_t)r * G + col : src,
                 valid);
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
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename WT>
__global__ void __launch_bounds__(NT, 2)
lstm_bwd_kernel(const WT* __restrict__ w_hh, const float* __restrict__ c0,
                const int* __restrict__ lengths, const WT* __restrict__ cs,
                const WT* __restrict__ gates, const WT* __restrict__ dys,
                const float* __restrict__ dh_last, const float* __restrict__ dc_last,
                WT* dxw, float* dh0, float* dc0, unsigned int* barrier,
                int T, int D, int B, int H, unsigned int suffix_mask) {
  constexpr bool kTensorCores = std::is_same<WT, __nv_bfloat16>::value;
  constexpr int RS = Layout<WT>::rs;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<WT> L(B, H);
  const int tiles = (H + U - 1) / U;
  const int d = blockIdx.x / tiles;
  const int j0 = (blockIdx.x % tiles) * U;
  const int G = L.G;
  const int tid = threadIdx.x;
  // a bf16 row of dxw at an odd H is only 8-byte aligned
  const bool narrow = kTensorCores && (H & 1);

  WT* Ws = reinterpret_cast<WT*>(smem);                                     // (U, ws)
  unsigned char* ring = smem + L.w_bytes;                                   // 2 x (rows, RS)

  // rows j0..j0+7 of this direction's W_hh, zero past H and past 4H
  const WT* wd = w_hh + (size_t)d * H * G;
  for (int idx = tid; idx < U * L.ws; idx += NT) {
    const int jl = idx / L.ws, k = idx - jl * L.ws;
    const int j = j0 + jl;
    Ws[idx] = (j < H && k < G) ? wd[(size_t)j * G + k] : from_f<WT>(0.f);
  }
  // Thread -> entries (row r0 + RPT i, unit jl) of dh and dc, in phase A, in
  // the f32 product and in adding the product: each entry has one owner.
  const int r0 = tid / U, jl = tid % U, a_j = j0 + jl;
  for (int b = r0; b < B && a_j < H; b += RPT) {
    const size_t o = ((size_t)d * B + b) * H + a_j;
    dh0[o] = dh_last[o];
    dc0[o] = dc_last[o];
  }

  const bool suffix = (suffix_mask >> d) & 1u;
  const unsigned int nblocks = gridDim.x;
  // phase B, bf16: warp w takes the k-steps kq = w % 4, kq + 4, ... of every
  // chunk and the m-tiles of parity w / 4; the lane's ldmatrix row addresses
  // in W and in a stage
  const int warp = tid >> 5, lane = tid & 31;
  const int kq = warp & 3, mpar = warp >> 2;
  const unsigned w_addr = smem_u32(Ws) + ((lane & 7) * L.ws + ((lane >> 3) & 1) * 8) * 2;
  const unsigned a_off = (mpar * 16 + (lane & 15)) * RS + (lane >> 4) * 16;

  for (int t = T - 1; t >= 0; --t) {
    // ---- A: this CTA's dgate columns at step t
    for (int b = r0; b < B && a_j < H; b += RPT) {
      const size_t o = ((size_t)d * B + b) * H + a_j;
      const size_t so = ((size_t)t * D + d) * B + b;
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
        const float dh_new = dh0[o] + to_f(dys[so * H + a_j]);
        const float tanh_c = tanhf(c_t);
        const float dc_new = dc0[o] + dh_new * oa * (1.f - tanh_c * tanh_c);
        dp[0] = from_f<WT>(dc_new * ga * ia * (1.f - ia));
        dp[(size_t)H] = from_f<WT>(dc_new * c_prev * fa * (1.f - fa));
        dp[2 * (size_t)H] = from_f<WT>(dc_new * ia * (1.f - ga * ga));
        dp[3 * (size_t)H] = from_f<WT>(dh_new * tanh_c * oa * (1.f - oa));
        dc0[o] = dc_new * fa;
        dh0[o] = 0.f;   // phase B adds the product
      } else {
        const WT z = from_f<WT>(0.f);
        dp[0] = z; dp[(size_t)H] = z; dp[2 * (size_t)H] = z; dp[3 * (size_t)H] = z;
      }
    }
    // every CTA's dgates at step t must be visible before any CTA reads them
    grid_barrier(barrier, (unsigned int)(T - t) * nblocks);

    // ---- B: dh of this CTA's units += dxw[t] @ W_hh[j0:j0+8]^T, one group
    // of rows at a time
    for (int g0 = 0; g0 < B; g0 += L.rows) {
      const int n = min(L.rows, B - g0);
      const WT* drow = dxw + (((size_t)t * D + d) * B + g0) * G;
      auto stage_chunk = [&](int c) {
        unsigned char* st = ring + (c & 1) * L.stage_bytes;
        if (narrow)
          stage_rows<8>(st, drow, n, G, c * L.kc);
        else
          stage_rows<16>(st, drow, n, G, c * L.kc);
        cp_async_commit();
      };
      // A stage's rows past n (up to the m-tile edge) are not copied: a
      // product row depends on its own dgate row alone, and those rows'
      // products are dropped.
      stage_chunk(0);
      // the dh entries the product is added to, read while the chunks stream
      float keep[MAX_GROUP / RPT];
#pragma unroll
      for (int i = 0; i < MAX_GROUP / RPT; ++i) {
        const int b = g0 + r0 + i * RPT;
        keep[i] = (b < g0 + n && a_j < H) ? dh0[((size_t)d * B + b) * H + a_j] : 0.f;
      }
      float acc[MAX_GROUP / 32][4] = {};                              // bf16: (m-tile, frag)
      float facc[MAX_GROUP / RPT] = {};                               // f32: one per row
      for (int c = 0; c < L.nchunks; ++c) {
        cp_async_wait_all();
        __syncthreads();   // chunk c landed for every thread; chunk c-1's stage is free
        if (c + 1 < L.nchunks) stage_chunk(c + 1);
        const unsigned char* st = ring + (c & 1) * L.stage_bytes;
        const int k0 = c * L.kc;
        const int kn = min(L.kc, L.kpad - k0);
        if constexpr (kTensorCores) {
          for (int ks = kq * 16; ks < kn; ks += 64) {
            unsigned bf[2];
            ldmatrix_x2(bf, w_addr + (k0 + ks) * 2);
            const unsigned a_addr = smem_u32(st) + a_off + ks * 2;
#pragma unroll
            for (int i = 0; i < MAX_GROUP / 32; ++i) {
              if ((mpar + 2 * i) * 16 >= n) break;
              unsigned af[4];
              ldmatrix_x4(af, a_addr + i * 32 * RS);
              mma_bf16(acc[i], af, bf);
            }
          }
        } else {
          const float* wrow = Ws + jl * L.ws + k0;
          for (int k = 0; k < kn; k += 4) {
            const float4 w = *reinterpret_cast<const float4*>(wrow + k);
#pragma unroll
            for (int i = 0; i < MAX_GROUP / RPT; ++i) {
              const int r = r0 + i * RPT;
              if (r >= n) break;
              const float4 v = *reinterpret_cast<const float4*>(st + r * RS + k * 4);
              float a = facc[i];
              a = fmaf(w.x, v.x, a);
              a = fmaf(w.y, v.y, a);
              a = fmaf(w.z, v.z, a);
              a = fmaf(w.w, v.w, a);
              facc[i] = a;
            }
          }
        }
      }

      // add the product to dh
      if constexpr (kTensorCores) {
        // the four k-step classes' partial sums, through the free ring, summed
        // in a fixed order: no atomics
        __syncthreads();
        float* part = reinterpret_cast<float*>(ring);             // (4, rows, U)
#pragma unroll
        for (int i = 0; i < MAX_GROUP / 32; ++i) {
          const int m0 = (mpar + 2 * i) * 16;
          if (m0 >= n) break;
          const int r = m0 + (lane >> 2), col = 2 * (lane & 3);
          float* p = part + ((size_t)kq * L.rows + r) * U + col;
          p[0] = acc[i][0];
          p[1] = acc[i][1];
          p[8 * U] = acc[i][2];
          p[8 * U + 1] = acc[i][3];
        }
        __syncthreads();
        const size_t cls = (size_t)L.rows * U;
#pragma unroll
        for (int i = 0; i < MAX_GROUP / RPT; ++i) {
          const int r = r0 + i * RPT;
          if (r >= n) break;
          facc[i] =((part[r * U + jl] + part[cls + r * U + jl]) + part[2 * cls + r * U + jl]) +
                    part[3 * cls + r * U + jl];
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_GROUP / RPT; ++i) {
        const int r = r0 + i * RPT;
        if (r < n && a_j < H) dh0[((size_t)d * B + g0 + r) * H + a_j] = keep[i] + facc[i];
      }
      // dh of this group is complete for step t-1's phase A; the ring is
      // free for the next group
      __syncthreads();
    }
  }
}

// The launch of one shape: its CTAs, how many can be resident on one SM, the
// SMs, the shared memory of one CTA and the rows of one group; a cudaError_t.
template <typename WT>
int plan(int D, int B, int H, int* ctas, int* per_sm, int* sms, int* smem, int* rows) {
  const Layout<WT> L(B, H);
  *ctas = D * ((H + U - 1) / U);
  *smem = (int)L.smem();
  *rows = L.rows;
  *per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess || L.smem() > SMEM_MAX) return (int)err;
  auto kernel = lstm_bwd_kernel<WT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT, L.smem());
  return (int)err;
}

template <typename WT>
int launch(const void* w_hh, const float* c0, const int* lengths, const void* cs,
           const void* gates, const void* dys, const float* dh_last, const float* dc_last,
           void* dxw, float* dh0, float* dc0, unsigned int* barrier, int T, int D, int B,
           int H, unsigned int suffix_mask, cudaStream_t stream) {
  const size_t smem = Layout<WT>(B, H).smem();
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
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
  const dim3 grid(D * ((H + U - 1) / U));
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(NT), args, smem, stream);
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

// The launch a shape gets on the current device: its CTAs, how many can be
// resident per SM (0 when one CTA's shared memory exceeds an SM's), the SMs,
// the shared memory of one CTA and the batch rows of one group of its ring.
// Returns a cudaError_t code.
int sep_lstm_bwd_plan(int bf16, int D, int B, int H, int* ctas, int* per_sm, int* sms,
                      int* smem, int* rows) {
  if (bf16) return plan<__nv_bfloat16>(D, B, H, ctas, per_sm, sms, smem, rows);
  return plan<float>(D, B, H, ctas, per_sm, sms, smem, rows);
}

const char* sep_lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
