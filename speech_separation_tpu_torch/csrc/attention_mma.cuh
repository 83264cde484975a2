// The bf16 instances of K5 (csrc/attention.cu) on the tensor cores.
//
// Same contract as the header of attention.cu. Every product is a bf16 x bf16
// mma.sync.m16n8k16 with f32 sums: QK^T, dw = dO V^T, AV with the weights
// rounded to bf16 as the reference rounds them, dv = round(w32)^T dO, and
// dq = ds K, dk = ds^T Q with the f32 ds split into hi = bf16(ds) and
// lo = bf16(ds - hi), two mma into one f32 sum (the residual is about 2^-16
// of ds, under the bf16 output's rounding). So each product is exact and only
// the order of the f32 sums differs from the reference.
//
// One warp owns a 16-row m-tile (16 queries, or 16 keys in the backward's
// key phase). Fragments come from shared memory through ldmatrix (.trans
// where the operand is stored k-major: V in AV, K in ds K, Q and dO in the
// key phase). A row of a staged (T, dh) array takes RS = DHP + 8 bf16 (DHP =
// dh padded to 16 with zeros, which leaves every dot product unchanged), so
// the 8 rows of one ldmatrix start in distinct bank groups. Staging is 16- or
// 8-byte cp.async when every tensor is 16-byte aligned, else plain loads.
// Keys and queries past T are zero rows with a mask term of -inf: out of
// every max and sum, and never stored.
//
// Three paths, chosen by attention_plan (ops/attention_kernel.py mirrors
// plan_mma below) from T and dh:
// - registers, T <= REG_CAP: a CTA of 4 warps holds R whole rows in shared
//   memory; a warp keeps its m-tile's whole logit row in its C fragments
//   (T/2 f32 a thread, up to MAXKB 16-key blocks), so each (query, key) takes
//   one exp: row max and sum by quad shuffles in a fixed order, w32 = e / sum
//   rounded as __fdiv_rn rounds it (div_rcp), round_bf16(w32) packed from the
//   C layout straight into AV's A fragments. The backward's query phase keeps
//   w32 there and recomputes dw per block (two mma are cheaper than 64 more
//   registers): one sweep for D = sum_k dw w32, one for ds and dq; then,
//   after a CTA barrier, the key phase (one warp per 16 keys) recomputes the
//   transposed logits from the per-query max, sum, 1/sum and D kept in shared
//   memory and sums dk and dv over the query blocks.
// - stored, a backward whose weights also fit shared memory at two CTAs a SM
//   (T <= 112 at dh <= 16, 96 above): one row a CTA of 8 warps; the query
//   phase also stores round(w32), bf16(ds) and its residual, and the key
//   phase reads them transposed by ldmatrix instead of recomputing them.
// - passes, T > REG_CAP: the reference's max-exp-divide over key tiles of KT
//   keys streamed through a 2-stage cp.async ring: max, then sum, then the
//   weights and AV (the backward's query phase: max, sum, D, then dq),
//   recomputing QK^T on the tensor cores in each pass. Not an online softmax:
//   the weights are divided by the final sum before they are rounded to bf16,
//   as the reference does. The forward's CTA takes 128 queries of one row;
//   the backward's CTA one whole row (the key phase reads every query's max,
//   sum, 1/sum and D from its shared memory, hence MAX_T_BWD).
// Sums have one owner and a fixed order, there are no atomics, and a second
// launch gives bit-identical outputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace sepattn {

constexpr int REG_CAP = 256;        // T up to which a warp keeps whole logit rows in registers
constexpr int MAX_T_BWD = 8192;     // the backward's per-query statistics in shared memory
constexpr int WARPS_REG = 4;        // warps of a registers-path CTA
constexpr int WARPS_PASS = 8;       // warps of a passes-path CTA
constexpr int WARPS_STORE = 8;      // warps of a backward CTA that stores the weights
constexpr int STORE_BUDGET = 115712;  // shared bytes of such a CTA: two a SM
constexpr int ROWS_MAX = 8;         // rows of a registers-path CTA, at most
constexpr int ROW_BUDGET = 57344;   // shared bytes a registers-path CTA takes for R > 1 (4 a SM)
constexpr int SMEM_MAX = 232448;    // 227 KB, the most one CTA may take

__host__ __device__ constexpr int dhp_of(int dh) { return dh < 16 ? 16 : dh; }
__host__ __device__ constexpr int rs_of(int dh) { return dhp_of(dh) + 8; }
__host__ __device__ constexpr int kt_of(int dh) { return dhp_of(dh) >= 64 ? 64 : 128; }

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(CB)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ small pieces

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo + O(2^-16 x): hi = bf16(x), lo = bf16(x - hi), two values a word
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

// s * scale + (1 - m) * (-1e9), the multiply and the add rounded apart
__device__ __forceinline__ float logit_rn(float s, float scale, float mneg) {
  return __fadd_rn(__fmul_rn(s, scale), mneg);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The A fragment of a 16x16 block whose C fragments (two n-tiles of 8
// columns) a thread holds: the FlashAttention-2 reuse of registers.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float (&c)[2][4]) {
  split_bf16(c[0][0], c[0][1], hi[0], lo[0]);
  split_bf16(c[0][2], c[0][3], hi[1], lo[1]);
  split_bf16(c[1][0], c[1][1], hi[2], lo[2]);
  split_bf16(c[1][2], c[1][3], hi[3], lo[3]);
}

// ldmatrix addresses, by lane: the A operand (or a B operand stored k-major,
// with .trans) of a 16x16 block at p, rows of RS elements ...
template <int RS>
__device__ __forceinline__ const uint16_t* a_addr(const uint16_t* p, int lane) {
  return p + (lane & 15) * RS + (lane >> 4) * 8;
}
// ... and the B operands of two n-tiles stored n-major (rows are n)
template <int RS>
__device__ __forceinline__ const uint16_t* bn_addr(const uint16_t* p, int lane) {
  return p + ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
}

// ---------------------------------------------------------------- staging

// Rows [0, n) of a (., DH) bf16 array at src into rows of RS elements at dst,
// columns DH..DHP-1 zeroed, then rows [n, nfill) zeroed. By all threads of
// the CTA; the copies land at the next cp_async_wait + __syncthreads.
template <int DH>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* src, int n, int nfill,
                                           bool vec) {
  constexpr int DHP = dhp_of(DH), RS = rs_of(DH);
  constexpr int CB = DH * 2 >= 16 ? 16 : DH * 2;     // bytes a copy
  constexpr int CPR = DH * 2 / CB;                    // copies a row
  if (vec) {
    for (int i = threadIdx.x; i < n * CPR; i += blockDim.x) {
      const int r = i / CPR, c = i % CPR;
      cp_async<CB>(reinterpret_cast<char*>(dst + r * RS) + c * CB,
                   reinterpret_cast<const char*>(src + (size_t)r * DH) + c * CB);
    }
  } else {
    for (int i = threadIdx.x; i < n * DH; i += blockDim.x) dst[(i / DH) * RS + i % DH] = src[i];
  }
  if constexpr (DH < DHP) {
    constexpr int ZW = (DHP - DH) / 4;               // 8-byte words of zero columns a row
    for (int i = threadIdx.x; i < n * ZW; i += blockDim.x)
      reinterpret_cast<uint2*>(dst + (i / ZW) * RS + DH)[i % ZW] = make_uint2(0u, 0u);
  }
  constexpr int ZR = DHP / 8;                          // 16-byte words of a zero row
  for (int i = threadIdx.x; i < (nfill - n) * ZR; i += blockDim.x)
    reinterpret_cast<uint4*>(dst + (n + i / ZR) * RS)[i % ZR] = make_uint4(0u, 0u, 0u, 0u);
}

// the keys' mask terms (1 - m) * (-1e9) of [0, n), -inf on [n, nfill)
__device__ __forceinline__ void stage_mask_terms(float* dst, const float* m, int n, int nfill) {
  for (int i = threadIdx.x; i < nfill; i += blockDim.x)
    dst[i] = i < n ? __fmul_rn(__fsub_rn(1.f, m[i]), -1e9f) : -INFINITY;
}

// Store a 16 x DH tile from C fragments (rows g and g + 8 of each 8-column
// n-tile) as bf16: rows past nrow and columns past DH are not stored.
template <int DH, int ND>
__device__ __forceinline__ void store_tile(uint16_t* out, const float (&c)[ND][4], int nrow,
                                           bool vec, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col >= DH) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      if (row >= nrow) continue;
      const uint32_t v = pack_bf16(c[nd][2 * h], c[nd][2 * h + 1]);
      uint16_t* p = out + (size_t)row * DH + col;
      if (vec) {
        *reinterpret_cast<uint32_t*>(p) = v;
      } else {
        p[0] = (uint16_t)(v & 0xffffu);
        p[1] = (uint16_t)(v >> 16);
      }
    }
  }
}

// ------------------------------------------------------- 16-key block math

// s = logits of the warp's 16 queries (A fragments qa) against 16 keys at ks
// (rows of RS), with the keys' mask terms at mn
template <int DH>
__device__ __forceinline__ void logits_block(float (&s)[2][4],
                                             const uint32_t (&qa)[dhp_of(DH) / 16][4],
                                             const uint16_t* ks, const float* mn, float scale,
                                             int lane) {
  constexpr int KS = dhp_of(DH) / 16, RS = rs_of(DH);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, bn_addr<RS>(ks + kk * 16, lane));
    mma(s[0], qa[kk], b[0], b[1]);
    mma(s[1], qa[kk], b[2], b[3]);
  }
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float2 m = *reinterpret_cast<const float2*>(mn + n * 8 + 2 * t);
    s[n][0] = logit_rn(s[n][0], scale, m.x);
    s[n][1] = logit_rn(s[n][1], scale, m.y);
    s[n][2] = logit_rn(s[n][2], scale, m.x);
    s[n][3] = logit_rn(s[n][3], scale, m.y);
  }
}

// dw = dO V^T of the warp's 16 queries (A fragments da) against 16 keys at vs
template <int DH>
__device__ __forceinline__ void dw_block(float (&dw)[2][4],
                                         const uint32_t (&da)[dhp_of(DH) / 16][4],
                                         const uint16_t* vs, int lane) {
  constexpr int KS = dhp_of(DH) / 16, RS = rs_of(DH);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, bn_addr<RS>(vs + kk * 16, lane));
    mma(dw[0], da[kk], b[0], b[1]);
    mma(dw[1], da[kk], b[2], b[3]);
  }
}

// acc (16 x DHP) += a (16 x 16, A fragments) x rows at x (16 x DHP, k-major)
template <int DH>
__device__ __forceinline__ void av_block(float (&acc)[dhp_of(DH) / 8][4], const uint32_t (&a)[4],
                                         const uint16_t* x, int lane) {
  constexpr int ND = dhp_of(DH) / 8, RS = rs_of(DH);
#pragma unroll
  for (int np = 0; np < ND / 2; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, a_addr<RS>(x + np * 16, lane));
    mma(acc[2 * np], a, b[0], b[1]);
    mma(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// acc += (hi + lo) x rows at x: the f32 ds as two bf16 products
template <int DH>
__device__ __forceinline__ void av2_block(float (&acc)[dhp_of(DH) / 8][4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], const uint16_t* x, int lane) {
  constexpr int ND = dhp_of(DH) / 8, RS = rs_of(DH);
#pragma unroll
  for (int np = 0; np < ND / 2; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, a_addr<RS>(x + np * 16, lane));
    mma(acc[2 * np], hi, b[0], b[1]);
    mma(acc[2 * np], lo, b[0], b[1]);
    mma(acc[2 * np + 1], hi, b[2], b[3]);
    mma(acc[2 * np + 1], lo, b[2], b[3]);
  }
}

template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[dhp_of(DH) / 16][4], const uint16_t* p,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < dhp_of(DH) / 16; ++kk) ldsm_x4(a[kk], a_addr<rs_of(DH)>(p + kk * 16, lane));
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// e / s rounded to nearest, as __fdiv_rn(e, s) gives it, from r = __frcp_rn(s):
// q = e r, then one correction by the exact remainder e - q s (Markstein).
// Exact while the quotient and the remainder stay normal: for s in [1, 2^13]
// (a softmax sum, at least the max's exp(0) = 1) that holds for e >= 2^-80
// and e = 0 (checked against IEEE division on 8e8 pairs). __fdiv_rn itself
// costs a range check and a branch per element, which halved the kernels'
// speed on the card.
__device__ __forceinline__ float div_rcp(float e, float s, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, s, e), r, q);
}
// e in (0, 2^-80): the quotient is left to __fdiv_rn
__device__ __forceinline__ bool tiny(float e) {
  return __float_as_uint(e) - 1u < 0x17800000u - 1u;
}

// w32 = e / sum of a block, in place (rows g: sum0 and its reciprocal r0,
// g + 8: sum1 and r1)
__device__ __forceinline__ void divide_block(float (&s)[2][4], float sum0, float r0, float sum1,
                                             float r1) {
  bool slow = false;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) slow |= tiny(s[n][i]);
  if (slow) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = __fdiv_rn(s[n][0], sum0);
      s[n][1] = __fdiv_rn(s[n][1], sum0);
      s[n][2] = __fdiv_rn(s[n][2], sum1);
      s[n][3] = __fdiv_rn(s[n][3], sum1);
    }
  } else {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = div_rcp(s[n][0], sum0, r0);
      s[n][1] = div_rcp(s[n][1], sum0, r0);
      s[n][2] = div_rcp(s[n][2], sum1, r1);
      s[n][3] = div_rcp(s[n][3], sum1, r1);
    }
  }
}

// e = exp(logit - max) of a block, in place
__device__ __forceinline__ void exp_block(float (&s)[2][4], float mx0, float mx1) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    s[n][0] = expf(__fsub_rn(s[n][0], mx0));
    s[n][1] = expf(__fsub_rn(s[n][1], mx0));
    s[n][2] = expf(__fsub_rn(s[n][2], mx1));
    s[n][3] = expf(__fsub_rn(s[n][3], mx1));
  }
}

// ds = (w32 * (dw - D)) * scale of a block, into dw
__device__ __forceinline__ void ds_block(float (&dw)[2][4], const float (&w)[2][4], float D0,
                                         float D1, float scale) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    dw[n][0] = __fmul_rn(__fmul_rn(w[n][0], __fsub_rn(dw[n][0], D0)), scale);
    dw[n][1] = __fmul_rn(__fmul_rn(w[n][1], __fsub_rn(dw[n][1], D0)), scale);
    dw[n][2] = __fmul_rn(__fmul_rn(w[n][2], __fsub_rn(dw[n][2], D1)), scale);
    dw[n][3] = __fmul_rn(__fmul_rn(w[n][3], __fsub_rn(dw[n][3], D1)), scale);
  }
}

// ------------------------------------------------------------- key phase

// One 16-query block of the backward's key phase: the warp's 16 keys (A
// fragments ka of K and va of V, mask terms mg0 and mg1 of rows g and g + 8)
// against the queries i0.. at qs and dos (rows of RS), whose max, sum and D
// and the sum's reciprocal are at smx, ssum, sD and srcp (indexed from i0).
// Adds ds^T Q to dk and round(w32)^T dO to dv; queries at or past Tn weigh
// nothing.
template <int DH>
__device__ __forceinline__ void key_block(float (&dk)[dhp_of(DH) / 8][4],
                                          float (&dv)[dhp_of(DH) / 8][4],
                                          const uint32_t (&ka)[dhp_of(DH) / 16][4],
                                          const uint32_t (&va)[dhp_of(DH) / 16][4], float mg0,
                                          float mg1, const uint16_t* qs, const uint16_t* dos,
                                          const float* smx, const float* ssum, const float* sD,
                                          const float* srcp, int i0, int Tn, float scale,
                                          int lane) {
  constexpr int KS = dhp_of(DH) / 16, RS = rs_of(DH);
  float st[2][4], dwt[2][4];
  zero(st);
  zero(dwt);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, bn_addr<RS>(qs + kk * 16, lane));
    mma(st[0], ka[kk], b[0], b[1]);
    mma(st[1], ka[kk], b[2], b[3]);
    ldsm_x4(b, bn_addr<RS>(dos + kk * 16, lane));
    mma(dwt[0], va[kk], b[0], b[1]);
    mma(dwt[1], va[kk], b[2], b[3]);
  }
  const int t = lane & 3;
  float w[2][4];
  bool slow = false;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = n * 8 + 2 * t;
    const float2 mx = *reinterpret_cast<const float2*>(smx + c);
    const bool ok0 = i0 + c < Tn, ok1 = i0 + c + 1 < Tn;
    w[n][0] = ok0 ? expf(__fsub_rn(logit_rn(st[n][0], scale, mg0), mx.x)) : 0.f;
    w[n][1] = ok1 ? expf(__fsub_rn(logit_rn(st[n][1], scale, mg0), mx.y)) : 0.f;
    w[n][2] = ok0 ? expf(__fsub_rn(logit_rn(st[n][2], scale, mg1), mx.x)) : 0.f;
    w[n][3] = ok1 ? expf(__fsub_rn(logit_rn(st[n][3], scale, mg1), mx.y)) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) slow |= tiny(w[n][i]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = n * 8 + 2 * t;
    const float2 sm = *reinterpret_cast<const float2*>(ssum + c);
    const float2 r = *reinterpret_cast<const float2*>(srcp + c);
    const float2 D = *reinterpret_cast<const float2*>(sD + c);
    if (slow) {
      w[n][0] = __fdiv_rn(w[n][0], sm.x);
      w[n][1] = __fdiv_rn(w[n][1], sm.y);
      w[n][2] = __fdiv_rn(w[n][2], sm.x);
      w[n][3] = __fdiv_rn(w[n][3], sm.y);
    } else {
      w[n][0] = div_rcp(w[n][0], sm.x, r.x);
      w[n][1] = div_rcp(w[n][1], sm.y, r.y);
      w[n][2] = div_rcp(w[n][2], sm.x, r.x);
      w[n][3] = div_rcp(w[n][3], sm.y, r.y);
    }
    dwt[n][0] = __fmul_rn(__fmul_rn(w[n][0], __fsub_rn(dwt[n][0], D.x)), scale);
    dwt[n][1] = __fmul_rn(__fmul_rn(w[n][1], __fsub_rn(dwt[n][1], D.y)), scale);
    dwt[n][2] = __fmul_rn(__fmul_rn(w[n][2], __fsub_rn(dwt[n][2], D.x)), scale);
    dwt[n][3] = __fmul_rn(__fmul_rn(w[n][3], __fsub_rn(dwt[n][3], D.y)), scale);
  }
  uint32_t wa[4], hi[4], lo[4];
  c_to_a(wa, w);
  av_block<DH>(dv, wa, dos, lane);
  c_to_a_split(hi, lo, dwt);
  av2_block<DH>(dk, hi, lo, qs, lane);
}

// ------------------------------------------------------- registers path

// Rows [n0, n0 + R) of q, k, v (and do) staged whole: R x (Tp x RS) each,
// then the keys' mask terms (R x Tp f32).
template <int DH, int MAXKB>
__global__ void __launch_bounds__(WARPS_REG * 32, MAXKB <= 8 ? 3 : 2)
attn_fwd_rows(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const float* __restrict__ mask,
              uint16_t* __restrict__ o, int N, int Tn, int R, float scale, int vec) {
  constexpr int RS = rs_of(DH), KS = dhp_of(DH) / 16, ND = dhp_of(DH) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (Tn + 15) & ~15, MT = Tp >> 4, rowe = Tp * RS;
  const int n0 = blockIdx.x * R, rows = min(R, N - n0);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ks = qs + R * rowe;
  uint16_t* vs = ks + R * rowe;
  float* mn = reinterpret_cast<float*>(vs + R * rowe);
  for (int r = 0; r < rows; ++r) {
    const size_t off = (size_t)(n0 + r) * Tn * DH;
    stage_rows<DH>(qs + r * rowe, q + off, Tn, Tp, vec);
    stage_rows<DH>(ks + r * rowe, k + off, Tn, Tp, vec);
    stage_rows<DH>(vs + r * rowe, v + off, Tn, Tp, vec);
    stage_mask_terms(mn + r * Tp, mask + (size_t)(n0 + r) * Tn, Tn, Tp);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int task = threadIdx.x >> 5; task < rows * MT; task += WARPS_REG) {
    const int r = task / MT, m0 = (task % MT) * 16;
    const uint16_t* kr = ks + r * rowe;
    const uint16_t* vr = vs + r * rowe;
    const float* mr = mn + r * Tp;
    uint32_t qa[KS][4];
    load_a<DH>(qa, qs + r * rowe + m0 * RS, lane);
    float s[MAXKB][2][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int kb = 0; kb < MAXKB; ++kb) {
      if (kb < MT) {
        logits_block<DH>(s[kb], qa, kr + kb * 16 * RS, mr + kb * 16, scale, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[kb][n][0], s[kb][n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[kb][n][2], s[kb][n][3]));
        }
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kb = 0; kb < MAXKB; ++kb) {
      if (kb < MT) {
        exp_block(s[kb], mx0, mx1);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          sum0 = __fadd_rn(__fadd_rn(sum0, s[kb][n][0]), s[kb][n][1]);
          sum1 = __fadd_rn(__fadd_rn(sum1, s[kb][n][2]), s[kb][n][3]);
        }
      }
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    const float r0 = __frcp_rn(sum0), r1 = __frcp_rn(sum1);
    float acc[ND][4];
    zero(acc);
#pragma unroll
    for (int kb = 0; kb < MAXKB; ++kb) {
      if (kb < MT) {
        divide_block(s[kb], sum0, r0, sum1, r1);
        uint32_t a[4];
        c_to_a(a, s[kb]);
        av_block<DH>(acc, a, vr + kb * 16 * RS, lane);
      }
    }
    store_tile<DH, ND>(o + ((size_t)(n0 + r) * Tn + m0) * DH, acc, Tn - m0, vec, lane);
  }
}

// As attn_fwd_rows, with do staged too and, after the mask terms, each row's
// per-query max, sum, D and the sum's reciprocal (4 x Tp f32); or, STORE,
// the query phase's round(w32), bf16(ds) and bf16(ds - bf16(ds)) (3 x Tp x
// (Tp + 8) bf16), which the key phase reads transposed by ldmatrix instead
// of recomputing them.
template <int DH, int MAXKB, bool STORE>
__global__ void __launch_bounds__(STORE ? WARPS_STORE * 32 : WARPS_REG * 32,
                                  STORE || MAXKB > 8 ? 2 : 3)
attn_bwd_rows(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const float* __restrict__ mask,
              const uint16_t* __restrict__ dout, uint16_t* __restrict__ dq,
              uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int N, int Tn, int R,
              float scale, int vec) {
  constexpr int RS = rs_of(DH), KS = dhp_of(DH) / 16, ND = dhp_of(DH) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (Tn + 15) & ~15, MT = Tp >> 4, rowe = Tp * RS;
  const int n0 = blockIdx.x * R, rows = min(R, N - n0);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ks = qs + R * rowe;
  uint16_t* vs = ks + R * rowe;
  uint16_t* dos = vs + R * rowe;
  float* mn = reinterpret_cast<float*>(dos + R * rowe);
  float* stats = mn + R * Tp;
  uint16_t* wsm = reinterpret_cast<uint16_t*>(stats);       // STORE: W, Hi, Lo of each row
  constexpr int NW = STORE ? WARPS_STORE : WARPS_REG;
  const int WS = Tp + 8, wrow = 3 * Tp * WS;
  for (int r = 0; r < rows; ++r) {
    const size_t off = (size_t)(n0 + r) * Tn * DH;
    stage_rows<DH>(qs + r * rowe, q + off, Tn, Tp, vec);
    stage_rows<DH>(ks + r * rowe, k + off, Tn, Tp, vec);
    stage_rows<DH>(vs + r * rowe, v + off, Tn, Tp, vec);
    stage_rows<DH>(dos + r * rowe, dout + off, Tn, Tp, vec);
    stage_mask_terms(mn + r * Tp, mask + (size_t)(n0 + r) * Tn, Tn, Tp);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // ---- query phase: a warp per 16 queries; max, sum, D kept for the key phase
  for (int task = threadIdx.x >> 5; task < rows * MT; task += NW) {
    const int r = task / MT, m0 = (task % MT) * 16;
    const uint16_t* kr = ks + r * rowe;
    const uint16_t* vr = vs + r * rowe;
    const float* mr = mn + r * Tp;
    uint32_t qa[KS][4], da[KS][4];
    load_a<DH>(qa, qs + r * rowe + m0 * RS, lane);
    load_a<DH>(da, dos + r * rowe + m0 * RS, lane);
    float s[MAXKB][2][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int kb = 0; kb < MAXKB; ++kb) {
      if (kb < MT) {
        logits_block<DH>(s[kb], qa, kr + kb * 16 * RS, mr + kb * 16, scale, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[kb][n][0], s[kb][n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[kb][n][2], s[kb][n][3]));
        }
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kb = 0; kb < MAXKB; ++kb) {
      if (kb < MT) {
        exp_block(s[kb], mx0, mx1);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          sum0 = __fadd_rn(__fadd_rn(sum0, s[kb][n][0]), s[kb][n][1]);
          sum1 = __fadd_rn(__fadd_rn(sum1, s[kb][n][2]), s[kb][n][3]);
        }
      }
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    const float r0 = __frcp_rn(sum0), r1 = __frcp_rn(sum1);
    float D0 = 0.f, D1 = 0.f;
#pragma unroll
    for (int kb = 0; kb < MAXKB; ++kb) {
      if (kb < MT) {
        divide_block(s[kb], sum0, r0, sum1, r1);
        float dw[2][4];
        dw_block<DH>(dw, da, vr + kb * 16 * RS, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          D0 = fmaf(dw[n][1], s[kb][n][1], fmaf(dw[n][0], s[kb][n][0], D0));
          D1 = fmaf(dw[n][3], s[kb][n][3], fmaf(dw[n][2], s[kb][n][2], D1));
        }
      }
    }
    D0 = quad_sum(D0);
    D1 = quad_sum(D1);
    float acc[ND][4];
    zero(acc);
#pragma unroll
    for (int kb = 0; kb < MAXKB; ++kb) {
      if (kb < MT) {
        float ds[2][4];
        dw_block<DH>(ds, da, vr + kb * 16 * RS, lane);
        ds_block(ds, s[kb], D0, D1, scale);
        uint32_t hi[4], lo[4];
        c_to_a_split(hi, lo, ds);
        av2_block<DH>(acc, hi, lo, kr + kb * 16 * RS, lane);
        if constexpr (STORE) {
          // A-fragment words: rows g and g + 8, keys 2t.. and 8 + 2t..
          uint32_t wa[4];
          c_to_a(wa, s[kb]);
          uint16_t* p = wsm + r * wrow + (m0 + g) * WS + kb * 16 + 2 * t;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const uint32_t(&x)[4] = j == 0 ? wa : j == 1 ? hi : lo;
            uint16_t* pj = p + j * Tp * WS;
            *reinterpret_cast<uint32_t*>(pj) = x[0];
            *reinterpret_cast<uint32_t*>(pj + 8 * WS) = x[1];
            *reinterpret_cast<uint32_t*>(pj + 8) = x[2];
            *reinterpret_cast<uint32_t*>(pj + 8 * WS + 8) = x[3];
          }
        }
      }
    }
    store_tile<DH, ND>(dq + ((size_t)(n0 + r) * Tn + m0) * DH, acc, Tn - m0, vec, lane);
    if (!STORE && (lane & 3) == 0) {
      float* st = stats + r * 4 * Tp + m0 + g;
      st[0] = mx0;
      st[8] = mx1;
      st[Tp] = sum0;
      st[Tp + 8] = sum1;
      st[2 * Tp] = D0;
      st[2 * Tp + 8] = D1;
      st[3 * Tp] = r0;
      st[3 * Tp + 8] = r1;
    }
  }
  __syncthreads();

  // ---- key phase: a warp per 16 keys, over every query block of the row
  for (int task = threadIdx.x >> 5; task < rows * MT; task += NW) {
    const int r = task / MT, k0 = (task % MT) * 16;
    const uint16_t* qr = qs + r * rowe;
    const uint16_t* dor = dos + r * rowe;
    float dka[ND][4], dva[ND][4];
    zero(dka);
    zero(dva);
    if constexpr (STORE) {
      // W^T, Hi^T, Lo^T as A operands: the stored (query, key) blocks, transposed
      const uint16_t* p = wsm + r * wrow + ((lane & 7) + (lane >> 4) * 8) * WS + k0 +
                          ((lane >> 3) & 1) * 8;
      for (int qb = 0; qb < MT; ++qb) {
        const uint16_t* pb = p + qb * 16 * WS;
        uint32_t wa[4], hi[4], lo[4];
        ldsm_x4_t(wa, pb);
        ldsm_x4_t(hi, pb + Tp * WS);
        ldsm_x4_t(lo, pb + 2 * Tp * WS);
        av_block<DH>(dva, wa, dor + qb * 16 * RS, lane);
        av2_block<DH>(dka, hi, lo, qr + qb * 16 * RS, lane);
      }
    } else {
      const float* st = stats + r * 4 * Tp;
      uint32_t ka[KS][4], va[KS][4];
      load_a<DH>(ka, ks + r * rowe + k0 * RS, lane);
      load_a<DH>(va, vs + r * rowe + k0 * RS, lane);
      const float mg0 = mn[r * Tp + k0 + g], mg1 = mn[r * Tp + k0 + g + 8];
      for (int qb = 0; qb < MT; ++qb)
        key_block<DH>(dka, dva, ka, va, mg0, mg1, qr + qb * 16 * RS, dor + qb * 16 * RS,
                      st + qb * 16, st + Tp + qb * 16, st + 2 * Tp + qb * 16,
                      st + 3 * Tp + qb * 16, qb * 16, Tn, scale, lane);
    }
    const size_t out = ((size_t)(n0 + r) * Tn + k0) * DH;
    store_tile<DH, ND>(dk + out, dka, Tn - k0, vec, lane);
    store_tile<DH, ND>(dv + out, dva, Tn - k0, vec, lane);
  }
}

// ---------------------------------------------------------- passes path

// Shared memory of the passes path: the CTA's own QR rows (one array in the
// forward: q; two in the backward: q and do, then k and v) and, for the
// backward, the row's per-query max, sum, D and 1 / sum and the own keys'
// mask terms; then a 2-stage ring of KT-key (or KT-query) tiles: two arrays of KT x RS
// and KT mask terms a stage.
constexpr int QR = 16 * WARPS_PASS;

template <int DH>
__device__ __forceinline__ void pass_block(int pass, const uint32_t (&qa)[dhp_of(DH) / 16][4],
                                           const uint32_t (&da)[dhp_of(DH) / 16][4],
                                           const uint16_t* ks, const uint16_t* vs,
                                           const float* mn, float scale, float& mx0, float& mx1,
                                           float& sum0, float& sum1, float r0, float r1,
                                           float& D0, float& D1,
                                           float (&acc)[dhp_of(DH) / 8][4], bool backward,
                                           int lane) {
  float s[2][4];
  logits_block<DH>(s, qa, ks, mn, scale, lane);
  if (pass == 0) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    return;
  }
  exp_block(s, mx0, mx1);
  if (pass == 1) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      sum0 = __fadd_rn(__fadd_rn(sum0, s[n][0]), s[n][1]);
      sum1 = __fadd_rn(__fadd_rn(sum1, s[n][2]), s[n][3]);
    }
    return;
  }
  divide_block(s, sum0, r0, sum1, r1);
  if (!backward) {                                   // forward pass 2: AV
    uint32_t a[4];
    c_to_a(a, s);
    av_block<DH>(acc, a, vs, lane);
    return;
  }
  float dw[2][4];
  dw_block<DH>(dw, da, vs, lane);
  if (pass == 2) {                                   // backward pass 2: D
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      D0 = fmaf(dw[n][1], s[n][1], fmaf(dw[n][0], s[n][0], D0));
      D1 = fmaf(dw[n][3], s[n][3], fmaf(dw[n][2], s[n][2], D1));
    }
    return;
  }
  ds_block(dw, s, D0, D1, scale);                    // backward pass 3: dq
  uint32_t hi[4], lo[4];
  c_to_a_split(hi, lo, dw);
  av2_block<DH>(acc, hi, lo, ks, lane);
}

// The query side of the passes path for the warp's m-tile of the CTA's own
// rows (A fragments qa, and da in the backward): npass passes over the key
// tiles of row n, each tile staged into the ring while the one before is used.
// Every thread of the CTA calls it (act: the warp has queries).
template <int DH>
__device__ __forceinline__ void query_passes(
    int npass, bool backward, bool act, const uint32_t (&qa)[dhp_of(DH) / 16][4],
    const uint32_t (&da)[dhp_of(DH) / 16][4], const uint16_t* k, const uint16_t* v,
    const float* mask, uint16_t* ring, float* mring, int Tn, float scale, bool vec,
    float& mx0, float& mx1, float& sum0, float& sum1, float& r0, float& r1, float& D0, float& D1,
    float (&acc)[dhp_of(DH) / 8][4], int lane) {
  constexpr int RS = rs_of(DH), KT = kt_of(DH);
  const int ntile = (Tn + KT - 1) / KT;
  for (int pass = 0; pass < npass; ++pass) {
    const bool with_v = pass >= 2;
    auto fetch = [&](int it) {
      const int j0 = it * KT, nk = min(KT, Tn - j0), st = it & 1;
      stage_rows<DH>(ring + st * 2 * KT * RS, k + (size_t)j0 * DH, nk, KT, vec);
      if (with_v) stage_rows<DH>(ring + (st * 2 + 1) * KT * RS, v + (size_t)j0 * DH, nk, KT, vec);
      stage_mask_terms(mring + st * KT, mask + j0, nk, KT);
      cp_async_commit();
    };
    fetch(0);
    for (int it = 0; it < ntile; ++it) {
      if (it + 1 < ntile) {
        fetch(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (act) {
        const int st = it & 1, nkb = (min(KT, Tn - it * KT) + 15) / 16;
        const uint16_t* ksb = ring + st * 2 * KT * RS;
        const uint16_t* vsb = ksb + KT * RS;
        const float* mnb = mring + st * KT;
#pragma unroll 2
        for (int kb = 0; kb < nkb; ++kb)
          pass_block<DH>(pass, qa, da, ksb + kb * 16 * RS, vsb + kb * 16 * RS, mnb + kb * 16,
                         scale, mx0, mx1, sum0, sum1, r0, r1, D0, D1, acc, backward, lane);
      }
      __syncthreads();
    }
    if (pass == 0) {
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
    } else if (pass == 1) {
      sum0 = quad_sum(sum0);
      sum1 = quad_sum(sum1);
      r0 = __frcp_rn(sum0);
      r1 = __frcp_rn(sum1);
    } else if (pass == 2 && backward) {
      D0 = quad_sum(D0);
      D1 = quad_sum(D1);
    }
  }
}

// CTA b: row b / chunks, queries QR * (b % chunks) ..
template <int DH>
__global__ void __launch_bounds__(WARPS_PASS * 32, 2)
attn_fwd_passes(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, const float* __restrict__ mask,
                uint16_t* __restrict__ o, int Tn, float scale, int vec) {
  constexpr int RS = rs_of(DH), KS = dhp_of(DH) / 16, ND = dhp_of(DH) / 8, KT = kt_of(DH);
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (Tn + QR - 1) / QR;
  const int n = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * QR, nq = min(QR, Tn - c0);
  float* mring = reinterpret_cast<float*>(smem);                    // 2 x KT
  uint16_t* qs = reinterpret_cast<uint16_t*>(mring + 2 * KT);       // QR x RS
  uint16_t* ring = qs + QR * RS;                                    // 2 x 2 x KT x RS
  const size_t off = (size_t)n * Tn * DH;
  stage_rows<DH>(qs, q + off + (size_t)c0 * DH, nq, QR, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const bool act = m0 < nq;
  uint32_t qa[KS][4];
  if (act) load_a<DH>(qa, qs + m0 * RS, lane);
  float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f, r0 = 0.f, r1 = 0.f;
  float D0 = 0.f, D1 = 0.f;
  float acc[ND][4];
  zero(acc);
  query_passes<DH>(3, false, act, qa, qa, k + off, v + off, mask + (size_t)n * Tn, ring, mring,
                   Tn, scale, vec, mx0, mx1, sum0, sum1, r0, r1, D0, D1, acc, lane);
  if (act) store_tile<DH, ND>(o + off + (size_t)(c0 + m0) * DH, acc, nq - m0, vec, lane);
}

// CTA n: row n, both phases, in rounds of QR queries (then keys)
template <int DH>
__global__ void __launch_bounds__(WARPS_PASS * 32, 2)
attn_bwd_passes(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, const float* __restrict__ mask,
                const uint16_t* __restrict__ dout, uint16_t* __restrict__ dq,
                uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int Tn, float scale,
                int vec) {
  constexpr int RS = rs_of(DH), KS = dhp_of(DH) / 16, ND = dhp_of(DH) / 8, KT = kt_of(DH);
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (Tn + 15) & ~15;
  float* smx = reinterpret_cast<float*>(smem);       // Tp each: max, sum, D, 1 / sum
  float* ssum = smx + Tp;
  float* sD = ssum + Tp;
  float* srcp = sD + Tp;
  float* omn = srcp + Tp;                                           // QR
  float* mring = omn + QR;                                          // 2 x KT
  uint16_t* oa = reinterpret_cast<uint16_t*>(mring + 2 * KT);       // QR x RS each
  uint16_t* ob = oa + QR * RS;
  uint16_t* ring = ob + QR * RS;                                    // 2 x 2 x KT x RS
  const size_t off = (size_t)blockIdx.x * Tn * DH;
  const float* mrow = mask + (size_t)blockIdx.x * Tn;
  const int lane = threadIdx.x & 31, g = lane >> 2, m0 = (threadIdx.x >> 5) * 16;

  // ---- query phase: max, sum, D (kept for the key phase) and dq
  for (int c0 = 0; c0 < Tn; c0 += QR) {
    const int nq = min(QR, Tn - c0);
    __syncthreads();
    stage_rows<DH>(oa, q + off + (size_t)c0 * DH, nq, QR, vec);
    stage_rows<DH>(ob, dout + off + (size_t)c0 * DH, nq, QR, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const bool act = m0 < nq;
    uint32_t qa[KS][4], da[KS][4];
    if (act) {
      load_a<DH>(qa, oa + m0 * RS, lane);
      load_a<DH>(da, ob + m0 * RS, lane);
    }
    float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f, r0 = 0.f, r1 = 0.f;
    float D0 = 0.f, D1 = 0.f;
    float acc[ND][4];
    zero(acc);
    query_passes<DH>(4, true, act, qa, da, k + off, v + off, mrow, ring, mring, Tn, scale, vec,
                     mx0, mx1, sum0, sum1, r0, r1, D0, D1, acc, lane);
    if (act) {
      store_tile<DH, ND>(dq + off + (size_t)(c0 + m0) * DH, acc, nq - m0, vec, lane);
      if ((lane & 3) == 0) {
        const int i = c0 + m0 + g;
        smx[i] = mx0;
        smx[i + 8] = mx1;
        ssum[i] = sum0;
        ssum[i + 8] = sum1;
        sD[i] = D0;
        sD[i + 8] = D1;
        srcp[i] = r0;
        srcp[i + 8] = r1;
      }
    }
  }

  // ---- key phase: the CTA's own keys against every query tile of the row
  const int ntile = (Tn + KT - 1) / KT;
  for (int c0 = 0; c0 < Tn; c0 += QR) {
    const int nk = min(QR, Tn - c0);
    __syncthreads();
    stage_rows<DH>(oa, k + off + (size_t)c0 * DH, nk, QR, vec);
    stage_rows<DH>(ob, v + off + (size_t)c0 * DH, nk, QR, vec);
    stage_mask_terms(omn, mrow + c0, nk, QR);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const bool act = m0 < nk;
    uint32_t ka[KS][4], va[KS][4];
    if (act) {
      load_a<DH>(ka, oa + m0 * RS, lane);
      load_a<DH>(va, ob + m0 * RS, lane);
    }
    const float mg0 = omn[m0 + g], mg1 = omn[m0 + g + 8];
    float dka[ND][4], dva[ND][4];
    zero(dka);
    zero(dva);
    auto fetch = [&](int it) {
      const int i0 = it * KT, ni = min(KT, Tn - i0), st = it & 1;
      stage_rows<DH>(ring + st * 2 * KT * RS, q + off + (size_t)i0 * DH, ni, KT, vec);
      stage_rows<DH>(ring + (st * 2 + 1) * KT * RS, dout + off + (size_t)i0 * DH, ni, KT, vec);
      cp_async_commit();
    };
    fetch(0);
    for (int it = 0; it < ntile; ++it) {
      if (it + 1 < ntile) {
        fetch(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (act) {
        const int i0 = it * KT, nqb = (min(KT, Tn - i0) + 15) / 16;
        const uint16_t* qsb = ring + (it & 1) * 2 * KT * RS;
        const uint16_t* dosb = qsb + KT * RS;
        for (int qb = 0; qb < nqb; ++qb) {
          const int i = i0 + qb * 16;
          key_block<DH>(dka, dva, ka, va, mg0, mg1, qsb + qb * 16 * RS, dosb + qb * 16 * RS,
                        smx + i, ssum + i, sD + i, srcp + i, i, Tn, scale, lane);
        }
      }
      __syncthreads();
    }
    if (act) {
      store_tile<DH, ND>(dk + off + (size_t)(c0 + m0) * DH, dka, nk - m0, vec, lane);
      store_tile<DH, ND>(dv + off + (size_t)(c0 + m0) * DH, dva, nk - m0, vec, lane);
    }
  }
}

// ------------------------------------------------------------------ plan

// The launch of a shape (ops/attention_kernel.attention_plan is its mirror):
// path 0 registers (T <= REG_CAP), 1 passes, 2 registers with the backward's
// weights and ds stored for its key phase (one row a CTA, where that fits
// two CTAs a SM); rows a CTA; warps a CTA; shared bytes a CTA; CTAs.
struct Plan {
  int path, rows, warps, smem, ctas;
};

inline Plan plan_mma(bool backward, int N, int T, int dh) {
  const int Tp = (T + 15) & ~15, MT = Tp / 16, rs2 = rs_of(dh) * 2, kt = kt_of(dh);
  if (T <= REG_CAP) {
    const int stored = 4 * Tp * rs2 + 4 * Tp + 6 * Tp * (Tp + 8);
    if (backward && stored <= STORE_BUDGET) return {2, 1, WARPS_STORE, stored, N};
    const int per_row = backward ? 4 * Tp * rs2 + 20 * Tp : 3 * Tp * rs2 + 4 * Tp;
    // rows a CTA: the share of its warps' task slots in use (R * MT tasks
    // over WARPS_REG warps) at its largest, the fewest rows on a tie, within
    // the budget
    int best = 1, best_use = MT, best_slots = WARPS_REG * ((MT + WARPS_REG - 1) / WARPS_REG);
    for (int R = 2; R <= ROWS_MAX && R <= N && R * per_row <= ROW_BUDGET; ++R) {
      const int use = R * MT, slots = WARPS_REG * ((use + WARPS_REG - 1) / WARPS_REG);
      if ((long long)use * best_slots > (long long)best_use * slots) {
        best = R;
        best_use = use;
        best_slots = slots;
      }
    }
    return {0, best, WARPS_REG, best * per_row, (N + best - 1) / best};
  }
  const int ring = 2 * (2 * kt * rs2 + 4 * kt);
  if (!backward) return {1, 1, WARPS_PASS, QR * rs2 + ring, N * ((T + QR - 1) / QR)};
  return {1, 1, WARPS_PASS, 16 * Tp + 4 * QR + 2 * QR * rs2 + ring, N};
}

template <typename K, typename... A>
int launch(K kernel, int ctas, int threads, int smem, cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<ctas, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int DH>
int fwd_mma(const void* q, const void* k, const void* v, const float* mask, void* o, int N,
            int T, float scale, cudaStream_t s) {
  const Plan p = plan_mma(false, N, T, DH);
  const int vec = aligned16({q, k, v, o});
  const auto* qq = static_cast<const uint16_t*>(q);
  const auto* kk = static_cast<const uint16_t*>(k);
  const auto* vv = static_cast<const uint16_t*>(v);
  auto* oo = static_cast<uint16_t*>(o);
  const int threads = p.warps * 32;
  if (p.path == 1)
    return launch(attn_fwd_passes<DH>, p.ctas, threads, p.smem, s, qq, kk, vv, mask, oo, T,
                  scale, vec);
  if (T <= 128)
    return launch(attn_fwd_rows<DH, 8>, p.ctas, threads, p.smem, s, qq, kk, vv, mask, oo, N, T,
                  p.rows, scale, vec);
  return launch(attn_fwd_rows<DH, 16>, p.ctas, threads, p.smem, s, qq, kk, vv, mask, oo, N, T,
                p.rows, scale, vec);
}

template <int DH>
int bwd_mma(const void* q, const void* k, const void* v, const float* mask, const void* dout,
            void* dq, void* dk, void* dv, int N, int T, float scale, cudaStream_t s) {
  const Plan p = plan_mma(true, N, T, DH);
  const int vec = aligned16({q, k, v, dout, dq, dk, dv});
  const auto* qq = static_cast<const uint16_t*>(q);
  const auto* kk = static_cast<const uint16_t*>(k);
  const auto* vv = static_cast<const uint16_t*>(v);
  const auto* dd = static_cast<const uint16_t*>(dout);
  auto* gq = static_cast<uint16_t*>(dq);
  auto* gk = static_cast<uint16_t*>(dk);
  auto* gv = static_cast<uint16_t*>(dv);
  const int threads = p.warps * 32;
  if (p.path == 1)
    return launch(attn_bwd_passes<DH>, p.ctas, threads, p.smem, s, qq, kk, vv, mask, dd, gq, gk,
                  gv, T, scale, vec);
  if (p.path == 2)
    return launch(attn_bwd_rows<DH, 8, true>, p.ctas, threads, p.smem, s, qq, kk, vv, mask, dd,
                  gq, gk, gv, N, T, p.rows, scale, vec);
  if (T <= 128)
    return launch(attn_bwd_rows<DH, 8, false>, p.ctas, threads, p.smem, s, qq, kk, vv, mask, dd,
                  gq, gk, gv, N, T, p.rows, scale, vec);
  return launch(attn_bwd_rows<DH, 16, false>, p.ctas, threads, p.smem, s, qq, kk, vv, mask, dd,
                gq, gk, gv, N, T, p.rows, scale, vec);
}

}  // namespace sepattn
