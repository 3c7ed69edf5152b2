// Attention over one (batch, head, query tile), shared by rope_attention.cu,
// token_attention.cu, flash_forward.cu and flash_dense.cu (and, for its
// loaders and MMA step, attention_bwd_tile.cuh).
//
// Variants: each source is built once per element type and padded head
// dim, chosen with -D defines on the nvcc line (ops/kernel_build.py):
// ATTN_F32=1 for float (default bf16) and ATTN_D = 64, 128, 256 or 512, the
// padded head dim kHeadDim (default 64). The kernels take any head dim d
// with d % 8 == 0 and d <= kHeadDim: shared-memory tiles hold kHeadDim
// columns, columns from d to kHeadDim are zero-filled on load and add 0 to
// Q K^T, and only the first d columns of O are written. d % 8 == 0 keeps
// the 16-byte vector loads legal for both types. The C entries are named by
// type: <name>_bf16 or <name>_f32 (ATTN_ENTRY).
//
// Layout: tiles are [rows, kHeadDim] with padded row strides in shared
// memory; in global memory a tile has a row stride the caller gives: H*d
// for the token-major tensors [B, L, H*d] (head h owns columns
// [h*d, (h+1)*d)), d for the head-major tensors [B, H, L, d].
//
// Design: one block of kTileQ / 16 warps per kTileQ query rows; each warp
// owns 16 rows. The kv axis is walked in kTileK-row tiles. S = Q K^T and
// O += P V run on the tensor cores through WMMA: bf16 m16n16k16, or for
// float TF32 m16n16k8 with a 3xTF32 split (a = hi + lo, the sum
// lo*hi + hi*lo + hi*hi, about 2^-22 relative per product, where one-pass
// TF32 keeps about 2^-11), all accumulating in f32. The f32 accumulator O,
// the logits S and the probabilities P (in T) live in shared memory per
// warp, so the softmax pass can rescale rows without knowing the
// accumulator fragment's register layout.
//
// Tile rows per variant, so that Smem fits a block's 227 KB (the dense-bias
// forward adds a [kTileQ, kTileK + 1] f32 bias tile):
//   bf16   d 64, 128, 256: kTileQ 64, kTileK 64  (72, 113, 194 KB)
//   bf16   d 512:          kTileQ 32, kTileK 32  (173 KB)
//   float  d 64, 128:      kTileQ 64, kTileK 64  (104, 169 KB)
//   float  d 256:          kTileQ 32, kTileK 32  (142 KB)
//   float  d 512:          kTileQ 32, kTileK 16  (203 KB)
//
// Softmax, as the TPU kernels compute it:
// - bounded (qk-normed logits): p = exp(min(s*scale, 80)), no max pass;
// - otherwise an online max: p = exp(s*scale - m), O and l rescaled by
//   exp(m_old - m_new) when the running max rises;
// - or, for a whole-row softmax in two passes over the keys, a first pass
//   of row_max_tile and then p = exp(s*scale - m) against that fixed max
//   with no rescale.
// p is rounded to T before the PV product (a no-op in float). Keys are
// kept (1), masked (0) or past the end (-1). Masked and past-end keys get
// p = 0; a row with no kept key has l = 0, which is set to 1, so it returns
// 0 exactly as the TPU kernel does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#ifndef ATTN_F32
#define ATTN_F32 0
#endif
#ifndef ATTN_D
#define ATTN_D 64
#endif

#if ATTN_F32
#define ATTN_ENTRY(name) name##_f32
#else
#define ATTN_ENTRY(name) name##_bf16
#endif

namespace avatar_attn {

using namespace nvcuda;

#if ATTN_F32
using T = float;
#else
using T = __nv_bfloat16;
#endif
constexpr bool kF32 = ATTN_F32;
constexpr int kHeadDim = ATTN_D;
static_assert(kHeadDim == 64 || kHeadDim == 128 || kHeadDim == 256 || kHeadDim == 512,
              "ATTN_D is a padded head dim: 64, 128, 256 or 512");
constexpr bool kSmallTiles = kHeadDim == 512 || (kF32 && kHeadDim == 256);
constexpr int kTileQ = kSmallTiles ? 32 : 64;
constexpr int kTileK = kHeadDim == 512 && kF32 ? 16 : (kSmallTiles ? 32 : 64);
constexpr int kWarps = kTileQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = kF32 ? 4 : 8;          // 16 bytes of row padding
constexpr int kLdh = kHeadDim + kPad;       // T row stride of q, k, v
constexpr int kLdp = kTileK + kPad;         // T row stride of p
constexpr int kLdf = kTileK + 4;            // f32 row stride of s
constexpr int kLdo = kHeadDim + 4;          // f32 row stride of o
constexpr float kBoundedClamp = 80.0f;

struct Smem {
  T q[kTileQ * kLdh];
  T k[kTileK * kLdh];
  T v[kTileK * kLdh];
  T p[kTileQ * kLdp];
  float s[kTileQ * kLdf];
  float o[kTileQ * kLdo];
  float keep[kTileK];
};

// ---------------------------------------------------------------------------
// Element type
// ---------------------------------------------------------------------------

__device__ __forceinline__ T to_t(float x) {
#if ATTN_F32
  return x;
#else
  return __float2bfloat16_rn(x);
#endif
}

__device__ __forceinline__ float from_t(T x) {
#if ATTN_F32
  return x;
#else
  return __bfloat162float(x);
#endif
}

constexpr int kU4 = sizeof(T) / 2;  // 16-byte vectors per 8 elements

__device__ __forceinline__ void copy8(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < kU4; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int i = 0; i < kU4; ++i) reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void load8(const T* src, float* out) {
#if ATTN_F32
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
#else
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
#endif
}

__device__ __forceinline__ void store8(T* dst, const float* in) {
#if ATTN_F32
  reinterpret_cast<float4*>(dst)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(in[4], in[5], in[6], in[7]);
#else
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
#endif
}

// ---------------------------------------------------------------------------
// One WMMA step: acc[16, 16] += A[16, kK] B[kK, 16]
// ---------------------------------------------------------------------------

#if ATTN_F32
constexpr int kK = 8;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

// x = hi + lo, both TF32: hi keeps 11 bits of the mantissa, lo the next 11
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& hi, Frag& lo) {
#pragma unroll
  for (int i = 0; i < hi.num_elements; ++i) {
    const float x = hi.x[i];
    const float h = wmma::__float_to_tf32(x);
    hi.x[i] = h;
    lo.x[i] = wmma::__float_to_tf32(x - h);
  }
}
#else
constexpr int kK = 16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
#endif

// `a` row-major with row stride lda; `b` FragBCol (b[n][k] at b + n * ldb +
// k) or FragBRow (b[k][n] at b + k * ldb + n).
template <typename FragB>
__device__ __forceinline__ void mma_step(AccFrag& acc, const T* a, int lda,
                                         const T* b, int ldb) {
  FragA fa;
  FragB fb;
  wmma::load_matrix_sync(fa, a, lda);
  wmma::load_matrix_sync(fb, b, ldb);
#if ATTN_F32
  // The three products go to a fresh fragment that is then added to acc
  // with IEEE f32 adds: the tensor cores' own f32 accumulation does not
  // round to nearest, and chained over hundreds of steps (a 5376-key walk)
  // it drifts by ~1e-4 relative, ten times the f32 variants' gate.
  FragA fa_lo;
  FragB fb_lo;
  split_tf32(fa, fa_lo);
  split_tf32(fb, fb_lo);
  AccFrag part;
  wmma::fill_fragment(part, 0.0f);
  wmma::mma_sync(part, fa_lo, fb, part);
  wmma::mma_sync(part, fa, fb_lo, part);
  wmma::mma_sync(part, fa, fb, part);
#pragma unroll
  for (int i = 0; i < part.num_elements; ++i) acc.x[i] += part.x[i];
#else
  wmma::mma_sync(acc, fa, fb, acc);
#endif
}

// ---------------------------------------------------------------------------
// Loaders, for a block of kN threads (kThreads unless given)
// ---------------------------------------------------------------------------

// Copy `rows` rows of d columns (row stride `ld` elements in global memory)
// into a [kRows, kHeadDim] tile, zero-filling the rest.
template <int kRows, int kN = kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ld,
                                          int rows, int d) {
  constexpr int kVecs = kHeadDim / 8;
  if (d == kHeadDim) {
#pragma unroll
    for (int i = threadIdx.x; i < kRows * kVecs; i += kN) {
      const int r = i / kVecs;
      const int c = (i % kVecs) * 8;
      if (r < rows) copy8(dst + r * kLdh + c, src + r * ld + c);
      else zero8(dst + r * kLdh + c);
    }
    return;
  }
#pragma unroll
  for (int i = threadIdx.x; i < kRows * kVecs; i += kN) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (r < rows && c < d) copy8(dst + r * kLdh + c, src + r * ld + c);
    else zero8(dst + r * kLdh + c);
  }
}

// Keep flags of one key tile: 1 kept, 0 masked, -1 past the end. `mask`
// is this batch row's [Lk] f32 keep-mask (> 0.5 keeps) or null.
template <int kRows, int kN = kThreads>
__device__ __forceinline__ void load_keep(float* keep, const float* mask,
                                          int k0, int rows) {
  for (int j = threadIdx.x; j < kRows; j += kN) {
    float flag = -1.0f;
    if (j < rows) flag = (mask == nullptr || mask[k0 + j] > 0.5f) ? 1.0f : 0.0f;
    keep[j] = flag;
  }
}

template <int kRows, int kN>
__device__ __forceinline__ void rope_rows(T* dst, const T* x, const T* cs,
                                          const T* sn, int64_t ld, int half,
                                          int rows, int d) {
  const int hd2 = d / 2;
  const int vecs = hd2 / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kRows * vecs; i += kN) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    float r1[8], r2[8];
    if (r < rows) {
      float x1[8], x2[8], cv[8], sv[8];
      load8(x + r * ld + c, x1);
      load8(x + r * ld + half + c, x2);
      load8(cs + r * (int64_t)half + c, cv);
      load8(sn + r * (int64_t)half + c, sv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        r1[j] = x1[j] * cv[j] - x2[j] * sv[j];
        r2[j] = x2[j] * cv[j] + x1[j] * sv[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) r1[j] = r2[j] = 0.0f;
    }
    store8(dst + r * kLdh + c, r1);
    store8(dst + r * kLdh + hd2 + c, r2);
  }
}

// Load rows of a split-half tensor (global columns [h*d/2, (h+1)*d/2) and
// [C/2 + h*d/2, ...)), rotate them by cos/sin ([B, L, C/2]) in f32 and store
// [x1*c - x2*s | x2*c + x1*s] in T (one rounding per value), zero-filling
// columns from d and rows from `rows`. `half` = C/2.
template <int kRows, int kN = kThreads>
__device__ __forceinline__ void load_rope_tile(T* dst, const T* x, const T* cs,
                                               const T* sn, int64_t ld, int half,
                                               int rows, int d) {
  if (d == kHeadDim) {  // the loop bounds known at compile time
    rope_rows<kRows, kN>(dst, x, cs, sn, ld, half, rows, kHeadDim);
    return;
  }
  rope_rows<kRows, kN>(dst, x, cs, sn, ld, half, rows, d);
  const int pad_vecs = (kHeadDim - d) / 8;
  for (int i = threadIdx.x; i < kRows * pad_vecs; i += kN)
    zero8(dst + (i / pad_vecs) * kLdh + d + (i % pad_vecs) * 8);
}

// ---------------------------------------------------------------------------
// Warp-level products and the softmax pass
// ---------------------------------------------------------------------------

// S = Q K^T of one kv tile for this warp's 16 query rows, unscaled f32,
// into the warp's rows of sm.s.
__device__ __forceinline__ void logits_tile(Smem& sm, int warp) {
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdf;
#pragma unroll
  for (int j = 0; j < kTileK / 16; ++j) {
    AccFrag acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / kK; ++kk)
      mma_step<FragBCol>(acc, sm.q + row0 * kLdh + kk * kK, kLdh,
                         sm.k + j * 16 * kLdh + kk * kK, kLdh);
    wmma::store_matrix_sync(s_w + j * 16, acc, kLdf, wmma::mem_row_major);
  }
  __syncwarp();
}

// Max of this lane's half row of scaled logits. Masked keys sit at -1e30
// (always above a past-end key's -inf), so a running max is finite after
// the first tile.
__device__ __forceinline__ float half_row_max(const float* srow,
                                              const float* keep, float scale) {
  float mx = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < kTileK / 2; ++c) {
    const float sv = keep[c] > 0.5f ? srow[c] * scale
                     : (keep[c] < -0.5f ? -INFINITY : -1e30f);
    mx = fmaxf(mx, sv);
  }
  return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
}

// First pass of the whole-row softmax: fold one kv tile's row max into `m`.
__device__ __forceinline__ void row_max_tile(Smem& sm, int warp, int lane,
                                             float scale, float& m) {
  logits_tile(sm, warp);
  const int c0 = (lane & 1) * (kTileK / 2);
  const float* srow = sm.s + (warp * 16 + (lane >> 1)) * kLdf + c0;
  m = fmaxf(m, half_row_max(srow, sm.keep + c0, scale));
  __syncwarp();
}

// O += P V for this warp's 16 query rows: the warp's p rows of sm.p against
// the kv tile's v, into its f32 rows of sm.o.
__device__ __forceinline__ void pv_accumulate(Smem& sm, int warp) {
  const int row0 = warp * 16;
  float* o_w = sm.o + row0 * kLdo;
  const T* p_w = sm.p + row0 * kLdp;
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) {
    AccFrag acc;
    wmma::load_matrix_sync(acc, o_w + j * 16, kLdo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTileK / kK; ++kk)
      mma_step<FragBRow>(acc, p_w + kk * kK, kLdp, sm.v + kk * kK * kLdh + j * 16, kLdh);
    wmma::store_matrix_sync(o_w + j * 16, acc, kLdo, wmma::mem_row_major);
  }
  __syncwarp();
}

// One kv tile for this warp's 16 query rows: S = Q K^T, softmax update,
// O += P V. `m` and `l` are the running row max and row sum of the row
// this lane shares with its neighbour lane (lanes 2r and 2r+1 own row r,
// kTileK / 2 columns each). kFixedMax: `m` already holds the max over
// every key (row_max_tile), so nothing is rescaled. `sum_rounded`: l sums
// the p rounded to T, the values the PV product uses, instead of the f32 p.
template <bool kBounded, bool kFixedMax = false>
__device__ __forceinline__ void attend_tile(Smem& sm, int warp, int lane,
                                            float scale, float& m, float& l,
                                            bool sum_rounded = false) {
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdf;
  float* o_w = sm.o + row0 * kLdo;
  T* p_w = sm.p + row0 * kLdp;
  logits_tile(sm, warp);

  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kTileK / 2);
  float* srow = s_w + r * kLdf + c0;
  const float* keep = sm.keep + c0;
  float alpha = 1.0f;
  float shift = 0.0f;
  if (!kBounded) {
    if (!kFixedMax) {
      const float m_new = fmaxf(m, half_row_max(srow, keep, scale));
      alpha = expf(m - m_new);
      m = m_new;
    }
    shift = m;
  }
  float psum = 0.0f;
#pragma unroll 8
  for (int c = 0; c < kTileK / 2; ++c) {
    const float sv = srow[c] * scale;
    float p;
    if (kBounded) {
      p = expf(fminf(sv, kBoundedClamp));
    } else {
      p = expf(sv - shift);
    }
    p = keep[c] > 0.5f ? p : 0.0f;
    const T pb = to_t(p);
    psum += sum_rounded ? from_t(pb) : p;
    p_w[r * kLdp + c0 + c] = pb;
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  l = l * alpha + psum;
  if (!kBounded && !kFixedMax) {
    float* orow = o_w + r * kLdo + (lane & 1) * (kHeadDim / 2);
#pragma unroll 8
    for (int c = 0; c < kHeadDim / 2; ++c) orow[c] *= alpha;
  }
  __syncwarp();
  pv_accumulate(sm, warp);
}

// Write O / l for this warp's rows (the first d columns) in T to out (row
// stride ld), head columns already applied by the caller.
__device__ __forceinline__ void store_rows(const Smem& sm, int warp, int lane,
                                           float l, T* out, int64_t ld, int rows,
                                           int d) {
  const int row = warp * 16 + (lane >> 1);
  if (row >= rows) return;
  const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
  const float* orow = sm.o + row * kLdo;
#pragma unroll
  for (int c = (lane & 1) * 8; c < kHeadDim; c += 16) {
    if (c >= d) break;
    float vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = orow[c + j] * inv;
    store8(out + row * ld + c, vals);
  }
}

}  // namespace avatar_attn
