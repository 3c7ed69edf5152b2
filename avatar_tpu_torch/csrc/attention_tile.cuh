// bf16 attention over one (batch, head, 64-row query tile), shared by
// rope_attention.cu, token_attention.cu and flash_forward.cu.
//
// Layout: every tile is [64 rows, 64 head dims] bf16 with a row stride the
// caller gives: H*64 for the token-major tensors [B, L, H*64] (head h owns
// columns [h*64, (h+1)*64)), 64 for the head-major tensors [B, H, L, 64].
// The caller's loader puts the (possibly rotated) q and k head slices into
// shared memory.
//
// Design: one block of 4 warps per 64 query rows; each warp owns 16 rows.
// The kv axis is walked in 64-row tiles. S = Q K^T and O += P V run on the
// tensor cores through WMMA (bf16 in, f32 accumulate). The f32 accumulator
// O, the logits S and the bf16 probabilities P live in shared memory per
// warp, so the softmax pass can rescale rows without knowing the
// accumulator fragment's register layout.
//
// Softmax, as the TPU kernels compute it:
// - bounded (qk-normed logits): p = exp(min(s*scale, 80)), no max pass;
// - otherwise an online max: p = exp(s*scale - m), O and l rescaled by
//   exp(m_old - m_new) when the running max rises;
// - or, for a whole-row softmax in two passes over the keys, a first pass
//   of row_max_tile and then p = exp(s*scale - m) against that fixed max
//   with no rescale.
// Keys are kept (1), masked (0) or past the end (-1). Masked and past-end
// keys get p = 0; a row with no kept key has l = 0, which is set to 1, so it
// returns 0 exactly as the TPU kernel does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace avatar_attn {

using namespace nvcuda;

constexpr int kHeadDim = 64;
constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdh = kHeadDim + 8;  // bf16 row stride (multiple of 8)
constexpr int kLdf = kTileK + 4;    // f32 row stride (multiple of 4)
constexpr float kBoundedClamp = 80.0f;

struct Smem {
  __nv_bfloat16 q[kTileQ * kLdh];
  __nv_bfloat16 k[kTileK * kLdh];
  __nv_bfloat16 v[kTileK * kLdh];
  __nv_bfloat16 p[kTileQ * kLdh];
  float s[kTileQ * kLdf];
  float o[kTileQ * kLdf];
  float keep[kTileK];
};

__device__ __forceinline__ void bf16x8_to_f32(uint4 raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 f32_to_bf16x8(const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return raw;
}

// Copy a [64, 64] bf16 head slice (row stride `ld` elements in global
// memory) into shared memory, zero-filling rows at or past `rows`.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t ld, int rows) {
  for (int i = threadIdx.x; i < kTileK * (kHeadDim / 8); i += kThreads) {
    const int r = i / (kHeadDim / 8);
    const int c = (i % (kHeadDim / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = val;
  }
}

// Keep flags of one key tile: 1 kept, 0 masked, -1 past the end. `mask`
// is this batch row's [Lk] f32 keep-mask (> 0.5 keeps) or null.
__device__ __forceinline__ void load_keep(float* keep, const float* mask,
                                          int k0, int rows) {
  if (threadIdx.x < kTileK) {
    const int j = threadIdx.x;
    float flag = -1.0f;
    if (j < rows) flag = (mask == nullptr || mask[k0 + j] > 0.5f) ? 1.0f : 0.0f;
    keep[j] = flag;
  }
}

// Load rows of a split-half tensor (global columns [h*32, h*32+32) and
// [C/2 + h*32, ...)), rotate them by cos/sin ([B, L, C/2]) in f32 and store
// [x1*c - x2*s | x2*c + x1*s] as bf16, one rounding per value.
__device__ __forceinline__ void load_rope_tile(__nv_bfloat16* dst,
                                               const __nv_bfloat16* x,
                                               const __nv_bfloat16* cs,
                                               const __nv_bfloat16* sn,
                                               int64_t ld, int half, int rows) {
  constexpr int kHalf = kHeadDim / 2;
  for (int i = threadIdx.x; i < kTileK * (kHalf / 8); i += kThreads) {
    const int r = i / (kHalf / 8);
    const int c = (i % (kHalf / 8)) * 8;
    float r1[8], r2[8];
    if (r < rows) {
      float x1[8], x2[8], cv[8], sv[8];
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(x + r * ld + c), x1);
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(x + r * ld + half + c), x2);
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(cs + r * (int64_t)half + c), cv);
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(sn + r * (int64_t)half + c), sv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        r1[j] = x1[j] * cv[j] - x2[j] * sv[j];
        r2[j] = x2[j] * cv[j] + x1[j] * sv[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) r1[j] = r2[j] = 0.0f;
    }
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = f32_to_bf16x8(r1);
    *reinterpret_cast<uint4*>(dst + r * kLdh + kHalf + c) = f32_to_bf16x8(r2);
  }
}

// S = Q K^T of one kv tile for this warp's 16 query rows, unscaled f32,
// into the warp's rows of sm.s.
__device__ __forceinline__ void logits_tile(Smem& sm, int warp) {
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdf;
#pragma unroll
  for (int j = 0; j < kTileK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sm.q + row0 * kLdh + kk * 16, kLdh);
      wmma::load_matrix_sync(b, sm.k + j * 16 * kLdh + kk * 16, kLdh);
      wmma::mma_sync(acc, a, b, acc);
    }
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

// O += P V for this warp's 16 query rows: the warp's bf16 p rows of sm.p
// against the kv tile's v, into its f32 rows of sm.o.
__device__ __forceinline__ void pv_accumulate(Smem& sm, int warp) {
  const int row0 = warp * 16;
  float* o_w = sm.o + row0 * kLdf;
  const __nv_bfloat16* p_w = sm.p + row0 * kLdh;
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o_w + j * 16, kLdf, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p_w + kk * 16, kLdh);
      wmma::load_matrix_sync(b, sm.v + kk * 16 * kLdh + j * 16, kLdh);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o_w + j * 16, acc, kLdf, wmma::mem_row_major);
  }
  __syncwarp();
}

// One kv tile for this warp's 16 query rows: S = Q K^T, softmax update,
// O += P V. `m` and `l` are the running row max and row sum of the row
// this lane shares with its neighbour lane (lanes 2r and 2r+1 own row r,
// 32 columns each). kFixedMax: `m` already holds the max over every key
// (row_max_tile), so nothing is rescaled. kSumRounded: l sums the
// bf16-rounded p, the values the PV product uses, instead of the f32 p.
template <bool kBounded, bool kFixedMax = false, bool kSumRounded = false>
__device__ __forceinline__ void attend_tile(Smem& sm, int warp, int lane,
                                            float scale, float& m, float& l) {
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdf;
  float* o_w = sm.o + row0 * kLdf;
  __nv_bfloat16* p_w = sm.p + row0 * kLdh;
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
    const __nv_bfloat16 pb = __float2bfloat16_rn(p);
    psum += kSumRounded ? __bfloat162float(pb) : p;
    p_w[r * kLdh + c0 + c] = pb;
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  l = l * alpha + psum;
  if (!kBounded && !kFixedMax) {
    float* orow = o_w + r * kLdf + c0;
#pragma unroll 8
    for (int c = 0; c < kHeadDim / 2; ++c) orow[c] *= alpha;
  }
  __syncwarp();
  pv_accumulate(sm, warp);
}

// Write O / l for this warp's rows as bf16 to out (row stride ld), head
// columns already applied by the caller.
__device__ __forceinline__ void store_rows(const Smem& sm, int warp, int lane,
                                           float l, __nv_bfloat16* out,
                                           int64_t ld, int rows) {
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kHeadDim / 2);
  const int row = warp * 16 + r;
  if (row >= rows) return;
  const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
  const float* orow = sm.o + row * kLdf + c0;
#pragma unroll
  for (int c = 0; c < kHeadDim / 2; c += 8) {
    float vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = orow[c + j] * inv;
    *reinterpret_cast<uint4*>(out + row * ld + c0 + c) = f32_to_bf16x8(vals);
  }
}

}  // namespace avatar_attn
