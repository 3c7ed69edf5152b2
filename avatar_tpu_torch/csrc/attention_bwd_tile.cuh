// Pieces shared by the head-major attention backward kernels
// (flash_backward.cu, flash_dense.cu): the shared-memory layout of one
// block, which owns a 64-row tile (keys for dK/dV, queries for dQ) and walks
// the other axis tile by tile, and the warp-level WMMA products on it. Each
// warp owns 16 rows of the block's tile; every product it needs reads its own
// rows and the shared walked tile.
#pragma once

#include "attention_tile.cuh"

namespace avatar_attn {

struct BwdSmem {
  __nv_bfloat16 own0[kTileQ * kLdh];   // dkv: k tile; dq: q tile
  __nv_bfloat16 own1[kTileQ * kLdh];   // dkv: v tile; dq: dO tile
  __nv_bfloat16 walk0[kTileK * kLdh];  // dkv: q tile; dq: k tile
  __nv_bfloat16 walk1[kTileK * kLdh];  // dkv: dO tile; dq: v tile
  __nv_bfloat16 p[kTileQ * kLdh];      // per warp: bf16 p^T (dkv)
  __nv_bfloat16 ds[kTileQ * kLdh];     // per warp: bf16 dS (dq) or dS^T (dkv)
  float s[kTileQ * kLdf];              // per warp: f32 logits
  float dp[kTileQ * kLdf];             // per warp: f32 dP
  float lse[kTileQ];                   // lse of the query rows in smem
  float delta[kTileQ];                 // delta of the same rows
  float keep[kTileK];                  // keep flags of the key rows in smem
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[16, 64] (f32, row stride kLdf) = A[16, 64] B[64, 64]^T, A this warp's
// rows and B a whole tile, both bf16 with row stride kLdh.
__device__ __forceinline__ void warp_nt(float* out, const __nv_bfloat16* a,
                                        const __nv_bfloat16* b) {
#pragma unroll
  for (int j = 0; j < kTileK / 16; ++j) {
    AccFrag acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLdh);
      wmma::load_matrix_sync(fb, b + j * 16 * kLdh + kk * 16, kLdh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, kLdf, wmma::mem_row_major);
  }
}

// acc[j] += A[16, 64] B[64, 64][:, 16j:16j+16], A this warp's bf16 rows and
// B a whole tile (rows = the summed axis), both with row stride kLdh.
__device__ __forceinline__ void warp_nn_acc(AccFrag* acc, const __nv_bfloat16* a,
                                            const __nv_bfloat16* b) {
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLdh);
      wmma::load_matrix_sync(fb, b + kk * 16 * kLdh + j * 16, kLdh);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Query-row statistics of a 64-row tile into shared memory. A row past the
// end gets lse = +inf, so its p is exp(-inf) = 0.
__device__ __forceinline__ void load_rows(BwdSmem& sm, const float* lse,
                                          const float* delta, int rows) {
  if (threadIdx.x < kTileQ) {
    const int r = threadIdx.x;
    sm.lse[r] = r < rows ? lse[r] : INFINITY;
    sm.delta[r] = r < rows ? delta[r] : 0.0f;
  }
}

// Write this warp's 16 rows of an accumulator (four fragments) as bf16,
// staged through the warp's f32 rows `stage` of shared memory.
__device__ __forceinline__ void store_acc(const AccFrag* acc, float* stage,
                                          int warp, int lane,
                                          __nv_bfloat16* out, int rows) {
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], kLdf, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kHeadDim / 2);
  const int row = warp * 16 + r;
  if (row < rows) {
#pragma unroll
    for (int c = 0; c < kHeadDim / 2; c += 8)
      *reinterpret_cast<uint4*>(out + (int64_t)row * kHeadDim + c0 + c) =
          f32_to_bf16x8(stage + r * kLdf + c0 + c);
  }
  __syncwarp();
}

}  // namespace avatar_attn
