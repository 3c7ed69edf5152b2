// Pieces shared by the head-major attention backward kernels
// (flash_backward.cu, flash_dense.cu): the shared-memory layout of one
// block, which owns a kOwn-row tile (keys for dK/dV, queries for dQ) and
// walks the other axis kWalk rows at a time, and the warp-level WMMA
// products on it. Each warp owns 16 rows of the block's tile; every product
// it needs reads its own rows and the shared walked tile. Built per element
// type and padded head dim, as attention_tile.cuh.
//
// Tile rows per variant, so that BwdSmem fits a block's 227 KB (the
// dense-bias kernels add a [kOwn, kWalk + 1] f32 bias tile). At head dim 64
// the dK/dV (dQ) accumulators live in WMMA fragments in registers (8
// floats per 16 x 16 block, 32 per accumulator); above it they would take
// 64 to 256 registers each, so they live in shared memory (f32, kOwn x
// kHeadDim each) and each product loads, accumulates and stores them:
//   bf16   d 64:  kOwn 64, kWalk 64, registers   (90 KB)
//   bf16   d 128: kOwn 64, kWalk 64, shared      (190 KB)
//   bf16   d 256: kOwn 32, kWalk 32, shared      (148 KB)
//   bf16   d 512: kOwn 16, kWalk 32, shared      (173 KB)
//   float  d 64:  kOwn 64, kWalk 64, registers   (139 KB)
//   float  d 128: kOwn 32, kWalk 32, shared      (120 KB)
//   float  d 256: kOwn 32, kWalk 16, shared      (177 KB)
//   float  d 512: kOwn 16, kWalk 16, shared      (203 KB)
#pragma once

#include "attention_tile.cuh"

namespace avatar_attn {

constexpr bool kAccInSmem = kHeadDim > 64;
constexpr int kOwn = kHeadDim == 512 ? 16 : ((kHeadDim == 64 || (!kF32 && kHeadDim == 128)) ? 64 : 32);
constexpr int kWalk = kHeadDim == 64 || (!kF32 && kHeadDim == 128) ? 64
                      : ((kF32 && kHeadDim >= 256) ? 16 : 32);
constexpr int kBwdThreads = kOwn / 16 * 32;
constexpr int kRowsMax = kOwn > kWalk ? kOwn : kWalk;
constexpr int kLdpB = kWalk + kPad;   // T row stride of p and dS
constexpr int kLdfB = kWalk + 4;      // f32 row stride of s and dP
constexpr int kAccSize = kAccInSmem ? kOwn * kLdo : 8;

struct BwdSmem {
  T own0[kOwn * kLdh];    // dkv: k tile; dq: q tile
  T own1[kOwn * kLdh];    // dkv: v tile; dq: dO tile
  T walk0[kWalk * kLdh];  // dkv: q tile; dq: k tile
  T walk1[kWalk * kLdh];  // dkv: dO tile; dq: v tile
  T p[kOwn * kLdpB];      // per warp: p^T (dkv)
  T ds[kOwn * kLdpB];     // per warp: dS (dq) or dS^T (dkv)
  float s[kOwn * kLdfB];  // per warp: f32 logits
  float dp[kOwn * kLdfB]; // per warp: f32 dP
  float acc0[kAccSize];   // kAccInSmem: dK (dkv) or dQ (dq), f32
  float acc1[kAccSize];   // kAccInSmem: dV (dkv)
  float lse[kRowsMax];    // lse of the query rows in smem
  float delta[kRowsMax];  // delta of the same rows
  float keep[kRowsMax];   // keep flags of the key rows in smem
};

// out[16, kWalk] (f32, row stride kLdfB) = A[16, kHeadDim] B[kWalk,
// kHeadDim]^T, A this warp's rows and B a whole walked tile, both with row
// stride kLdh.
__device__ __forceinline__ void warp_nt(float* out, const T* a, const T* b) {
#pragma unroll
  for (int j = 0; j < kWalk / 16; ++j) {
    AccFrag acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / kK; ++kk)
      mma_step<FragBCol>(acc, a + kk * kK, kLdh, b + j * 16 * kLdh + kk * kK, kLdh);
    wmma::store_matrix_sync(out + j * 16, acc, kLdfB, wmma::mem_row_major);
  }
}

// One warp's 16 rows of a [kOwn, kHeadDim] f32 accumulator: WMMA
// fragments in registers, or (kAccInSmem) the warp's rows of a shared
// array.
struct WarpAcc {
  AccFrag f[kAccInSmem ? 1 : kHeadDim / 16];
  float* rows;  // kAccInSmem: the warp's first row, row stride kLdo

  __device__ __forceinline__ void init(float* smem_rows, int lane) {
    rows = smem_rows;
    if (kAccInSmem) {
      for (int i = lane; i < 16 * kLdo; i += 32) rows[i] = 0.0f;
      __syncwarp();
    } else {
#pragma unroll
      for (int j = 0; j < (kAccInSmem ? 1 : kHeadDim / 16); ++j)
        wmma::fill_fragment(f[j], 0.0f);
    }
  }

  // += A[16, kWalk] B[kWalk, kHeadDim], A this warp's rows (row stride
  // kLdpB) and B a whole walked tile (rows = the summed axis, stride kLdh).
  __device__ __forceinline__ void add(const T* a, const T* b) {
#pragma unroll
    for (int j = 0; j < kHeadDim / 16; ++j) {
      AccFrag& acc = f[kAccInSmem ? 0 : j];
      if (kAccInSmem)
        wmma::load_matrix_sync(acc, rows + j * 16, kLdo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kWalk / kK; ++kk)
        mma_step<FragBRow>(acc, a + kk * kK, kLdpB, b + kk * kK * kLdh + j * 16, kLdh);
      if (kAccInSmem)
        wmma::store_matrix_sync(rows + j * 16, acc, kLdo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Write the warp's rows (the first d columns) in T to the tile `out`
  // (row stride d), rows from `rows_valid` on skipped; register fragments
  // are staged through the warp's f32 rows `stage` (row stride kLdfB, at
  // least kHeadDim wide when the fragments are used).
  __device__ __forceinline__ void store(float* stage, int warp, int lane, T* out,
                                        int rows_valid, int d) {
    const float* src = rows;
    int lds = kLdo;
    if (!kAccInSmem) {
#pragma unroll
      for (int j = 0; j < (kAccInSmem ? 1 : kHeadDim / 16); ++j)
        wmma::store_matrix_sync(stage + j * 16, f[j], kLdfB, wmma::mem_row_major);
      src = stage;
      lds = kLdfB;
    }
    __syncwarp();
    const int r = lane >> 1;
    const int row = warp * 16 + r;
    if (row < rows_valid) {
#pragma unroll
      for (int c = (lane & 1) * 8; c < kHeadDim; c += 16) {
        if (c >= d) break;
        store8(out + (int64_t)row * d + c, src + r * lds + c);
      }
    }
    __syncwarp();
  }
};
static_assert(kAccInSmem || kLdfB >= kHeadDim, "register accumulators stage through s");

// Query-row statistics of a kRows-row tile into shared memory. A row past
// the end gets lse = +inf, so its p is exp(-inf) = 0.
template <int kRows>
__device__ __forceinline__ void load_rows(BwdSmem& sm, const float* lse,
                                          const float* delta, int rows) {
  for (int r = threadIdx.x; r < kRows; r += kBwdThreads) {
    sm.lse[r] = r < rows ? lse[r] : INFINITY;
    sm.delta[r] = r < rows ? delta[r] : 0.0f;
  }
}

}  // namespace avatar_attn
