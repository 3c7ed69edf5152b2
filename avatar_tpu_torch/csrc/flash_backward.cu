// Head-major flash attention backward: q/dO/dQ [B, H, Lq, d], k/v/dK/dV
// [B, H, Lk, d], optional [B, Lk] f32 keep-mask (> 0.5 keeps), lse and
// delta [B, H, Lq] f32. Built per element type and padded head dim
// (attention_bwd_tile.cuh): bf16 or f32, any d % 8 == 0 up to 512.
//
// Replaces the two TPU kernels that `_flash_backward`
// (avatar_tpu/ops/flash_attention.py:1106) launches:
// - flash_bwd_dkv_<type>: `_bwd_dkv_kernel` (:996, `_nomask` :1052). For one
//   tile of keys, over every query tile: s = q k^T * scale in f32, masked
//   keys at -1e30 before the exp, p = exp(s - lse), dV += bf16(p)^T dO,
//   dP = dO v^T, dS = p (dP - delta) scale, dK += bf16(dS)^T q.
// - flash_bwd_dq_<type>: `_bwd_dq_kernel` (:1058, `_nomask` :1100). For one
//   tile of queries, over every key tile: the same s, p, dP and dS, and
//   dQ += bf16(dS) k.
// lse is the forward kernels' (`flash_forward.cu`): 1e30 for a row with no
// kept key, which makes p = 0 and the row's gradients 0. delta =
// rowsum(dO * O) is one reduction outside the kernels, as on the TPU. The
// sums run in f32 and the outputs are written in the input type; p and dS
// are rounded to it before their products, as the TPU kernels round them (a
// no-op in f32). Lengths need not be multiples of the tiles: rows past the
// end are zero-filled and get p = 0 (the TPU pads to its 512-row blocks
// instead).
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): at the training
// shape [8, 32, 480, 64] one product of the attention is
// 2 * 8 * 32 * 480^2 * 64 = 7.55 GFLOP; dK/dV takes four (s, dP, dV, dK:
// 30.2 GFLOP, 30.5 us) and dQ three (s, dP, dQ: 22.6 GFLOP, 22.9 us), while
// each kernel moves 8-16 MB (3-5 us): both are bound by operations.
//
// Design: the TPU grid walks the inner tile axis in order and carries the
// f32 accumulators in VMEM scratch. Here one block of kOwn / 16 warps owns
// one (batch, head, kOwn-row tile) and loops over the other axis itself, so
// blocks share nothing and need no atomics. Each warp owns 16 rows of the
// block's tile and computes its rows of s (or s^T) and dP (or dP^T) for the
// walked tile with WMMA (f32 out) into shared memory, forms p and dS there,
// and accumulates its 16 rows of dK and dV (or dQ) across the whole walk:
// in WMMA fragments in registers at head dim 64, in shared memory above. Every product
// a warp needs reads its own rows and the shared walked tile, so warps
// synchronise only around the tile loads. The walked tiles are re-read from
// L2 by every block of the head; wgmma, TMA and a register-resident softmax
// are later work.
#include "attention_bwd_tile.cuh"

namespace avatar_attn {

// p = exp(s * scale - lse) for a kept key, else 0, and
// dS = p * (dP - delta) * scale, rounded one f32 step at a time as the
// reference computes them (no fused multiply-add).
__device__ __forceinline__ void grad_logits(float s, float dp, float lse,
                                            float delta, bool kept, float scale,
                                            float& p, float& ds) {
  p = kept ? expf(__fsub_rn(__fmul_rn(s, scale), lse)) : 0.0f;
  ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Lq, int Lk, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int k0 = blockIdx.x * kOwn;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_rows = min(kOwn, Lk - k0);
  const T* q_head = q + bh * Lq * d;
  const T* do_head = dout + bh * Lq * d;

  load_tile<kOwn, kBwdThreads>(sm.own0, k + (bh * Lk + k0) * d, d, k_rows, d);
  load_tile<kOwn, kBwdThreads>(sm.own1, v + (bh * Lk + k0) * d, d, k_rows, d);
  load_keep<kOwn, kBwdThreads>(sm.keep, mask == nullptr ? nullptr : mask + (int64_t)blockIdx.z * Lk,
                  k0, k_rows);

  const int row0 = warp * 16;
  WarpAcc acc_dk, acc_dv;
  acc_dk.init(sm.acc0 + (kAccInSmem ? row0 * kLdo : 0), lane);
  acc_dv.init(sm.acc1 + (kAccInSmem ? row0 * kLdo : 0), lane);
  float* s_w = sm.s + row0 * kLdfB;
  float* dp_w = sm.dp + row0 * kLdfB;
  T* p_w = sm.p + row0 * kLdpB;
  T* ds_w = sm.ds + row0 * kLdpB;
  // lanes 2r and 2r+1 own key row r of the warp, kWalk / 2 query columns each
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kWalk / 2);

  for (int q0 = 0; q0 < Lq; q0 += kWalk) {
    const int q_rows = min(kWalk, Lq - q0);
    __syncthreads();
    load_tile<kWalk, kBwdThreads>(sm.walk0, q_head + (int64_t)q0 * d, d, q_rows, d);
    load_tile<kWalk, kBwdThreads>(sm.walk1, do_head + (int64_t)q0 * d, d, q_rows, d);
    load_rows<kWalk>(sm, lse + bh * Lq + q0, delta + bh * Lq + q0, q_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s^T = k q^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP^T = v dO^T
    __syncwarp();
    const bool kept = sm.keep[row0 + r] > 0.5f;
#pragma unroll 8
    for (int c = 0; c < kWalk / 2; ++c) {
      const int col = c0 + c;
      float p, ds;
      grad_logits(s_w[r * kLdfB + col], dp_w[r * kLdfB + col], sm.lse[col],
                  sm.delta[col], kept, scale, p, ds);
      p_w[r * kLdpB + col] = to_t(p);
      ds_w[r * kLdpB + col] = to_t(ds);
    }
    __syncwarp();
    acc_dv.add(p_w, sm.walk1);   // dV += p^T dO
    acc_dk.add(ds_w, sm.walk0);  // dK += dS^T q
  }
  acc_dk.store(s_w, warp, lane, dk + (bh * Lk + k0) * d, k_rows, d);
  acc_dv.store(dp_w, warp, lane, dv + (bh * Lk + k0) * d, k_rows, d);
}

__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq, int H,
                    int Lq, int Lk, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int q0 = blockIdx.x * kOwn;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kOwn, Lq - q0);
  const T* k_head = k + bh * Lk * d;
  const T* v_head = v + bh * Lk * d;
  const float* mask_row = mask == nullptr ? nullptr : mask + (int64_t)blockIdx.z * Lk;

  load_tile<kOwn, kBwdThreads>(sm.own0, q + (bh * Lq + q0) * d, d, q_rows, d);
  load_tile<kOwn, kBwdThreads>(sm.own1, dout + (bh * Lq + q0) * d, d, q_rows, d);
  load_rows<kOwn>(sm, lse + bh * Lq + q0, delta + bh * Lq + q0, q_rows);

  const int row0 = warp * 16;
  WarpAcc acc_dq;
  acc_dq.init(sm.acc0 + (kAccInSmem ? row0 * kLdo : 0), lane);
  float* s_w = sm.s + row0 * kLdfB;
  float* dp_w = sm.dp + row0 * kLdfB;
  T* ds_w = sm.ds + row0 * kLdpB;
  // lanes 2r and 2r+1 own query row r of the warp, kWalk / 2 key columns each
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kWalk / 2);
  __syncthreads();
  const float row_lse = sm.lse[row0 + r];
  const float row_delta = sm.delta[row0 + r];

  for (int k0 = 0; k0 < Lk; k0 += kWalk) {
    const int k_rows = min(kWalk, Lk - k0);
    __syncthreads();
    load_tile<kWalk, kBwdThreads>(sm.walk0, k_head + (int64_t)k0 * d, d, k_rows, d);
    load_tile<kWalk, kBwdThreads>(sm.walk1, v_head + (int64_t)k0 * d, d, k_rows, d);
    load_keep<kWalk, kBwdThreads>(sm.keep, mask_row, k0, k_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s = q k^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP = dO v^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < kWalk / 2; ++c) {
      const int col = c0 + c;
      float p, ds;
      grad_logits(s_w[r * kLdfB + col], dp_w[r * kLdfB + col], row_lse, row_delta,
                  sm.keep[col] > 0.5f, scale, p, ds);
      ds_w[r * kLdpB + col] = to_t(ds);
    }
    __syncwarp();
    acc_dq.add(ds_w, sm.walk0);  // dQ += dS k
  }
  acc_dq.store(s_w, warp, lane, dq + (bh * Lq + q0) * d, q_rows, d);
}

template <typename Kernel>
static int prepare(Kernel kernel, int d) {
  if (d % 8 != 0 || d > kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(BwdSmem)));
}

}  // namespace avatar_attn

// C entries for ctypes, named by type (flash_bwd_dkv_bf16, ..._f32). `mask`
// may be null (no mask). Each returns the cudaError_t of its launch
// (0 = success).
extern "C" int ATTN_ENTRY(flash_bwd_dkv)(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, const void* mask, void* dk,
                                         void* dv, int B, int H, int Lq, int Lk, int d,
                                         float scale, void* stream) {
  using namespace avatar_attn;
  int err = prepare(flash_bwd_dkv_kernel, d);
  if (err != 0) return err;
  dim3 grid((Lk + kOwn - 1) / kOwn, H, B);
  flash_bwd_dkv_kernel<<<grid, kBwdThreads, sizeof(BwdSmem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(mask),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, d, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ATTN_ENTRY(flash_bwd_dq)(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, const void* mask, void* dq,
                                        int B, int H, int Lq, int Lk, int d, float scale,
                                        void* stream) {
  using namespace avatar_attn;
  int err = prepare(flash_bwd_dq_kernel, d);
  if (err != 0) return err;
  dim3 grid((Lq + kOwn - 1) / kOwn, H, B);
  flash_bwd_dq_kernel<<<grid, kBwdThreads, sizeof(BwdSmem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(mask),
      static_cast<T*>(dq), H, Lq, Lk, d, scale);
  return static_cast<int>(cudaGetLastError());
}
