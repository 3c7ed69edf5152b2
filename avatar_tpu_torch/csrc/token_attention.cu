// Token-major attention with an optional [B, Lk] keep-mask. Built per
// element type and padded head dim (attention_tile.cuh): bf16 or f32, any
// head dim d % 8 == 0 up to 256, as the reference's `fused_supports`.
//
// Replaces the TPU kernel `_token_major_kernel` (and its `_nomask`
// variant, avatar_tpu/ops/flash_attention.py:611/653, launched by
// `_fused_fwd_impl` through `fused_token_attention`). q/o are [B, Lq, C],
// k/v [B, Lk, C], head h at columns [h*d, (h+1)*d). Masked keys get
// p = 0 and a row whose keys are all masked returns 0. Lk need not be a
// multiple of the 64-key tile: the ragged edge is masked.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): the DiT's
// cross-attention, 832 queries x 256 caption keys x 32 heads, does
// 4*832*256*2048 = 1.74 GFLOP (1.8 us) and must move 8.9 MB (q, o, k, v
// once each; 2.7 us), so it is bound by memory.
//
// Design: one block per (batch, head, 64 query rows). Each block reads its
// q tile once and streams the head's k/v in 64-key tiles through shared
// memory; the 13 query tiles of a head re-read the same 64 KB of k/v, which
// stays in L2, so device-memory traffic stays near the one-pass minimum.
// Products on the tensor cores through WMMA, logits kept in shared memory.
#include "attention_tile.cuh"

namespace avatar_attn {

template <bool kBounded>
__global__ void __launch_bounds__(kThreads)
token_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ mask,
                       T* __restrict__ out, int Lq, int Lk, int H, int d,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t C = (int64_t)H * d;
  const int64_t hcol = (int64_t)h * d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<kTileQ>(sm.q, q + ((int64_t)b * Lq + q0) * C + hcol, C,
                    min(kTileQ, Lq - q0), d);
  for (int i = threadIdx.x; i < kTileQ * kLdo; i += kThreads) sm.o[i] = 0.0f;

  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int rows = min(kTileK, Lk - k0);
    __syncthreads();
    load_tile<kTileK>(sm.k, k + ((int64_t)b * Lk + k0) * C + hcol, C, rows, d);
    load_tile<kTileK>(sm.v, v + ((int64_t)b * Lk + k0) * C + hcol, C, rows, d);
    load_keep<kTileK>(sm.keep, mask == nullptr ? nullptr : mask + (int64_t)b * Lk,
                      k0, rows);
    __syncthreads();
    attend_tile<kBounded>(sm, warp, lane, scale, m, l);
  }
  store_rows(sm, warp, lane, l, out + ((int64_t)b * Lq + q0) * C + hcol, C,
             min(kTileQ, Lq - q0), d);
}

template <bool kBounded>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* mask, void* out, int B, int Lq, int Lk,
                          int H, int d, float scale, cudaStream_t stream) {
  if (d % 8 != 0 || d > kHeadDim) return cudaErrorInvalidValue;
  auto kernel = token_attention_kernel<kBounded>;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kTileQ - 1) / kTileQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), Lq, Lk, H, d, scale);
  return cudaGetLastError();
}

}  // namespace avatar_attn

// C entry for ctypes (token_attention_bf16 or _f32). `mask` may be null (no
// mask). Returns the cudaError_t of the launch (0 = success).
extern "C" int ATTN_ENTRY(token_attention)(const void* q, const void* k, const void* v,
                                           const void* mask, void* out, int B, int Lq,
                                           int Lk, int H, int d, float scale,
                                           int bounded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bounded ? avatar_attn::launch<true>(q, k, v, mask, out, B, Lq, Lk, H, d, scale, s)
              : avatar_attn::launch<false>(q, k, v, mask, out, B, Lq, Lk, H, d, scale, s);
  return static_cast<int>(err);
}
