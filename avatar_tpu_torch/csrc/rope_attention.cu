// Self-attention with split-half RoPE applied in-kernel. Built per element
// type and padded head dim (attention_tile.cuh): bf16 or f32, any head dim
// d % 16 == 0 up to 256, as the reference's `rope_fused_supports`. At bf16
// and d = 64 or 128 the Hopper kernel of rope_attention_sm90.cu runs
// instead; this one serves every other (type, head dim).
//
// Replaces the TPU kernel `_rope_token_kernel`
// (avatar_tpu/ops/flash_attention.py:729, launched by `_rope_fused_impl`
// through `rope_fused_attention`). q/k arrive [B, L, C] in global split-half
// channel order: head h reads its halves at columns [h*d/2, (h+1)*d/2) and
// [C/2 + h*d/2, ...), and cos/sin [B, L, C/2] at [l, h*d/2 + i]. v and the
// output are token-major with head h at columns [h*d, (h+1)*d).
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): at the DiT's
// 1 x 832 tokens x 32 heads it does 4*832^2*2048 = 5.67 GFLOP and must move
// 17.0 MB (q, k, v, o, cos, sin once each): 5.7 us of tensor-core time
// against 5.1 us of memory time, so it is bound by operations.
//
// Design: one block per (batch, head, 64 query rows), 416 blocks at the
// main shape, about three resident per SM. The rotation is fused into the
// shared-memory loads of the q tile and of each k tile, so no rotated copy
// of q/k ever reaches device memory. The products run on the tensor cores
// through WMMA; the logits never leave shared memory. Each block re-reads
// the head's k/v (13 tiles), which the 50 MB L2 absorbs. The wgmma / TMA
// version with a register-resident accumulator is rope_attention_sm90.cu.
#include "attention_tile.cuh"

namespace avatar_attn {

template <bool kBounded>
__global__ void __launch_bounds__(kThreads)
rope_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ cos_s,
                      const T* __restrict__ sin_s, T* __restrict__ out, int L,
                      int H, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t C = (int64_t)H * d;
  const int half = H * (d / 2);
  const int64_t tok = (int64_t)b * L;
  const int64_t hcol = (int64_t)h * (d / 2);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_rope_tile<kTileQ>(sm.q, q + (tok + q0) * C + hcol,
                         cos_s + (tok + q0) * half + hcol,
                         sin_s + (tok + q0) * half + hcol, C, half,
                         min(kTileQ, L - q0), d);
  for (int i = threadIdx.x; i < kTileQ * kLdo; i += kThreads) sm.o[i] = 0.0f;

  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < L; k0 += kTileK) {
    const int rows = min(kTileK, L - k0);
    __syncthreads();
    load_rope_tile<kTileK>(sm.k, k + (tok + k0) * C + hcol,
                           cos_s + (tok + k0) * half + hcol,
                           sin_s + (tok + k0) * half + hcol, C, half, rows, d);
    load_tile<kTileK>(sm.v, v + (tok + k0) * C + (int64_t)h * d, C, rows, d);
    load_keep<kTileK>(sm.keep, nullptr, k0, rows);
    __syncthreads();
    attend_tile<kBounded>(sm, warp, lane, scale, m, l);
  }
  store_rows(sm, warp, lane, l, out + (tok + q0) * C + (int64_t)h * d, C,
             min(kTileQ, L - q0), d);
}

template <bool kBounded>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* cos_s, const void* sin_s, void* out,
                          int B, int L, int H, int d, float scale,
                          cudaStream_t stream) {
  if (d % 16 != 0 || d > kHeadDim) return cudaErrorInvalidValue;
  auto kernel = rope_attention_kernel<kBounded>;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kTileQ - 1) / kTileQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(cos_s), static_cast<const T*>(sin_s), static_cast<T*>(out),
      L, H, d, scale);
  return cudaGetLastError();
}

}  // namespace avatar_attn

// C entry for ctypes (rope_attention_bf16 or _f32). Returns the cudaError_t
// of the launch (0 = success).
extern "C" int ATTN_ENTRY(rope_attention)(const void* q, const void* k, const void* v,
                                          const void* cos_s, const void* sin_s,
                                          void* out, int B, int L, int H, int d,
                                          float scale, int bounded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bounded ? avatar_attn::launch<true>(q, k, v, cos_s, sin_s, out, B, L, H, d, scale, s)
              : avatar_attn::launch<false>(q, k, v, cos_s, sin_s, out, B, L, H, d, scale, s);
  return static_cast<int>(err);
}
