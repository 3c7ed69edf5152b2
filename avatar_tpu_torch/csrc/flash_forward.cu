// Head-major flash attention forward with the row log-sum-exp: q/o
// [B, H, Lq, d], k/v [B, H, Lk, d] contiguous, optional [B, Lk] f32
// keep-mask (> 0.5 keeps), lse [B, H, Lq] f32. Built per element type and
// padded head dim (attention_tile.cuh): bf16 or f32, any d % 8 == 0 up to
// 512. At bf16 and d = 64 or 128 all three modes run the Hopper kernel of
// flash_forward_sm90.cu instead; these entries serve every other (type,
// head dim).
//
// Replaces the three TPU kernels that `_flash_forward`
// (avatar_tpu/ops/flash_attention.py:452) launches:
// - flash_bounded_<type>: `_fwd_kernel_bounded` (:241, `_nomask` :310).
//   Max-free softmax for qk-normed logits, p = exp(min(s, 80)), masked
//   keys p = 0, lse = log l. The long-sequence self-attention of the DiT
//   (512 px, 161 frames: 5376 tokens).
// - flash_online_<type>: `_fwd_kernel` (:140, `_nomask` :228). Online
//   softmax with a running max, lse = m + log l. The same path for a
//   checkpoint without q/k norm.
// - flash_single_<type>: `_fwd_kernel_single` (:387, `_nomask` :419).
//   Whole-row softmax (the max over every key first, then exp and sum, no
//   rescale), lse = m + log l; taken when both lengths fit one TPU block
//   (at most 1024 after rounding up to 128).
// In all three a row with no kept key returns O = 0 and lse = 1e30, and
// the lengths need not be multiples of the 64-row tile: the ragged edge is
// masked here. As on the TPU (`fuse_l = d < 128`), the bounded and online
// kernels sum the p rounded to the value type (the values the PV product
// uses) into l where d < 128, and the f32 p at d >= 128; the whole-row
// kernel sums the f32 p.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): self-attention
// over 5376 tokens x 32 heads does 4 * 5376^2 * 2048 = 236.8 GFLOP
// (239 us) and must move 88.8 MB (q, k, v, o once each and the lse; 27 us),
// so it is bound by operations.
//
// Design: the TPU kernels walk a sequential kv grid axis and carry m, l and
// the accumulator in VMEM scratch from step to step. Here one block owns
// (batch, head, 64 query rows) and loops over the head's keys in 64-row
// tiles itself; blocks share nothing. A head's 84 query tiles re-read the
// same 1.4 MB of k/v, which stays in L2. The products run on the tensor
// cores through WMMA with logits and accumulator in shared memory
// (attention_tile.cuh); that shared-memory traffic, not the tensor cores,
// sets the time (the register-resident wgmma version for bf16 at d = 64
// and 128 is flash_forward_sm90.cu). The
// whole-row kernel cannot hold a 64 x 1024 f32 logits tile (256 KB) in a
// block's 227 KB, so it makes two passes over the key tiles: the first
// computes S = Q K^T for the row max alone, the second recomputes S and
// does exp, sum and PV against that fixed max.
#include "attention_tile.cuh"

namespace avatar_attn {

constexpr int kModeBounded = 0;
constexpr int kModeOnline = 1;
constexpr int kModeSingle = 2;
constexpr float kLseMasked = 1e30f;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse,
                     int H, int Lq, int Lk, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int q0 = blockIdx.x * kTileQ;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kTileQ, Lq - q0);
  const T* k_head = k + bh * Lk * d;
  const T* v_head = v + bh * Lk * d;
  const float* mask_row =
      mask == nullptr ? nullptr : mask + (int64_t)blockIdx.z * Lk;
  const bool sum_rounded = kMode != kModeSingle && d < 128;

  load_tile<kTileQ>(sm.q, q + (bh * Lq + q0) * d, d, q_rows, d);
  for (int i = threadIdx.x; i < kTileQ * kLdo; i += kThreads) sm.o[i] = 0.0f;

  float m = -INFINITY, l = 0.0f;
  if constexpr (kMode == kModeSingle) {
    for (int k0 = 0; k0 < Lk; k0 += kTileK) {
      const int rows = min(kTileK, Lk - k0);
      __syncthreads();
      load_tile<kTileK>(sm.k, k_head + (int64_t)k0 * d, d, rows, d);
      load_keep<kTileK>(sm.keep, mask_row, k0, rows);
      __syncthreads();
      row_max_tile(sm, warp, lane, scale, m);
    }
  }
  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int rows = min(kTileK, Lk - k0);
    __syncthreads();
    load_tile<kTileK>(sm.k, k_head + (int64_t)k0 * d, d, rows, d);
    load_tile<kTileK>(sm.v, v_head + (int64_t)k0 * d, d, rows, d);
    load_keep<kTileK>(sm.keep, mask_row, k0, rows);
    __syncthreads();
    if constexpr (kMode == kModeBounded) {
      attend_tile<true, false>(sm, warp, lane, scale, m, l, sum_rounded);
    } else if constexpr (kMode == kModeOnline) {
      attend_tile<false, false>(sm, warp, lane, scale, m, l, sum_rounded);
    } else {
      attend_tile<false, true>(sm, warp, lane, scale, m, l, false);
    }
  }
  store_rows(sm, warp, lane, l, out + (bh * Lq + q0) * d, d, q_rows, d);
  const int row = warp * 16 + (lane >> 1);
  if ((lane & 1) == 0 && row < q_rows) {
    float val = kLseMasked;
    if (l != 0.0f) val = (kMode == kModeBounded ? 0.0f : m) + logf(l);
    lse[bh * Lq + q0 + row] = val;
  }
}

template <int kMode>
static int launch(const void* q, const void* k, const void* v,
                  const void* mask, void* out, void* lse, int B, int H,
                  int Lq, int Lk, int d, float scale, void* stream) {
  if (d % 8 != 0 || d > kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_forward_kernel<kMode>;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + kTileQ - 1) / kTileQ, H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse),
      H, Lq, Lk, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace avatar_attn

// C entries for ctypes, named by type (flash_bounded_bf16, ..._f32).
// `mask` may be null (no mask). Each returns the cudaError_t of its launch
// (0 = success).
extern "C" int ATTN_ENTRY(flash_bounded)(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, void* lse,
                                         int B, int H, int Lq, int Lk, int d,
                                         float scale, void* stream) {
  return avatar_attn::launch<avatar_attn::kModeBounded>(
      q, k, v, mask, out, lse, B, H, Lq, Lk, d, scale, stream);
}

extern "C" int ATTN_ENTRY(flash_online)(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, void* lse,
                                        int B, int H, int Lq, int Lk, int d,
                                        float scale, void* stream) {
  return avatar_attn::launch<avatar_attn::kModeOnline>(
      q, k, v, mask, out, lse, B, H, Lq, Lk, d, scale, stream);
}

extern "C" int ATTN_ENTRY(flash_single)(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, void* lse,
                                        int B, int H, int Lq, int Lk, int d,
                                        float scale, void* stream) {
  return avatar_attn::launch<avatar_attn::kModeSingle>(
      q, k, v, mask, out, lse, B, H, Lq, Lk, d, scale, stream);
}
