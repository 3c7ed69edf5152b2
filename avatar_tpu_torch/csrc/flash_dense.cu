// Head-major flash attention with a dense additive bias, forward and
// backward, bf16, head_dim 64: q/o/dO/dQ [B, H, Lq, 64], k/v/dK/dV
// [B, H, Lk, 64], bias [Bb, Lq, Lk] f32 with Bb = B*H (one slab per head) or
// Bb = B (one slab shared by the H heads of a sample): head bh = b*H + h
// reads slab bh / heads_group, heads_group = B*H / Bb. lse and delta
// [B, H, Lq] f32, dBias [Bb, Lq, Lk] f32.
//
// Replaces the four TPU kernels of the dense-bias path
// (avatar_tpu/ops/flash_attention.py):
// - flash_dense_fwd_bf16: `_fwd_kernel_dense_bias` (:317, launched by
//   `_flash_dense_forward` :1287). s = fl(fl(q k^T) scale) + bias in f32,
//   online softmax with a running max that starts at -1e30; an entry with
//   s <= -5e29 counts as masked and gets p = 0 explicitly (a key tile whose
//   entries all sit near -1e30 would otherwise give exp(0) = 1); p rounded
//   to bf16 for the PV product, l summed from the f32 p. A row with l = 0
//   returns O = 0 and lse = 1e30.
// - flash_dense_bwd_dkv_bf16: `_bwd_dkv_kernel_bias` (:1328, :1471). For one
//   tile of keys, over every query tile: p = exp(s - lse), dV += bf16(p)^T
//   dO, dP = dO v^T, dS = p (dP - delta) scale, dK += bf16(dS)^T q.
// - flash_dense_bwd_dq_bf16: `_bwd_dq_kernel_bias` (:1367, :1513). For one
//   tile of queries, over every key tile: dQ += bf16(dS) k.
// - flash_dense_bwd_db_bf16: `_bwd_db_kernel` (:1397, :1545). For one
//   (slab, query tile, key tile), over the heads_group heads of the slab in
//   order: dBias += p (dP - delta), with no scale, in f32; written once.
// delta = rowsum(dO * O) is one reduction outside the kernels, as on the
// TPU. Each f32 step of s, p and dS is rounded on its own (no fused
// multiply-add), as the reference computes them. The TPU pads q rows with 0
// and key columns with a bias of -1e30; here the ragged edges are bounds
// checks: keys past the end get p = 0, query rows past the end get lse =
// +inf (p = 0) and are not written.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s), each input read
// once and each output written once:
// - T5-XXL's attention, [2, 64, 256, 64] with a per-head bias [2, 64, 256,
//   256] (33.6 MB f32): every kernel is bound by the bias's bytes (the
//   forward reads it, dBias writes as many again): 15-25 us.
// - the DiT's long self-attention, [1, 32, 5376, 64] with one shared bias
//   [1, 1, 5376, 5376] (115.6 MB): bound by operations, 236.8 GFLOP for the
//   forward (239 us), 4 products for dK/dV (479 us), 3 for dQ (359 us), 2
//   for dBias (239 us).
//
// Design: the designs of flash_forward.cu and flash_backward.cu with a
// bias tile beside the walked tile. One block of 4 warps owns a 64-row tile
// of one head (of one slab for dBias) and walks the other axis in 64-row
// tiles; each warp owns 16 rows. Every walked step loads the f32 bias tile
// [64 x 64] into shared memory with coalesced reads (transposed for dK/dV,
// whose warps own key rows), and the softmax pass adds it to the logits
// there. No atomics: dBias of a shared slab sums its heads inside one block.
// A shared slab is re-read once for every head (32 x 115.6 MB at the long
// shape, mostly from L2 by the blocks of one query tile); one block per
// slab across heads, wgmma and TMA are later work.
#include "attention_bwd_tile.cuh"

namespace avatar_attn {

constexpr float kNegInf = -1e30f;       // NEG_INF: the running max's start
constexpr float kMaskedAt = -5e29f;     // NEG_INF / 2: s at or below is masked
constexpr float kLseMasked = 1e30f;     // lse of a row with no kept entry
constexpr int kLdb = kTileK + 1;        // f32 row stride of a bias tile

struct DenseSmem {
  Smem base;                   // q, k, v, p, s, o and keep (attention_tile.cuh)
  float bias[kTileQ * kLdb];   // [query row][key column]
};

struct DenseBwdSmem {
  BwdSmem base;                // attention_bwd_tile.cuh
  float bias[kTileQ * kLdb];   // [own row][walked column]
};

// Bias tile of one slab (row stride ld) at the caller's (q0, k0) into dst,
// [query][key] or, kTransposed, [key][query]; entries past the rows or
// columns read -1e30. Global reads run along the key axis, 32 neighbouring
// threads on neighbouring addresses.
template <bool kTransposed>
__device__ __forceinline__ void load_bias_tile(float* dst, const float* src,
                                               int64_t ld, int q_rows, int k_rows) {
  for (int i = threadIdx.x; i < kTileQ * kTileK; i += kThreads) {
    const int qr = i / kTileK;
    const int kc = i % kTileK;
    const float val = (qr < q_rows && kc < k_rows) ? src[qr * ld + kc] : kNegInf;
    dst[kTransposed ? kc * kLdb + qr : qr * kLdb + kc] = val;
  }
}

// s = fl(fl(raw * scale) + bias), one rounding per step.
__device__ __forceinline__ float biased_logit(float raw, float scale, float bias) {
  return __fadd_rn(__fmul_rn(raw, scale), bias);
}

// p = exp(s - lse) for a key inside the tile, else 0; dsr = p (dP - delta).
__device__ __forceinline__ void dense_grad(float s, float dp, float lse, float delta,
                                           bool inside, float& p, float& dsr) {
  p = inside ? expf(__fsub_rn(s, lse)) : 0.0f;
  dsr = __fmul_rn(p, __fsub_rn(dp, delta));
}

// One kv tile for this warp's 16 query rows: S = Q K^T, the bias added,
// online softmax update, O += P V. Lanes 2r and 2r+1 own row r, 32 key
// columns each; `m` and `l` are that row's running max and sum.
__device__ __forceinline__ void dense_attend_tile(DenseSmem& sm, int warp, int lane,
                                                  float scale, float& m, float& l) {
  Smem& b = sm.base;
  const int row0 = warp * 16;
  logits_tile(b, warp);
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kTileK / 2);
  float* srow = b.s + (row0 + r) * kLdf + c0;
  const float* brow = sm.bias + (row0 + r) * kLdb + c0;
  const float* keep = b.keep + c0;
  float mx = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < kTileK / 2; ++c) {
    const float sv = biased_logit(srow[c], scale, brow[c]);
    srow[c] = sv;
    if (keep[c] > -0.5f) mx = fmaxf(mx, sv);  // keys past the end take no part
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m, mx);
  const float alpha = expf(m - m_new);
  m = m_new;
  float psum = 0.0f;
  __nv_bfloat16* prow = b.p + (row0 + r) * kLdh + c0;
#pragma unroll 8
  for (int c = 0; c < kTileK / 2; ++c) {
    const float sv = srow[c];
    const float p = (keep[c] > -0.5f && sv > kMaskedAt) ? expf(sv - m) : 0.0f;
    psum += p;
    prow[c] = __float2bfloat16_rn(p);
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  l = l * alpha + psum;
  float* orow = b.o + (row0 + r) * kLdf + c0;
#pragma unroll 8
  for (int c = 0; c < kHeadDim / 2; ++c) orow[c] *= alpha;
  __syncwarp();
  pv_accumulate(b, warp);
}

__global__ void __launch_bounds__(kThreads)
flash_dense_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                       int H, int Lq, int Lk, int heads_group, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseSmem& sm = *reinterpret_cast<DenseSmem*>(smem_raw);
  Smem& b = sm.base;
  const int q0 = blockIdx.x * kTileQ;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kTileQ, Lq - q0);
  const __nv_bfloat16* k_head = k + bh * Lk * kHeadDim;
  const __nv_bfloat16* v_head = v + bh * Lk * kHeadDim;
  const float* bias_rows = bias + ((bh / heads_group) * Lq + q0) * (int64_t)Lk;

  load_tile(b.q, q + (bh * Lq + q0) * kHeadDim, kHeadDim, q_rows);
  for (int i = threadIdx.x; i < kTileQ * kLdf; i += kThreads) b.o[i] = 0.0f;

  float m = kNegInf, l = 0.0f;
  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int rows = min(kTileK, Lk - k0);
    __syncthreads();
    load_tile(b.k, k_head + (int64_t)k0 * kHeadDim, kHeadDim, rows);
    load_tile(b.v, v_head + (int64_t)k0 * kHeadDim, kHeadDim, rows);
    load_keep(b.keep, nullptr, k0, rows);
    load_bias_tile<false>(sm.bias, bias_rows + k0, Lk, q_rows, rows);
    __syncthreads();
    dense_attend_tile(sm, warp, lane, scale, m, l);
  }
  store_rows(b, warp, lane, l, out + (bh * Lq + q0) * kHeadDim, kHeadDim, q_rows);
  const int row = warp * 16 + (lane >> 1);
  if ((lane & 1) == 0 && row < q_rows)
    lse[bh * Lq + q0 + row] = l == 0.0f ? kLseMasked : m + logf(l);
}

__global__ void __launch_bounds__(kThreads)
flash_dense_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                           int heads_group, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseBwdSmem& dsm = *reinterpret_cast<DenseBwdSmem*>(smem_raw);
  BwdSmem& sm = dsm.base;
  const int k0 = blockIdx.x * kTileK;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_rows = min(kTileK, Lk - k0);
  const __nv_bfloat16* q_head = q + bh * Lq * kHeadDim;
  const __nv_bfloat16* do_head = dout + bh * Lq * kHeadDim;
  const float* bias_slab = bias + (bh / heads_group) * (int64_t)Lq * Lk + k0;

  load_tile(sm.own0, k + (bh * Lk + k0) * kHeadDim, kHeadDim, k_rows);
  load_tile(sm.own1, v + (bh * Lk + k0) * kHeadDim, kHeadDim, k_rows);

  AccFrag acc_dk[kHeadDim / 16], acc_dv[kHeadDim / 16];
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.0f);
    wmma::fill_fragment(acc_dv[j], 0.0f);
  }
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdf;
  float* dp_w = sm.dp + row0 * kLdf;
  __nv_bfloat16* p_w = sm.p + row0 * kLdh;
  __nv_bfloat16* ds_w = sm.ds + row0 * kLdh;
  // lanes 2r and 2r+1 own key row r of the warp, 32 query columns each
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kTileQ / 2);
  const bool inside = row0 + r < k_rows;
  const float* brow = dsm.bias + (row0 + r) * kLdb;

  for (int q0 = 0; q0 < Lq; q0 += kTileQ) {
    const int q_rows = min(kTileQ, Lq - q0);
    __syncthreads();
    load_tile(sm.walk0, q_head + (int64_t)q0 * kHeadDim, kHeadDim, q_rows);
    load_tile(sm.walk1, do_head + (int64_t)q0 * kHeadDim, kHeadDim, q_rows);
    load_rows(sm, lse + bh * Lq + q0, delta + bh * Lq + q0, q_rows);
    load_bias_tile<true>(dsm.bias, bias_slab + (int64_t)q0 * Lk, Lk, q_rows, k_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s^T = k q^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP^T = v dO^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < kTileQ / 2; ++c) {
      const int col = c0 + c;
      float p, dsr;
      dense_grad(biased_logit(s_w[r * kLdf + col], scale, brow[col]),
                 dp_w[r * kLdf + col], sm.lse[col], sm.delta[col], inside, p, dsr);
      p_w[r * kLdh + col] = __float2bfloat16_rn(p);
      ds_w[r * kLdh + col] = __float2bfloat16_rn(__fmul_rn(dsr, scale));
    }
    __syncwarp();
    warp_nn_acc(acc_dv, p_w, sm.walk1);   // dV += p^T dO
    warp_nn_acc(acc_dk, ds_w, sm.walk0);  // dK += dS^T q
  }
  store_acc(acc_dk, s_w, warp, lane, dk + (bh * Lk + k0) * kHeadDim, k_rows);
  store_acc(acc_dv, dp_w, warp, lane, dv + (bh * Lk + k0) * kHeadDim, k_rows);
}

__global__ void __launch_bounds__(kThreads)
flash_dense_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ dq,
                          int H, int Lq, int Lk, int heads_group, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseBwdSmem& dsm = *reinterpret_cast<DenseBwdSmem*>(smem_raw);
  BwdSmem& sm = dsm.base;
  const int q0 = blockIdx.x * kTileQ;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kTileQ, Lq - q0);
  const __nv_bfloat16* k_head = k + bh * Lk * kHeadDim;
  const __nv_bfloat16* v_head = v + bh * Lk * kHeadDim;
  const float* bias_rows = bias + ((bh / heads_group) * Lq + q0) * (int64_t)Lk;

  load_tile(sm.own0, q + (bh * Lq + q0) * kHeadDim, kHeadDim, q_rows);
  load_tile(sm.own1, dout + (bh * Lq + q0) * kHeadDim, kHeadDim, q_rows);
  load_rows(sm, lse + bh * Lq + q0, delta + bh * Lq + q0, q_rows);

  AccFrag acc_dq[kHeadDim / 16];
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) wmma::fill_fragment(acc_dq[j], 0.0f);
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdf;
  float* dp_w = sm.dp + row0 * kLdf;
  __nv_bfloat16* ds_w = sm.ds + row0 * kLdh;
  // lanes 2r and 2r+1 own query row r of the warp, 32 key columns each
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kTileK / 2);
  const float* brow = dsm.bias + (row0 + r) * kLdb;
  __syncthreads();
  const float row_lse = sm.lse[row0 + r];
  const float row_delta = sm.delta[row0 + r];

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int k_rows = min(kTileK, Lk - k0);
    __syncthreads();
    load_tile(sm.walk0, k_head + (int64_t)k0 * kHeadDim, kHeadDim, k_rows);
    load_tile(sm.walk1, v_head + (int64_t)k0 * kHeadDim, kHeadDim, k_rows);
    load_bias_tile<false>(dsm.bias, bias_rows + k0, Lk, q_rows, k_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s = q k^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP = dO v^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < kTileK / 2; ++c) {
      const int col = c0 + c;
      float p, dsr;
      dense_grad(biased_logit(s_w[r * kLdf + col], scale, brow[col]),
                 dp_w[r * kLdf + col], row_lse, row_delta, col < k_rows, p, dsr);
      ds_w[r * kLdh + col] = __float2bfloat16_rn(__fmul_rn(dsr, scale));
    }
    __syncwarp();
    warp_nn_acc(acc_dq, ds_w, sm.walk0);  // dQ += dS k
  }
  store_acc(acc_dq, s_w, warp, lane, dq + (bh * Lq + q0) * kHeadDim, q_rows);
}

// Grid (key tiles, query tiles, slabs). For each head of the slab in order:
// the q and dO tiles of the block's queries, the k and v tiles of its keys,
// s and dP for this warp's 16 query rows, and p (dP - delta) added to the
// lane's 32 entries in registers.
__global__ void __launch_bounds__(kThreads)
flash_dense_bwd_db_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ bias, float* __restrict__ db,
                          int Lq, int Lk, int heads_group, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseBwdSmem& dsm = *reinterpret_cast<DenseBwdSmem*>(smem_raw);
  BwdSmem& sm = dsm.base;
  const int k0 = blockIdx.x * kTileK;
  const int q0 = blockIdx.y * kTileQ;
  const int64_t slab = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kTileQ, Lq - q0);
  const int k_rows = min(kTileK, Lk - k0);
  const int64_t tile_offset = (slab * Lq + q0) * (int64_t)Lk + k0;

  load_bias_tile<false>(dsm.bias, bias + tile_offset, Lk, q_rows, k_rows);
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdf;
  float* dp_w = sm.dp + row0 * kLdf;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kTileK / 2);
  const float* brow = dsm.bias + (row0 + r) * kLdb + c0;
  float acc[kTileK / 2];
#pragma unroll
  for (int c = 0; c < kTileK / 2; ++c) acc[c] = 0.0f;

  for (int hh = 0; hh < heads_group; ++hh) {
    const int64_t bh = slab * heads_group + hh;
    __syncthreads();
    load_tile(sm.own0, q + (bh * Lq + q0) * kHeadDim, kHeadDim, q_rows);
    load_tile(sm.own1, dout + (bh * Lq + q0) * kHeadDim, kHeadDim, q_rows);
    load_tile(sm.walk0, k + (bh * Lk + k0) * kHeadDim, kHeadDim, k_rows);
    load_tile(sm.walk1, v + (bh * Lk + k0) * kHeadDim, kHeadDim, k_rows);
    load_rows(sm, lse + bh * Lq + q0, delta + bh * Lq + q0, q_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s = q k^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP = dO v^T
    __syncwarp();
    const float row_lse = sm.lse[row0 + r];
    const float row_delta = sm.delta[row0 + r];
#pragma unroll
    for (int c = 0; c < kTileK / 2; ++c) {
      float p, dsr;
      dense_grad(biased_logit(s_w[r * kLdf + c0 + c], scale, brow[c]),
                 dp_w[r * kLdf + c0 + c], row_lse, row_delta, c0 + c < k_rows, p, dsr);
      acc[c] = __fadd_rn(acc[c], dsr);
    }
  }
  // stage the tile through shared memory, then write it with coalesced
  // stores of the rows and columns inside the edges
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kTileK / 2; ++c) s_w[r * kLdf + c0 + c] = acc[c];
  __syncthreads();
  for (int i = threadIdx.x; i < kTileQ * kTileK; i += kThreads) {
    const int qr = i / kTileK;
    const int kc = i % kTileK;
    if (qr < q_rows && kc < k_rows) db[tile_offset + qr * (int64_t)Lk + kc] = sm.s[qr * kLdf + kc];
  }
}

template <typename Smem_, typename Kernel>
static int prepare(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem_)));
}

}  // namespace avatar_attn

// C entries for ctypes. `bias` is [B*H / heads_group, Lq, Lk] f32. Each
// returns the cudaError_t of its launch (0 = success).
extern "C" int flash_dense_fwd_bf16(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, void* lse, int B,
                                    int H, int Lq, int Lk, int heads_group,
                                    float scale, void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseSmem>(flash_dense_fwd_kernel);
  if (err != 0) return err;
  dim3 grid((Lq + kTileQ - 1) / kTileQ, H, B);
  flash_dense_fwd_kernel<<<grid, kThreads, sizeof(DenseSmem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Lq, Lk,
      heads_group, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dense_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, const void* bias, void* dk,
                                        void* dv, int B, int H, int Lq, int Lk,
                                        int heads_group, float scale, void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseBwdSmem>(flash_dense_bwd_dkv_kernel);
  if (err != 0) return err;
  dim3 grid((Lk + kTileK - 1) / kTileK, H, B);
  flash_dense_bwd_dkv_kernel<<<grid, kThreads, sizeof(DenseBwdSmem),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Lq, Lk, heads_group, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dense_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* bias, void* dq,
                                       int B, int H, int Lq, int Lk, int heads_group,
                                       float scale, void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseBwdSmem>(flash_dense_bwd_dq_kernel);
  if (err != 0) return err;
  dim3 grid((Lq + kTileQ - 1) / kTileQ, H, B);
  flash_dense_bwd_dq_kernel<<<grid, kThreads, sizeof(DenseBwdSmem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(dq), H, Lq, Lk,
      heads_group, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dense_bwd_db_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* bias, void* db,
                                       int B, int H, int Lq, int Lk, int heads_group,
                                       float scale, void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseBwdSmem>(flash_dense_bwd_db_kernel);
  if (err != 0) return err;
  dim3 grid((Lk + kTileK - 1) / kTileK, (Lq + kTileQ - 1) / kTileQ,
            B * H / heads_group);
  flash_dense_bwd_db_kernel<<<grid, kThreads, sizeof(DenseBwdSmem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<float*>(db), Lq, Lk, heads_group,
      scale);
  return static_cast<int>(cudaGetLastError());
}
