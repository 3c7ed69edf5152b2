// Head-major flash attention with a dense additive bias, forward and
// backward: q/o/dO/dQ [B, H, Lq, d], k/v/dK/dV [B, H, Lk, d], bias
// [Bb, Lq, Lk] f32 with Bb = B*H (one slab per head) or
// Bb = B (one slab shared by the H heads of a sample): head bh = b*H + h
// reads slab bh / heads_group, heads_group = B*H / Bb. lse and delta
// [B, H, Lq] f32, dBias [Bb, Lq, Lk] f32. Built per element type and
// padded head dim (attention_tile.cuh, attention_bwd_tile.cuh): bf16 or
// f32, any d % 8 == 0 up to 512, as the reference's `dense_bias_supported`.
//
// Replaces the four TPU kernels of the dense-bias path
// (avatar_tpu/ops/flash_attention.py):
// - flash_dense_fwd_<type>: `_fwd_kernel_dense_bias` (:317, launched by
//   `_flash_dense_forward` :1287). s = fl(fl(q k^T) scale) + bias in f32,
//   online softmax with a running max that starts at -1e30; an entry with
//   s <= -5e29 counts as masked and gets p = 0 explicitly (a key tile whose
//   entries all sit near -1e30 would otherwise give exp(0) = 1); p rounded
//   to the value type for the PV product, l summed from the f32 p. A row with l = 0
//   returns O = 0 and lse = 1e30.
// - flash_dense_bwd_dkv_<type>: `_bwd_dkv_kernel_bias` (:1328, :1471). For one
//   tile of keys, over every query tile: p = exp(s - lse), dV += bf16(p)^T
//   dO, dP = dO v^T, dS = p (dP - delta) scale, dK += bf16(dS)^T q.
// - flash_dense_bwd_dq_<type>: `_bwd_dq_kernel_bias` (:1367, :1513). For one
//   tile of queries, over every key tile: dQ += bf16(dS) k.
// - flash_dense_bwd_db_<type>: `_bwd_db_kernel` (:1397, :1545). For one
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
// bias tile beside the walked tile. One block of 16-row warps owns a tile
// of one head (of one slab for dBias) and walks the other axis tile by
// tile (64 x 64 at bf16 / 64; smaller tiles for the wide variants). Every
// walked step loads the f32 bias tile into shared memory with coalesced reads (transposed for dK/dV,
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
constexpr int kLdb = kTileK + 1;        // f32 row stride of a forward bias tile
constexpr int kLdbB = kWalk + 1;        // f32 row stride of a backward bias tile

struct DenseSmem {
  Smem base;                   // q, k, v, p, s, o and keep (attention_tile.cuh)
  float bias[kTileQ * kLdb];   // [query row][key column]
};

struct DenseBwdSmem {
  BwdSmem base;                // attention_bwd_tile.cuh
  float bias[kOwn * kLdbB];    // [own row][walked column]
};

// Bias tile of one slab (row stride ld) at the caller's (q0, k0) into dst
// (row stride ldd): kQ query rows by kK key columns, [query][key] or,
// kTransposed, [key][query]; entries past the rows or columns read -1e30.
// Global reads run along the key axis, neighbouring threads on
// neighbouring addresses.
template <int kQ, int kKeys, bool kTransposed, int kN>
__device__ __forceinline__ void load_bias_tile(float* dst, int ldd, const float* src,
                                               int64_t ld, int q_rows, int k_rows) {
  for (int i = threadIdx.x; i < kQ * kKeys; i += kN) {
    const int qr = i / kKeys;
    const int kc = i % kKeys;
    const float val = (qr < q_rows && kc < k_rows) ? src[qr * ld + kc] : kNegInf;
    dst[kTransposed ? kc * ldd + qr : qr * ldd + kc] = val;
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
// online softmax update, O += P V. Lanes 2r and 2r+1 own row r, kTileK / 2
// key columns each; `m` and `l` are that row's running max and sum.
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
  T* prow = b.p + (row0 + r) * kLdp + c0;
#pragma unroll 8
  for (int c = 0; c < kTileK / 2; ++c) {
    const float sv = srow[c];
    const float p = (keep[c] > -0.5f && sv > kMaskedAt) ? expf(sv - m) : 0.0f;
    psum += p;
    prow[c] = to_t(p);
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  l = l * alpha + psum;
  float* orow = b.o + (row0 + r) * kLdo + (lane & 1) * (kHeadDim / 2);
#pragma unroll 8
  for (int c = 0; c < kHeadDim / 2; ++c) orow[c] *= alpha;
  __syncwarp();
  pv_accumulate(b, warp);
}

__global__ void __launch_bounds__(kThreads)
flash_dense_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       T* __restrict__ out, float* __restrict__ lse,
                       int H, int Lq, int Lk, int heads_group, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseSmem& sm = *reinterpret_cast<DenseSmem*>(smem_raw);
  Smem& b = sm.base;
  const int q0 = blockIdx.x * kTileQ;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kTileQ, Lq - q0);
  const T* k_head = k + bh * Lk * d;
  const T* v_head = v + bh * Lk * d;
  const float* bias_rows = bias + ((bh / heads_group) * Lq + q0) * (int64_t)Lk;

  load_tile<kTileQ>(b.q, q + (bh * Lq + q0) * d, d, q_rows, d);
  for (int i = threadIdx.x; i < kTileQ * kLdo; i += kThreads) b.o[i] = 0.0f;

  float m = kNegInf, l = 0.0f;
  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int rows = min(kTileK, Lk - k0);
    __syncthreads();
    load_tile<kTileK>(b.k, k_head + (int64_t)k0 * d, d, rows, d);
    load_tile<kTileK>(b.v, v_head + (int64_t)k0 * d, d, rows, d);
    load_keep<kTileK>(b.keep, nullptr, k0, rows);
    load_bias_tile<kTileQ, kTileK, false, kThreads>(sm.bias, kLdb, bias_rows + k0, Lk, q_rows, rows);
    __syncthreads();
    dense_attend_tile(sm, warp, lane, scale, m, l);
  }
  store_rows(b, warp, lane, l, out + (bh * Lq + q0) * d, d, q_rows, d);
  const int row = warp * 16 + (lane >> 1);
  if ((lane & 1) == 0 && row < q_rows)
    lse[bh * Lq + q0 + row] = l == 0.0f ? kLseMasked : m + logf(l);
}

__global__ void __launch_bounds__(kBwdThreads)
flash_dense_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ bias, T* __restrict__ dk,
                           T* __restrict__ dv, int H, int Lq, int Lk,
                           int heads_group, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseBwdSmem& dsm = *reinterpret_cast<DenseBwdSmem*>(smem_raw);
  BwdSmem& sm = dsm.base;
  const int k0 = blockIdx.x * kOwn;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_rows = min(kOwn, Lk - k0);
  const T* q_head = q + bh * Lq * d;
  const T* do_head = dout + bh * Lq * d;
  const float* bias_slab = bias + (bh / heads_group) * (int64_t)Lq * Lk + k0;

  load_tile<kOwn, kBwdThreads>(sm.own0, k + (bh * Lk + k0) * d, d, k_rows, d);
  load_tile<kOwn, kBwdThreads>(sm.own1, v + (bh * Lk + k0) * d, d, k_rows, d);

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
  const bool inside = row0 + r < k_rows;
  const float* brow = dsm.bias + (row0 + r) * kLdbB;

  for (int q0 = 0; q0 < Lq; q0 += kWalk) {
    const int q_rows = min(kWalk, Lq - q0);
    __syncthreads();
    load_tile<kWalk, kBwdThreads>(sm.walk0, q_head + (int64_t)q0 * d, d, q_rows, d);
    load_tile<kWalk, kBwdThreads>(sm.walk1, do_head + (int64_t)q0 * d, d, q_rows, d);
    load_rows<kWalk>(sm, lse + bh * Lq + q0, delta + bh * Lq + q0, q_rows);
    load_bias_tile<kWalk, kOwn, true, kBwdThreads>(dsm.bias, kLdbB, bias_slab + (int64_t)q0 * Lk, Lk,
                                      q_rows, k_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s^T = k q^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP^T = v dO^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < kWalk / 2; ++c) {
      const int col = c0 + c;
      float p, dsr;
      dense_grad(biased_logit(s_w[r * kLdfB + col], scale, brow[col]),
                 dp_w[r * kLdfB + col], sm.lse[col], sm.delta[col], inside, p, dsr);
      p_w[r * kLdpB + col] = to_t(p);
      ds_w[r * kLdpB + col] = to_t(__fmul_rn(dsr, scale));
    }
    __syncwarp();
    acc_dv.add(p_w, sm.walk1);   // dV += p^T dO
    acc_dk.add(ds_w, sm.walk0);  // dK += dS^T q
  }
  acc_dk.store(s_w, warp, lane, dk + (bh * Lk + k0) * d, k_rows, d);
  acc_dv.store(dp_w, warp, lane, dv + (bh * Lk + k0) * d, k_rows, d);
}

__global__ void __launch_bounds__(kBwdThreads)
flash_dense_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ bias, T* __restrict__ dq,
                          int H, int Lq, int Lk, int heads_group, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseBwdSmem& dsm = *reinterpret_cast<DenseBwdSmem*>(smem_raw);
  BwdSmem& sm = dsm.base;
  const int q0 = blockIdx.x * kOwn;
  const int64_t bh = (int64_t)blockIdx.z * H + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kOwn, Lq - q0);
  const T* k_head = k + bh * Lk * d;
  const T* v_head = v + bh * Lk * d;
  const float* bias_rows = bias + ((bh / heads_group) * Lq + q0) * (int64_t)Lk;

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
  const float* brow = dsm.bias + (row0 + r) * kLdbB;
  __syncthreads();
  const float row_lse = sm.lse[row0 + r];
  const float row_delta = sm.delta[row0 + r];

  for (int k0 = 0; k0 < Lk; k0 += kWalk) {
    const int k_rows = min(kWalk, Lk - k0);
    __syncthreads();
    load_tile<kWalk, kBwdThreads>(sm.walk0, k_head + (int64_t)k0 * d, d, k_rows, d);
    load_tile<kWalk, kBwdThreads>(sm.walk1, v_head + (int64_t)k0 * d, d, k_rows, d);
    load_bias_tile<kOwn, kWalk, false, kBwdThreads>(dsm.bias, kLdbB, bias_rows + k0, Lk, q_rows,
                                       k_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s = q k^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP = dO v^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < kWalk / 2; ++c) {
      const int col = c0 + c;
      float p, dsr;
      dense_grad(biased_logit(s_w[r * kLdfB + col], scale, brow[col]),
                 dp_w[r * kLdfB + col], row_lse, row_delta, col < k_rows, p, dsr);
      ds_w[r * kLdpB + col] = to_t(__fmul_rn(dsr, scale));
    }
    __syncwarp();
    acc_dq.add(ds_w, sm.walk0);  // dQ += dS k
  }
  acc_dq.store(s_w, warp, lane, dq + (bh * Lq + q0) * d, q_rows, d);
}

// Grid (key tiles, query tiles, slabs). For each head of the slab in order:
// the q and dO tiles of the block's queries (kOwn rows), the k and v tiles
// of its keys (kWalk rows), s and dP for this warp's 16 query rows, and
// p (dP - delta) added to the lane's kWalk / 2 entries in registers.
__global__ void __launch_bounds__(kBwdThreads)
flash_dense_bwd_db_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ bias, float* __restrict__ db,
                          int Lq, int Lk, int heads_group, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DenseBwdSmem& dsm = *reinterpret_cast<DenseBwdSmem*>(smem_raw);
  BwdSmem& sm = dsm.base;
  const int k0 = blockIdx.x * kWalk;
  const int q0 = blockIdx.y * kOwn;
  const int64_t slab = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q_rows = min(kOwn, Lq - q0);
  const int k_rows = min(kWalk, Lk - k0);
  const int64_t tile_offset = (slab * Lq + q0) * (int64_t)Lk + k0;

  load_bias_tile<kOwn, kWalk, false, kBwdThreads>(dsm.bias, kLdbB, bias + tile_offset, Lk, q_rows,
                                     k_rows);
  const int row0 = warp * 16;
  float* s_w = sm.s + row0 * kLdfB;
  float* dp_w = sm.dp + row0 * kLdfB;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (kWalk / 2);
  const float* brow = dsm.bias + (row0 + r) * kLdbB + c0;
  float acc[kWalk / 2];
#pragma unroll
  for (int c = 0; c < kWalk / 2; ++c) acc[c] = 0.0f;

  for (int hh = 0; hh < heads_group; ++hh) {
    const int64_t bh = slab * heads_group + hh;
    __syncthreads();
    load_tile<kOwn, kBwdThreads>(sm.own0, q + (bh * Lq + q0) * d, d, q_rows, d);
    load_tile<kOwn, kBwdThreads>(sm.own1, dout + (bh * Lq + q0) * d, d, q_rows, d);
    load_tile<kWalk, kBwdThreads>(sm.walk0, k + (bh * Lk + k0) * d, d, k_rows, d);
    load_tile<kWalk, kBwdThreads>(sm.walk1, v + (bh * Lk + k0) * d, d, k_rows, d);
    load_rows<kOwn>(sm, lse + bh * Lq + q0, delta + bh * Lq + q0, q_rows);
    __syncthreads();
    warp_nt(s_w, sm.own0 + row0 * kLdh, sm.walk0);   // s = q k^T
    warp_nt(dp_w, sm.own1 + row0 * kLdh, sm.walk1);  // dP = dO v^T
    __syncwarp();
    const float row_lse = sm.lse[row0 + r];
    const float row_delta = sm.delta[row0 + r];
#pragma unroll
    for (int c = 0; c < kWalk / 2; ++c) {
      float p, dsr;
      dense_grad(biased_logit(s_w[r * kLdfB + c0 + c], scale, brow[c]),
                 dp_w[r * kLdfB + c0 + c], row_lse, row_delta, c0 + c < k_rows, p, dsr);
      acc[c] = __fadd_rn(acc[c], dsr);
    }
  }
  // stage the tile through shared memory, then write it with coalesced
  // stores of the rows and columns inside the edges
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kWalk / 2; ++c) s_w[r * kLdfB + c0 + c] = acc[c];
  __syncthreads();
  for (int i = threadIdx.x; i < kOwn * kWalk; i += kBwdThreads) {
    const int qr = i / kWalk;
    const int kc = i % kWalk;
    if (qr < q_rows && kc < k_rows) db[tile_offset + qr * (int64_t)Lk + kc] = sm.s[qr * kLdfB + kc];
  }
}

template <typename Smem_, typename Kernel>
static int prepare(Kernel kernel, int d) {
  if (d % 8 != 0 || d > kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem_)));
}

}  // namespace avatar_attn

// C entries for ctypes, named by type (flash_dense_fwd_bf16, ..._f32).
// `bias` is [B*H / heads_group, Lq, Lk] f32. Each returns the cudaError_t
// of its launch (0 = success).
extern "C" int ATTN_ENTRY(flash_dense_fwd)(const void* q, const void* k, const void* v,
                                           const void* bias, void* out, void* lse,
                                           int B, int H, int Lq, int Lk,
                                           int heads_group, int d, float scale,
                                           void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseSmem>(flash_dense_fwd_kernel, d);
  if (err != 0) return err;
  dim3 grid((Lq + kTileQ - 1) / kTileQ, H, B);
  flash_dense_fwd_kernel<<<grid, kThreads, sizeof(DenseSmem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), static_cast<float*>(lse),
      H, Lq, Lk, heads_group, d, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ATTN_ENTRY(flash_dense_bwd_dkv)(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, const void* bias,
                                               void* dk, void* dv, int B, int H, int Lq,
                                               int Lk, int heads_group, int d,
                                               float scale, void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseBwdSmem>(flash_dense_bwd_dkv_kernel, d);
  if (err != 0) return err;
  dim3 grid((Lk + kOwn - 1) / kOwn, H, B);
  flash_dense_bwd_dkv_kernel<<<grid, kBwdThreads, sizeof(DenseBwdSmem),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, heads_group, d, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ATTN_ENTRY(flash_dense_bwd_dq)(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, const void* bias,
                                              void* dq, int B, int H, int Lq, int Lk,
                                              int heads_group, int d, float scale,
                                              void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseBwdSmem>(flash_dense_bwd_dq_kernel, d);
  if (err != 0) return err;
  dim3 grid((Lq + kOwn - 1) / kOwn, H, B);
  flash_dense_bwd_dq_kernel<<<grid, kBwdThreads, sizeof(DenseBwdSmem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<T*>(dq), H, Lq, Lk, heads_group, d, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ATTN_ENTRY(flash_dense_bwd_db)(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, const void* bias,
                                              void* db, int B, int H, int Lq, int Lk,
                                              int heads_group, int d, float scale,
                                              void* stream) {
  using namespace avatar_attn;
  int err = prepare<DenseBwdSmem>(flash_dense_bwd_db_kernel, d);
  if (err != 0) return err;
  dim3 grid((Lk + kWalk - 1) / kWalk, (Lq + kOwn - 1) / kOwn, B * H / heads_group);
  flash_dense_bwd_db_kernel<<<grid, kBwdThreads, sizeof(DenseBwdSmem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<float*>(db), Lq, Lk, heads_group, d, scale);
  return static_cast<int>(cudaGetLastError());
}
