// Head-major flash attention backward for Hopper (sm_90a), bf16, head_dim
// 64 or 128 (ATTN_D at build time): contiguous q/dO/dQ [B, H, Lq, d] and
// k/v/dK/dV [B, H, Lk, d], optional [B, Lk] f32 keep-mask (> 0.5 keeps),
// lse and delta [B, H, Lq] f32.
//
// Replaces, at bf16 and head_dim 64 / 128, the WMMA kernels of
// flash_backward.cu for the two TPU kernels that `_flash_backward`
// (avatar_tpu/ops/flash_attention.py:1106) launches:
// - flash_bwd_dkv_sm90_bf16: `_bwd_dkv_kernel` (:996, `_nomask` :1052).
// - flash_bwd_dq_sm90_bf16: `_bwd_dq_kernel` (:1058, `_nomask` :1100).
// Per (query, key): s = fl(q k) * scale in f32, masked keys at p = 0,
// p = exp(s - lse), dV += bf16(p)^T dO, dP = dO v^T,
// dS = p (dP - delta) scale, dK += bf16(dS)^T q, dQ += bf16(dS) k. Sums run
// in f32; dS is formed one f32 step at a time as the reference rounds it
// (__fmul_rn, __fsub_rn; no fused multiply-add); p and dS are rounded to
// bf16 before their products. lse is the forward kernels': 1e30 for a row
// with no kept key, which makes its p and its gradients 0. delta =
// rowsum(dO * O) is one reduction outside the kernels. Query rows past Lq
// read TMA's zero fill and get lse = +inf, delta = 0 (p = 0); keys past Lk
// and masked keys get p = 0.
//
// One departure from the reference's rounding, and why: p is
// exp2(fma(s, scale log2(e), -lse log2(e))) with the hardware's exp2, as in
// the forward kernel, where the reference rounds s * scale, then - lse, then
// takes an accurate exp. The two differ by about 1e-6 relative, far inside
// the bf16 rounding of p and dS: the gradients meet the same 4-ulp gate
// with the same errors. On an H100 the accurate `expf` took 2.2x the kernel
// time, and the reference's three rounded steps before a fast exp2 8-10%
// more at head_dim 64 (an A/B build of this source).
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s). One product of
// the attention is 2 * B * H * Lq * Lk * d operations; dK/dV does four
// (S, dP, dV, dK), dQ three (S, dP, dQ):
// - training shape [8, 32, 480, 64]: dK/dV 30.2 GFLOP (30.5 us) against
//   95 MB (28.5 us): operations; dQ 22.6 GFLOP (22.9 us) against 80 MB
//   (23.8 us): bytes, by a hair.
// - [1, 32, 5376, 64]: dK/dV 473.5 GFLOP (478.8 us), dQ 355.1 GFLOP
//   (359.1 us), about 10 MB each: operations.
// So every product runs on wgmma at the tensor cores' rate, its operands
// brought by TMA and its intermediates kept in registers; each kernel
// reads its inputs once per CTA from L2. What remains in the way is the
// per-element work between the products (exp2, dS, the bf16 packs: about
// 8 instructions per (query, key) against 4 d multiply-adds on the tensor
// cores), which at head_dim 64 takes about as long as the products and
// overlaps them only across the two consumer warpgroups.
//
// Design (warp-specialised, as flash_forward_sm90.cu; FlashAttention-3's
// backward without its atomic dQ):
// - dK/dV: one CTA of 384 threads owns (batch, head, 128 keys). Warpgroup 0
//   is the producer: its first warp loads the K and V tiles once by TMA,
//   then walks the queries kWalk at a time (128 at d = 64, 64 at d = 128)
//   through a 2-stage ring of Q and dO tiles, staging each tile's lse
//   (+inf past Lq) and delta (0 past Lq) beside them; full/empty mbarriers
//   per stage. Warpgroups 1 and 2 own 64 keys each (setmaxnreg 40 / 232).
//   Per walked tile each computes S^T = K Q^T and dP^T = V dO^T by wgmma,
//   both operands K-major in shared memory and the accumulators (rows =
//   keys) in registers; p and dS on those fragments in registers; both
//   packed to bf16 are exactly the register A operands of dV += P^T dO and
//   dK += dS^T Q, whose B operands dO and Q are read MN-major from the same
//   swizzled panels. P and dS never touch shared memory. dK and dV stay in
//   registers across the whole walk (kD / 2 f32 per thread each).
// - dQ: one CTA owns (batch, head, 128 queries): the Q and dO tiles once,
//   lse and delta per row in registers, K and V walked through the ring
//   with their keep flags staged per tile (1 kept, 0 masked, -1 past Lk).
//   S = Q K^T and dP = dO V^T by wgmma; dS to bf16 on the fragment;
//   dQ += dS K with K read MN-major.
// - Inside a warpgroup S and dP are committed as two groups, so p is formed
//   while dP is still in flight; dV's and dK's products go out as one
//   group. The two consumer warpgroups overlap each other's elementwise
//   work with their products.
// - Epilogue: the accumulators to bf16 into this warpgroup's rows of the
//   (now unused) owned tiles, then out by TMA store, which clips rows past
//   the end.
// Two kernels and no atomics, as on the TPU: deterministic, and no f32 dQ
// scratch. Tried on an H100 and left out, as neither moved a kernel by more
// than 4%: ping-pong between the consumer warpgroups (the forward's turn
// barriers around S and dP), and a 3-stage ring. Not here: a persistent
// schedule, and issuing the next tile's S and dP before this tile's dV and
// dK complete (it needs registers the 64 x 128 fragments do not leave).
#include "sm90.cuh"

#ifndef ATTN_D
#define ATTN_D 64
#endif

namespace avatar_sm90 {

constexpr int kD = ATTN_D;
static_assert(kD == 64 || kD == 128, "the Hopper kernel takes head_dim 64 or 128");
constexpr int kOwn = 128;                     // rows a CTA owns
constexpr int kWalk = kD == 64 ? 128 : 64;    // rows per walked tile
constexpr int kStages = 2;
constexpr int kPanels = kD / 64;              // 64-column swizzle panels
constexpr int kOwnPanel = kOwn * 128;         // bytes of one panel of an owned tile
constexpr int kWalkPanel = kWalk * 128;       // ... of a walked tile
constexpr int kOwnTile = kPanels * kOwnPanel;
constexpr int kWalkTile = kPanels * kWalkPanel;
constexpr int kThreads = 384;
constexpr int kAccS = kWalk / 2;              // registers of a 64 x kWalk product
constexpr int kAccD = kD / 2;                 // registers of a 64 x kD product
constexpr float kLog2e = 1.4426950408889634f;

// p = exp(s * scale - lse) as exp2(s * scale_log2 - lse_log2), one FMA and
// the hardware's exp2, with log2(e) folded into the scale and into lse
// (staged that way), as the forward kernel folds it.
__device__ __forceinline__ float prob(float s, float scale_log2, float lse_log2) {
  return fast_exp2(fmaf(s, scale_log2, -lse_log2));
}

struct alignas(1024) DkvSmem {
  uint8_t k[kOwnTile];                        // K, then the dK staging
  uint8_t v[kOwnTile];                        // V, then the dV staging
  uint8_t q[kStages][kWalkTile];
  uint8_t dout[kStages][kWalkTile];
  float lse[kStages][kWalk];                  // lse * log2(e), +inf past Lq
  float delta[kStages][kWalk];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

struct alignas(1024) DqSmem {
  uint8_t q[kOwnTile];                        // Q, then the dQ staging
  uint8_t dout[kOwnTile];
  uint8_t k[kStages][kWalkTile];
  uint8_t v[kStages][kWalkTile];
  float keep[kStages][kWalk];                 // 1 kept, 0 masked, -1 past end
  uint64_t own_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <typename Smem>
__device__ __forceinline__ Smem& smem_at_1024() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return *reinterpret_cast<Smem*>(smem_raw + pad);
}

template <typename Smem>
__device__ __forceinline__ void init_barriers(Smem& sm, uint64_t* own_full) {
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
}

// This thread's part of a 64 x kD accumulator fragment (rows `row` and
// row + 8 of an owned tile) to bf16, swizzled as TMA reads it: the 16-byte
// chunk c of row r at c ^ (r % 8).
__device__ __forceinline__ void stage_rows(uint8_t* tile, int row, int qcol,
                                           const float* acc) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    uint8_t* dst = tile + (j / 8) * kOwnPanel + row * 128
                   + ((j % 8) ^ (row % 8)) * 16 + qcol * 2;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dst + 8 * 128) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// After every thread of warpgroup cw has staged its rows: make them visible
// to TMA, then thread 0 stores the warpgroup's 64 rows of each tile, from
// row0 of a head of `len` rows (rows past the end clipped), and waits until
// they have been read.
__device__ __forceinline__ void store_rows(int cw, int tid, int row0, int len, int h, int b,
                                           const CUtensorMap* map0, const uint8_t* tile0,
                                           const CUtensorMap* map1 = nullptr,
                                           const uint8_t* tile1 = nullptr) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
  if (tid == 0 && row0 < len) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      tma_store(map0, tile0 + p * kOwnPanel + cw * 64 * 128, p * 64, row0, h, b);
      if (map1 != nullptr)
        tma_store(map1, tile1 + p * kOwnPanel + cw * 64 * 128, p * 64, row0, h, b);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ mask, int H, int Lq, int Lk,
                          float scale) {
  DkvSmem& sm = smem_at_1024<DkvSmem>();
  const int k0 = blockIdx.x * kOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Lq + kWalk - 1) / kWalk;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_barriers(sm, &sm.kv_full);

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv_full, 2 * kOwnTile);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.k + p * kOwnPanel, &tm_k, &sm.kv_full, p * 64, k0, h, b);
        tma_load(sm.v + p * kOwnPanel, &tm_v, &sm.kv_full, p * 64, k0, h, b);
      }
    }
    const float* lse_head = lse + ((int64_t)b * H + h) * Lq;
    const float* delta_head = delta + ((int64_t)b * H + h) * Lq;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
      const int q0 = t * kWalk;
      for (int j = lane; j < kWalk; j += 32) {
        const bool in = q0 + j < Lq;
        sm.lse[s][j] = in ? lse_head[q0 + j] * kLog2e : INFINITY;
        sm.delta[s][j] = in ? delta_head[q0 + j] : 0.0f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * kWalkTile);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.q[s] + p * kWalkPanel, &tm_q, &sm.full[s], p * 64, q0, h, b);
          tma_load(sm.dout[s] + p * kWalkPanel, &tm_do, &sm.full[s], p * 64, q0, h, b);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys [k0 + cw * 64, k0 + cw * 64 + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;             // first of this thread's two columns per 8
  const int row = cw * 64 + warp * 16 + lane / 4;  // key row in the CTA tile (and row + 8)
  bool kept[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row + 8 * r;
    kept[r] = key < Lk && (!kMask || mask[(int64_t)b * Lk + key] > 0.5f);
  }
  float dk[kAccD], dv[kAccD];
#pragma unroll
  for (int i = 0; i < kAccD; ++i) dk[i] = dv[i] = 0.0f;
  const uint32_t k_addr = smem_u32(sm.k) + cw * 64 * 128;
  const uint32_t v_addr = smem_u32(sm.v) + cw * 64 * 128;

  const float scale_log2 = scale * kLog2e;
  mbar_wait(&sm.kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const uint32_t q_addr = smem_u32(sm.q[s]);
    const uint32_t do_addr = smem_u32(sm.dout[s]);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns this tile's queries
    float sacc[kAccS], dpacc[kAccS];
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t own = (kk / 4) * kOwnPanel + (kk % 4) * 32;
      const uint32_t walk = (kk / 4) * kWalkPanel + (kk % 4) * 32;
      wgmma_ss(sacc, sw128_desc(k_addr + own, 16, 1024),
               sw128_desc(q_addr + walk, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t own = (kk / 4) * kOwnPanel + (kk % 4) * 32;
      const uint32_t walk = (kk / 4) * kWalkPanel + (kk % 4) * 32;
      wgmma_ss(dpacc, sw128_desc(v_addr + own, 16, 1024),
               sw128_desc(do_addr + walk, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // p on the S^T fragment while dP^T is in flight: sacc[4j + 2r + e] is
    // (key row + 8r, query 8j + qcol + e)
    wgmma_wait<1>();
    fence_regs(sacc);
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = sm.lse[s][8 * j + qcol + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = sacc[4 * j + 2 * r + e];
          x = kept[r] ? prob(x, scale_log2, l) : 0.0f;
        }
      }
    }
    // dS, and p and dS packed to bf16: the A operands of dV and dK
    wgmma_wait<0>();
    fence_regs(dpacc);
    uint32_t pa[kAccS / 2], dsa[kAccS / 2];
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dl = sm.delta[s][8 * j + qcol + i % 2];
        ds[i] = __fmul_rn(__fmul_rn(sacc[4 * j + i], __fsub_rn(dpacc[4 * j + i], dl)), scale);
      }
      pa[2 * j] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
      dsa[2 * j] = pack_bf16(ds[0], ds[1]);
      dsa[2 * j + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q MN-major
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk)
      wgmma_rs(dv, pa + 4 * kk, sw128_desc(do_addr + kk * 16 * 128, kWalkPanel, 1024));
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk)
      wgmma_rs(dk, dsa + 4 * kk, sw128_desc(q_addr + kk * 16 * 128, kWalkPanel, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // ---- epilogue: this warpgroup's rows of K and V hold dK and dV ----
  stage_rows(sm.k, row, qcol, dk);
  stage_rows(sm.v, row, qcol, dv);
  store_rows(cw, tid, k0 + cw * 64, Lk, h, b, &tm_dk, sm.k, &tm_dv, sm.v);
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dq,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ mask, int H, int Lq, int Lk,
                         float scale) {
  DqSmem& sm = smem_at_1024<DqSmem>();
  const int q0 = blockIdx.x * kOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Lk + kWalk - 1) / kWalk;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_barriers(sm, &sm.own_full);

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.own_full, 2 * kOwnTile);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.q + p * kOwnPanel, &tm_q, &sm.own_full, p * 64, q0, h, b);
        tma_load(sm.dout + p * kOwnPanel, &tm_do, &sm.own_full, p * 64, q0, h, b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
      const int k0 = t * kWalk;
      if (kMask) {
        for (int j = lane; j < kWalk; j += 32) {
          float f = -1.0f;
          if (k0 + j < Lk) f = mask[(int64_t)b * Lk + k0 + j] > 0.5f ? 1.0f : 0.0f;
          sm.keep[s][j] = f;
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * kWalkTile);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.k[s] + p * kWalkPanel, &tm_k, &sm.full[s], p * 64, k0, h, b);
          tma_load(sm.v[s] + p * kWalkPanel, &tm_v, &sm.full[s], p * 64, k0, h, b);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns queries [q0 + cw * 64, q0 + cw * 64 + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;
  const int row = cw * 64 + warp * 16 + lane / 4;  // query row in the CTA tile (and row + 8)
  float row_lse[2], row_delta[2];  // lse * log2(e), +inf past Lq; delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = q0 + row + 8 * r;
    const int64_t at = ((int64_t)b * H + h) * Lq + qrow;
    row_lse[r] = qrow < Lq ? lse[at] * kLog2e : INFINITY;
    row_delta[r] = qrow < Lq ? delta[at] : 0.0f;
  }
  float dq[kAccD];
#pragma unroll
  for (int i = 0; i < kAccD; ++i) dq[i] = 0.0f;
  const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;
  const uint32_t do_addr = smem_u32(sm.dout) + cw * 64 * 128;

  const float scale_log2 = scale * kLog2e;
  mbar_wait(&sm.own_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);
    const uint32_t k_addr = smem_u32(sm.k[s]);
    const uint32_t v_addr = smem_u32(sm.v[s]);

    // S = Q K^T and dP = dO V^T: rows queries, columns this tile's keys
    float sacc[kAccS], dpacc[kAccS];
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t own = (kk / 4) * kOwnPanel + (kk % 4) * 32;
      const uint32_t walk = (kk / 4) * kWalkPanel + (kk % 4) * 32;
      wgmma_ss(sacc, sw128_desc(q_addr + own, 16, 1024),
               sw128_desc(k_addr + walk, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t own = (kk / 4) * kOwnPanel + (kk % 4) * 32;
      const uint32_t walk = (kk / 4) * kWalkPanel + (kk % 4) * 32;
      wgmma_ss(dpacc, sw128_desc(do_addr + own, 16, 1024),
               sw128_desc(v_addr + walk, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // p on the S fragment while dP is in flight: sacc[4j + 2r + e] is
    // (query row + 8r, key 8j + qcol + e)
    wgmma_wait<1>();
    fence_regs(sacc);
    const int limit = Lk - t * kWalk;
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + qcol + e;
        const bool kept_col = kMask ? sm.keep[s][col] > 0.5f : col < limit;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = sacc[4 * j + 2 * r + e];
          x = kept_col ? prob(x, scale_log2, row_lse[r]) : 0.0f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dpacc);
    uint32_t dsa[kAccS / 2];
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[i] = __fmul_rn(__fmul_rn(sacc[4 * j + i], __fsub_rn(dpacc[4 * j + i],
                                                               row_delta[i / 2])),
                          scale);
      dsa[2 * j] = pack_bf16(ds[0], ds[1]);
      dsa[2 * j + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk)
      wgmma_rs(dq, dsa + 4 * kk, sw128_desc(k_addr + kk * 16 * 128, kWalkPanel, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // ---- epilogue: this warpgroup's rows of Q hold dQ ----
  stage_rows(sm.q, row, qcol, dq);
  store_rows(cw, tid, q0 + cw * 64, Lq, h, b, &tm_dq, sm.q);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Tensor map of a contiguous [B, H, L, kD] bf16 tensor, boxes of `rows` rows.
static int contiguous_map(CUtensorMap* map, const void* ptr, int B, int H, int L,
                          int rows) {
  const long long sl = kD, sh = (long long)L * kD, sb = (long long)H * sh;
  return make_map(map, ptr, B, H, L, kD, sb, sh, sl, rows);
}

template <typename Smem, typename Kernel>
static int prepare(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem) + 1024));
}

}  // namespace avatar_sm90

// C entries for ctypes, with the arguments of flash_backward.cu's. `mask`
// may be null (no mask). Each returns a cudaError_t (0 = success).
extern "C" int flash_bwd_dkv_sm90_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* mask, void* dk,
                                       void* dv, int B, int H, int Lq, int Lk, int d,
                                       float scale, void* stream) {
  using namespace avatar_sm90;
  if (d != kD) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int err = contiguous_map(&tq, q, B, H, Lq, kWalk);
  if (!err) err = contiguous_map(&tdo, dout, B, H, Lq, kWalk);
  if (!err) err = contiguous_map(&tk, k, B, H, Lk, kOwn);
  if (!err) err = contiguous_map(&tv, v, B, H, Lk, kOwn);
  if (!err) err = contiguous_map(&tdk, dk, B, H, Lk, 64);
  if (!err) err = contiguous_map(&tdv, dv, B, H, Lk, 64);
  if (err) return err;
  const float* m = static_cast<const float*>(mask);
  auto kernel = m ? flash_bwd_dkv_sm90_kernel<true> : flash_bwd_dkv_sm90_kernel<false>;
  err = prepare<DkvSmem>(kernel);
  if (err) return err;
  dim3 grid((Lk + kOwn - 1) / kOwn, H, B);
  kernel<<<grid, kThreads, sizeof(DkvSmem) + 1024, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), m, H, Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dq_sm90_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* mask, void* dq,
                                      int B, int H, int Lq, int Lk, int d, float scale,
                                      void* stream) {
  using namespace avatar_sm90;
  if (d != kD) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = contiguous_map(&tq, q, B, H, Lq, kOwn);
  if (!err) err = contiguous_map(&tdo, dout, B, H, Lq, kOwn);
  if (!err) err = contiguous_map(&tk, k, B, H, Lk, kWalk);
  if (!err) err = contiguous_map(&tv, v, B, H, Lk, kWalk);
  if (!err) err = contiguous_map(&tdq, dq, B, H, Lq, 64);
  if (err) return err;
  const float* m = static_cast<const float*>(mask);
  auto kernel = m ? flash_bwd_dq_sm90_kernel<true> : flash_bwd_dq_sm90_kernel<false>;
  err = prepare<DqSmem>(kernel);
  if (err) return err;
  dim3 grid((Lq + kOwn - 1) / kOwn, H, B);
  kernel<<<grid, kThreads, sizeof(DqSmem) + 1024, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), m, H, Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}
