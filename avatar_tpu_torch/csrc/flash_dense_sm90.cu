// Head-major flash attention with a dense additive bias, forward and
// backward, for Hopper (sm_90a): bf16, head_dim 64 or 128 (ATTN_D at build
// time). Contiguous q/o/dO/dQ [B, H, Lq, d], k/v/dK/dV [B, H, Lk, d], bias
// [Bb, Lq, Lk] f32 with Bb = B*H (one slab per head) or B (one slab shared
// by the H heads of a sample): head bh = b*H + h reads slab bh /
// heads_group. lse and delta [B, H, Lq] f32, dBias [Bb, Lq, Lk] f32.
// Lk % 4 == 0 (the bias rows' TMA stride; the wrapper routes other Lk to
// the WMMA kernels of flash_dense.cu).
//
// Replaces, at bf16 and head_dim 64 / 128, the WMMA kernels of
// flash_dense.cu for the four TPU kernels of the dense-bias path
// (avatar_tpu/ops/flash_attention.py):
// - flash_dense_fwd_sm90_bf16: `_fwd_kernel_dense_bias` (:317, launched by
//   `_flash_dense_forward` :1287). s = fl(fl(q k^T) scale) + bias in f32,
//   online softmax with a running max that starts at -1e30; an entry with
//   s <= -5e29 counts as masked and gets p = 0 explicitly (a key tile whose
//   entries all sit near -1e30 would otherwise give exp(0) = 1); p rounded
//   to bf16 for the PV product, l summed from the f32 p. A row with l = 0
//   returns O = 0 and lse = 1e30.
// - flash_dense_bwd_dkv_sm90_bf16: `_bwd_dkv_kernel_bias` (:1328, :1471):
//   p = exp(s - lse), dV += bf16(p)^T dO, dP = dO v^T,
//   dS = p (dP - delta) scale, dK += bf16(dS)^T q.
// - flash_dense_bwd_dq_sm90_bf16: `_bwd_dq_kernel_bias` (:1367, :1513):
//   dQ += bf16(dS) k.
// - flash_dense_bwd_db_sm90_bf16: `_bwd_db_kernel` (:1397, :1545): for one
//   (slab, query tile, key tile), over the heads_group heads of the slab in
//   order, dBias += p (dP - delta), no scale, in f32; written once, no
//   atomics (deterministic).
// delta = rowsum(dO * O) is one reduction outside the kernels. s, dP - delta
// and dS are rounded one f32 step at a time (__fmul_rn, __fadd_rn,
// __fsub_rn); exponentials are the hardware's exp2 of the logits times
// log2(e), as in the other Hopper kernels (flash_backward_sm90.cu says why).
// Ragged edges: keys past Lk get p = 0; query rows past Lq read TMA's zero
// fill, get lse = +inf in the backward (p = 0) and are not written.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s), each input read
// once and each output written once:
// - T5-XXL's attention, [2, 64, 256, 64] with a per-head bias (33.6 MB f32):
//   every kernel is bound by the bias's bytes, 15-25 us.
// - the DiT's long self-attention, [1, 32, 5376, 64] with one shared bias
//   (115.6 MB): bound by operations, 239 us forward, 479 / 359 / 239 us for
//   dK/dV, dQ and dBias (4, 3 and 2 products).
//
// What stands in the way is the bias's bytes between L2 and the SMs: every
// (query tile, key tile) of every head reads a 128 x 64 f32 bias tile (32
// KB) beside 16-32 KB of K and V, so a shared slab crosses from L2 once per
// head (32 x 115.6 MB at the long shape). A bias tile cannot serve two
// heads from shared memory without also holding both heads' K and V, which
// costs as many bytes, so the design keeps the crossing from HBM once: for
// a shared slab the CTAs of one query tile's heads are launched together
// (the head index fastest), so each bias tile is read from HBM once and
// from L2 by the heads; for per-head slabs the query tiles of a head are
// fastest and share its K and V.
//
// Design (warp-specialised, as flash_forward_sm90.cu and
// flash_backward_sm90.cu; one CTA of 384 threads per tile, warpgroup 0 the
// producer, warpgroups 1 and 2 consumers of 64 rows each, setmaxnreg 40 /
// 232, a full and an empty mbarrier per ring stage):
// - The bias tile travels by TMA beside the K/V or Q/dO tiles of its stage,
//   as 128-byte-swizzled panels of 32 f32 columns, so the consumers read it
//   at their accumulator fragments' positions free of bank conflicts: a
//   float2 per (row, column pair) of S, a float per (key, query) of S^T.
// - Forward: each CTA owns 128 query rows of one head; K, V and the bias
//   walk through a 2-stage ring in tiles of 128 keys at d = 64 (a 64 KB
//   bias tile per stage; 7-8% faster at 5376 tokens on an H100 than 64 keys
//   through 3 stages, `python3 -m avatar_tpu_torch.tools.kernel_ab dense`)
//   and 64 at d = 128. S = Q K^T by wgmma (both operands in shared memory), the bias
//   added to the scaled logits on the fragment before the row max, online
//   softmax, O += P V with P as the register A operand; ping-pong between
//   the two consumer warpgroups (named barriers around S). O / l and lse are
//   stored from the registers.
// - dK/dV: each CTA owns 128 keys; Q, dO, lse, delta and the [64 q, 128 k]
//   bias tile walk in tiles of 64 queries. S^T = K Q^T and dP^T = V dO^T by
//   wgmma; the bias is read at the transposed positions; p and dS packed
//   to bf16 are the register A operands of dV += P^T dO and dK += dS^T Q.
// - dQ: each CTA owns 128 queries; K, V and the [128 q, 64 k] bias tile
//   walk; S and dP by wgmma, dQ += dS K.
// - dBias: each CTA owns (slab, 128 queries, 64 keys) and walks the heads
//   of the slab in order through the ring (Q, dO, K, V, lse, delta of each
//   head); its bias tile sits in registers, read once; S and dP by wgmma,
//   p (dP - delta) summed in registers and stored once.
// - The backward rings hold 3 stages at d = 64 (2 at d = 128, what 227 KB
//   of shared memory holds): on an H100 the third stage takes dK/dV at 5376
//   tokens from 1.79-1.81 to 1.25-1.26 ms and dBias from 1.19-1.23 to
//   1.03-1.04 (`kernel_ab`'s `bwd_stages2`).
#include "sm90.cuh"

#ifndef ATTN_D
#define ATTN_D 64
#endif

namespace avatar_dense_sm90 {

using namespace avatar_sm90;

constexpr int kD = ATTN_D;
static_assert(kD == 64 || kD == 128, "the Hopper kernels take head_dim 64 or 128");
constexpr int kThreads = 384;
constexpr int kOwn = 128;                     // rows a CTA owns
constexpr int kWalk = 64;                     // rows of a walked tile
constexpr int kPanels = kD / 64;              // 64-column bf16 swizzle panels
constexpr int kOwnPanel = kOwn * 128;
constexpr int kWalkPanel = kWalk * 128;
constexpr int kOwnTile = kPanels * kOwnPanel;
constexpr int kWalkTile = kPanels * kWalkPanel;
constexpr int kBiasTile = kOwn * kWalk * 4;   // a 128 x 64 f32 bias tile
constexpr int kAccS = kWalk / 2;              // registers of a 64 x 64 product
constexpr int kAccD = kD / 2;                 // registers of a 64 x d product
constexpr int kFwdN = kD == 64 ? 128 : 64;     // keys per forward stage
constexpr int kFwdPanel = kFwdN * 128;
constexpr int kFwdTile = kPanels * kFwdPanel;
constexpr int kFwdBias = kOwn * kFwdN * 4;     // a 128 x kFwdN f32 bias tile
constexpr int kFwdStages = 2;
constexpr int kBwdStages = kD == 64 ? 3 : 2;    // what fits 227 KB at d = 128
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;             // the running max's start
constexpr float kMaskedAt = -5e29f;           // s at or below: masked
constexpr float kLseMasked = 1e30f;           // lse of a row with no kept entry

// Byte offset of f32 element (row, col) of a bias tile of `rows` rows held
// as 128-byte-swizzled panels of 32 columns (rows x 128 bytes each, 1024-byte
// aligned): 16-byte chunk c of a row sits at c ^ (row % 8), as TMA lays it out.
__device__ __forceinline__ uint32_t bias_offset(int rows, int row, int col) {
  return (col / 32) * rows * 128 + row * 128 + ((((col % 32) / 4) ^ (row % 8)) * 16)
         + (col % 4) * 4;
}

// s = fl(fl(raw * scale) + bias), one rounding per step.
__device__ __forceinline__ float biased_logit(float raw, float scale, float bias) {
  return __fadd_rn(__fmul_rn(raw, scale), bias);
}

// p = exp(s - lse) as exp2(s log2(e) - lse log2(e)), lse staged times log2(e).
__device__ __forceinline__ float prob(float s, float lse_log2) {
  return fast_exp2(fmaf(s, kLog2e, -lse_log2));
}

__device__ __forceinline__ void init_ring(uint64_t* own_full, uint64_t* full,
                                          uint64_t* empty, int stages,
                                          uint32_t full_count) {
  if (threadIdx.x == 0) {
    if (own_full != nullptr) mbar_init(own_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// S (+)= A B^T over the head dim for this warpgroup's 64 rows: A at a_addr in
// a tile of a_panel bytes per 64 columns, B at b_addr (b_panel), both K-major.
template <int R>
__device__ __forceinline__ void product_k_major(float (&acc)[R], uint32_t a_addr,
                                                int a_panel, uint32_t b_addr,
                                                int b_panel) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<R>(acc, sw128_desc(a_addr + (kk / 4) * a_panel + (kk % 4) * 32, 16, 1024),
                sw128_desc(b_addr + (kk / 4) * b_panel + (kk % 4) * 32, 16, 1024),
                kk > 0);
}

// D += A B for this warpgroup: A the packed bf16 fragment of a 64 x kRows
// product (kRows / 16 k-slices), B the walked tile of kRows rows at b_addr
// read MN-major.
template <int kRows = kWalk>
__device__ __forceinline__ void product_rs(float (&acc)[kAccD], const uint32_t* a,
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
    wgmma_rs<kAccD>(acc, a + 4 * kk, sw128_desc(b_addr + kk * 16 * 128, kRows * 128, 1024));
}

// This thread's part of a 64 x d accumulator (rows `row`, row + 8) to bf16
// rows of a contiguous [L, d] head, rows past `len` skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* head, int row, int len,
                                           int qcol, const float* acc, float s0 = 1.0f,
                                           float s1 = 1.0f) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    if (row < len)
      *reinterpret_cast<uint32_t*>(head + (int64_t)row * kD + 8 * j + qcol) =
          pack_bf16(acc[4 * j] * s0, acc[4 * j + 1] * s0);
    if (row + 8 < len)
      *reinterpret_cast<uint32_t*>(head + (int64_t)(row + 8) * kD + 8 * j + qcol) =
          pack_bf16(acc[4 * j + 2] * s1, acc[4 * j + 3] * s1);
  }
}

// The work item of a 1-D grid of (own tile, head, batch): for a shared slab
// (heads_group > 1) the head fastest, so the heads reading one bias tile run
// together; for per-head slabs the own tile fastest.
struct Item {
  int t0, h, b;
};

__device__ __forceinline__ Item item_of(int w, int tiles, int H, int heads_group) {
  if (heads_group > 1) return {(w / H) % tiles * kOwn, w % H, w / (H * tiles)};
  return {(w % tiles) * kOwn, (w / tiles) % H, w / (tiles * H)};
}

template <typename Smem>
__device__ __forceinline__ Smem& smem_at_1024() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return *reinterpret_cast<Smem*>(smem_raw + pad);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct alignas(1024) FwdSmem {
  uint8_t q[kOwnTile];
  uint8_t k[kFwdStages][kFwdTile];
  uint8_t v[kFwdStages][kFwdTile];
  uint8_t bias[kFwdStages][kFwdBias];         // [128 q][kFwdN k], panels of 32 keys
  uint64_t q_full;
  uint64_t full[kFwdStages];
  uint64_t empty[kFwdStages];
};

__global__ void __launch_bounds__(kThreads, 1)
flash_dense_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_bias,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                            int H, int Lq, int Lk, int heads_group, float scale) {
  FwdSmem& sm = smem_at_1024<FwdSmem>();
  const Item it = item_of(blockIdx.x, (Lq + kOwn - 1) / kOwn, H, heads_group);
  const int q0 = it.t0;
  const int64_t bh = (int64_t)it.b * H + it.h;
  const int slab = (int)(bh / heads_group);
  const int n_tiles = (Lk + kFwdN - 1) / kFwdN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_ring(&sm.q_full, sm.full, sm.empty, kFwdStages, 1);

  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    mbar_arrive_expect_tx(&sm.q_full, kOwnTile);
    for (int p = 0; p < kPanels; ++p)
      tma_load(sm.q + p * kOwnPanel, &tm_q, &sm.q_full, p * 64, q0, it.h, it.b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kFwdStages;
      mbar_wait(&sm.empty[s], ((t / kFwdStages) & 1) ^ 1);
      const int k0 = t * kFwdN;
      mbar_arrive_expect_tx(&sm.full[s], 2 * kFwdTile + kFwdBias);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.k[s] + p * kFwdPanel, &tm_k, &sm.full[s], p * 64, k0, it.h, it.b);
        tma_load(sm.v[s] + p * kFwdPanel, &tm_v, &sm.full[s], p * 64, k0, it.h, it.b);
      }
      for (int p = 0; p < kFwdN / 32; ++p)
        tma_load(sm.bias[s] + p * kOwn * 128, &tm_bias, &sm.full[s], k0 + 32 * p, q0, slab,
                 0);
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows [q0 + 64 cw, +64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;
  const int row = cw * 64 + warp * 16 + lane / 4;  // tile row (and row + 8)
  const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;
  constexpr float kMaskedLog2 = kMaskedAt * kLog2e;
  float o[kAccD];
#pragma unroll
  for (int i = 0; i < kAccD; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf * kLog2e, kNegInf * kLog2e};  // running max, log2 units
  float l[2] = {0.0f, 0.0f};
  mbar_wait(&sm.q_full, 0);
  // ping-pong: warpgroup 1 lets warpgroup 0 issue the first S
  if (cw == 1) asm volatile("bar.arrive 3, 256;" ::: "memory");

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kFwdStages;
    mbar_wait(&sm.full[s], (t / kFwdStages) & 1);
    float sacc[kFwdN / 2];
    asm volatile("bar.sync %0, 256;" ::"r"(3 + cw) : "memory");
    fence_regs(sacc);
    wgmma_fence();
    product_k_major(sacc, q_addr, kOwnPanel, smem_u32(sm.k[s]), kFwdPanel);
    wgmma_commit();
    asm volatile("bar.arrive %0, 256;" ::"r"(3 + (cw ^ 1)) : "memory");
    wgmma_wait_all();
    fence_regs(sacc);

    // the biased logits in log2 units; keys past Lk at -inf, out of the max
    const int limit = Lk - t * kFwdN;
    const uint8_t* btile = sm.bias[s];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kFwdN / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bv = *reinterpret_cast<const float2*>(
            btile + bias_offset(kOwn, row + 8 * r, 8 * j + qcol));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sacc[4 * j + 2 * r + e];
          const float sv = biased_logit(x, scale, e ? bv.y : bv.x);
          x = 8 * j + qcol + e < limit ? sv * kLog2e : -INFINITY;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t pa[kFwdN / 4];
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kFwdN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = sacc[4 * j + i];
        // masked (s <= -5e29) and past-end entries: p = 0 explicitly
        p[i] = x > kMaskedLog2 ? fast_exp2(x - m[i / 2]) : 0.0f;
      }
      psum[0] += p[0] + p[1];
      psum[1] += p[2] + p[3];
      pa[2 * j] = pack_bf16(p[0], p[1]);
      pa[2 * j + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    fence_regs(o);
    wgmma_fence();
    product_rs<kFwdN>(o, pa, smem_u32(sm.v[s]));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    release(&sm.empty[s], lane);
  }
  // the one turn arrival no S consumed
  if (cw == 0) asm volatile("bar.sync 3, 256;" ::: "memory");

  // ---- epilogue: O / l and lse from the registers ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.0f / (l[0] == 0.0f ? 1.0f : l[0]);
  const float inv1 = 1.0f / (l[1] == 0.0f ? 1.0f : l[1]);
  store_rows(out + bh * Lq * kD + (int64_t)q0 * kD, row, Lq - q0, qcol, o, inv0, inv1);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = q0 + row + 8 * r;
      if (qrow < Lq) lse[bh * Lq + qrow] = l[r] == 0.0f ? kLseMasked : m[r] * kLn2 + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

struct alignas(1024) DkvSmem {
  uint8_t k[kOwnTile];
  uint8_t v[kOwnTile];
  uint8_t q[kBwdStages][kWalkTile];
  uint8_t dout[kBwdStages][kWalkTile];
  uint8_t bias[kBwdStages][kBiasTile];        // [64 q][128 k], 4 panels
  float lse[kBwdStages][kWalk];               // lse * log2(e), +inf past Lq
  float delta[kBwdStages][kWalk];
  uint64_t kv_full;
  uint64_t full[kBwdStages];
  uint64_t empty[kBwdStages];
};

__global__ void __launch_bounds__(kThreads, 1)
flash_dense_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_bias,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                                int heads_group, float scale) {
  DkvSmem& sm = smem_at_1024<DkvSmem>();
  const Item it = item_of(blockIdx.x, (Lk + kOwn - 1) / kOwn, H, heads_group);
  const int k0 = it.t0;
  const int64_t bh = (int64_t)it.b * H + it.h;
  const int slab = (int)(bh / heads_group);
  const int n_tiles = (Lq + kWalk - 1) / kWalk;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_ring(&sm.kv_full, sm.full, sm.empty, kBwdStages, 32);

  if (wg == 0) {
    // ---- producer: the first warp; lane 0 issues the loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv_full, 2 * kOwnTile);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.k + p * kOwnPanel, &tm_k, &sm.kv_full, p * 64, k0, it.h, it.b);
        tma_load(sm.v + p * kOwnPanel, &tm_v, &sm.kv_full, p * 64, k0, it.h, it.b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kBwdStages;
      mbar_wait(&sm.empty[s], ((t / kBwdStages) & 1) ^ 1);
      const int q0 = t * kWalk;
      for (int j = lane; j < kWalk; j += 32) {
        const bool in = q0 + j < Lq;
        sm.lse[s][j] = in ? lse[bh * Lq + q0 + j] * kLog2e : INFINITY;
        sm.delta[s][j] = in ? delta[bh * Lq + q0 + j] : 0.0f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * kWalkTile + kBiasTile);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.q[s] + p * kWalkPanel, &tm_q, &sm.full[s], p * 64, q0, it.h, it.b);
          tma_load(sm.dout[s] + p * kWalkPanel, &tm_do, &sm.full[s], p * 64, q0, it.h,
                   it.b);
        }
        for (int p = 0; p < kOwn / 32; ++p)
          tma_load(sm.bias[s] + p * kWalk * 128, &tm_bias, &sm.full[s], k0 + 32 * p, q0,
                   slab, 0);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys [k0 + 64 cw, +64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;
  const int row = cw * 64 + warp * 16 + lane / 4;  // key row in the CTA tile (and row + 8)
  const bool kept[2] = {k0 + row < Lk, k0 + row + 8 < Lk};
  float dk_acc[kAccD], dv_acc[kAccD];
#pragma unroll
  for (int i = 0; i < kAccD; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  const uint32_t k_addr = smem_u32(sm.k) + cw * 64 * 128;
  const uint32_t v_addr = smem_u32(sm.v) + cw * 64 * 128;

  mbar_wait(&sm.kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kBwdStages;
    mbar_wait(&sm.full[s], (t / kBwdStages) & 1);
    const uint32_t q_addr = smem_u32(sm.q[s]);
    const uint32_t do_addr = smem_u32(sm.dout[s]);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns this tile's queries
    float sacc[kAccS], dpacc[kAccS];
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
    product_k_major(sacc, k_addr, kOwnPanel, q_addr, kWalkPanel);
    wgmma_commit();
    product_k_major(dpacc, v_addr, kOwnPanel, do_addr, kWalkPanel);
    wgmma_commit();

    // p on the S^T fragment while dP^T is in flight: sacc[4j + 2r + e] is
    // (key row + 8r, query 8j + qcol + e); the bias tile is [query][key]
    wgmma_wait<1>();
    fence_regs(sacc);
    const uint8_t* btile = sm.bias[s];
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + qcol + e;
        const float ll = sm.lse[s][qc];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = sacc[4 * j + 2 * r + e];
          const float bv =
              *reinterpret_cast<const float*>(btile + bias_offset(kWalk, qc, row + 8 * r));
          x = kept[r] ? prob(biased_logit(x, scale, bv), ll) : 0.0f;
        }
      }
    }
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
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    product_rs(dv_acc, pa, do_addr);
    product_rs(dk_acc, dsa, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    release(&sm.empty[s], lane);
  }
  const int64_t head = (bh * Lk + k0) * kD;
  store_rows(dk + head, row, Lk - k0, qcol, dk_acc);
  store_rows(dv + head, row, Lk - k0, qcol, dv_acc);
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

struct alignas(1024) DqSmem {
  uint8_t q[kOwnTile];
  uint8_t dout[kOwnTile];
  uint8_t k[kBwdStages][kWalkTile];
  uint8_t v[kBwdStages][kWalkTile];
  uint8_t bias[kBwdStages][kBiasTile];        // [128 q][64 k], 2 panels
  uint64_t own_full;
  uint64_t full[kBwdStages];
  uint64_t empty[kBwdStages];
};

__global__ void __launch_bounds__(kThreads, 1)
flash_dense_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_bias,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                               int heads_group, float scale) {
  DqSmem& sm = smem_at_1024<DqSmem>();
  const Item it = item_of(blockIdx.x, (Lq + kOwn - 1) / kOwn, H, heads_group);
  const int q0 = it.t0;
  const int64_t bh = (int64_t)it.b * H + it.h;
  const int slab = (int)(bh / heads_group);
  const int n_tiles = (Lk + kWalk - 1) / kWalk;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_ring(&sm.own_full, sm.full, sm.empty, kBwdStages, 1);

  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    mbar_arrive_expect_tx(&sm.own_full, 2 * kOwnTile);
    for (int p = 0; p < kPanels; ++p) {
      tma_load(sm.q + p * kOwnPanel, &tm_q, &sm.own_full, p * 64, q0, it.h, it.b);
      tma_load(sm.dout + p * kOwnPanel, &tm_do, &sm.own_full, p * 64, q0, it.h, it.b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kBwdStages;
      mbar_wait(&sm.empty[s], ((t / kBwdStages) & 1) ^ 1);
      const int k0 = t * kWalk;
      mbar_arrive_expect_tx(&sm.full[s], 2 * kWalkTile + kBiasTile);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sm.k[s] + p * kWalkPanel, &tm_k, &sm.full[s], p * 64, k0, it.h, it.b);
        tma_load(sm.v[s] + p * kWalkPanel, &tm_v, &sm.full[s], p * 64, k0, it.h, it.b);
      }
      for (int p = 0; p < kWalk / 32; ++p)
        tma_load(sm.bias[s] + p * kOwn * 128, &tm_bias, &sm.full[s], k0 + 32 * p, q0, slab,
                 0);
    }
    return;
  }

  // ---- consumers: warpgroup cw owns queries [q0 + 64 cw, +64) ----
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
    row_lse[r] = qrow < Lq ? lse[bh * Lq + qrow] * kLog2e : INFINITY;
    row_delta[r] = qrow < Lq ? delta[bh * Lq + qrow] : 0.0f;
  }
  float dq_acc[kAccD];
#pragma unroll
  for (int i = 0; i < kAccD; ++i) dq_acc[i] = 0.0f;
  const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;
  const uint32_t do_addr = smem_u32(sm.dout) + cw * 64 * 128;

  mbar_wait(&sm.own_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kBwdStages;
    mbar_wait(&sm.full[s], (t / kBwdStages) & 1);
    const uint32_t k_addr = smem_u32(sm.k[s]);
    const uint32_t v_addr = smem_u32(sm.v[s]);

    // S = Q K^T and dP = dO V^T: rows queries, columns this tile's keys
    float sacc[kAccS], dpacc[kAccS];
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
    product_k_major(sacc, q_addr, kOwnPanel, k_addr, kWalkPanel);
    wgmma_commit();
    product_k_major(dpacc, do_addr, kOwnPanel, v_addr, kWalkPanel);
    wgmma_commit();

    wgmma_wait<1>();
    fence_regs(sacc);
    const int limit = Lk - t * kWalk;
    const uint8_t* btile = sm.bias[s];
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bv = *reinterpret_cast<const float2*>(
            btile + bias_offset(kOwn, row + 8 * r, 8 * j + qcol));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sacc[4 * j + 2 * r + e];
          x = 8 * j + qcol + e < limit
                  ? prob(biased_logit(x, scale, e ? bv.y : bv.x), row_lse[r]) : 0.0f;
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
        ds[i] = __fmul_rn(__fmul_rn(sacc[4 * j + i],
                                    __fsub_rn(dpacc[4 * j + i], row_delta[i / 2])),
                          scale);
      dsa[2 * j] = pack_bf16(ds[0], ds[1]);
      dsa[2 * j + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K, K MN-major
    fence_regs(dq_acc);
    wgmma_fence();
    product_rs(dq_acc, dsa, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    release(&sm.empty[s], lane);
  }
  store_rows(dq + (bh * Lq + q0) * kD, row, Lq - q0, qcol, dq_acc);
}

// ---------------------------------------------------------------------------
// dBias
// ---------------------------------------------------------------------------

struct alignas(1024) DbSmem {
  uint8_t q[kBwdStages][kOwnTile];
  uint8_t dout[kBwdStages][kOwnTile];
  uint8_t k[kBwdStages][kWalkTile];
  uint8_t v[kBwdStages][kWalkTile];
  float lse[kBwdStages][kOwn];                // lse * log2(e), +inf past Lq
  float delta[kBwdStages][kOwn];
  uint64_t full[kBwdStages];
  uint64_t empty[kBwdStages];
};

// Grid (key tiles of 64, query tiles of 128, slabs).
__global__ void __launch_bounds__(kThreads, 1)
flash_dense_bwd_db_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const float* __restrict__ bias, float* __restrict__ db,
                               int H, int Lq, int Lk, int heads_group, float scale) {
  DbSmem& sm = smem_at_1024<DbSmem>();
  const int k0 = blockIdx.x * kWalk;
  const int q0 = blockIdx.y * kOwn;
  const int64_t slab = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  init_ring(nullptr, sm.full, sm.empty, kBwdStages, 32);

  if (wg == 0) {
    // ---- producer: the first warp, one stage per head of the slab ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 32) return;
    const int lane = tid;
    for (int hh = 0; hh < heads_group; ++hh) {
      const int s = hh % kBwdStages;
      mbar_wait(&sm.empty[s], ((hh / kBwdStages) & 1) ^ 1);
      const int64_t bh = slab * heads_group + hh;
      const int h = (int)(bh % H), b = (int)(bh / H);
      for (int j = lane; j < kOwn; j += 32) {
        const bool in = q0 + j < Lq;
        sm.lse[s][j] = in ? lse[bh * Lq + q0 + j] * kLog2e : INFINITY;
        sm.delta[s][j] = in ? delta[bh * Lq + q0 + j] : 0.0f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * kOwnTile + 2 * kWalkTile);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.q[s] + p * kOwnPanel, &tm_q, &sm.full[s], p * 64, q0, h, b);
          tma_load(sm.dout[s] + p * kOwnPanel, &tm_do, &sm.full[s], p * 64, q0, h, b);
          tma_load(sm.k[s] + p * kWalkPanel, &tm_k, &sm.full[s], p * 64, k0, h, b);
          tma_load(sm.v[s] + p * kWalkPanel, &tm_v, &sm.full[s], p * 64, k0, h, b);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns queries [q0 + 64 cw, +64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;
  const int row = cw * 64 + warp * 16 + lane / 4;  // query row in the CTA tile (and row + 8)
  const int limit = Lk - k0;
  // this thread's bias entries, read once: (row + 8r, 8j + qcol + e) at
  // [4j + 2r + e], as the S fragment holds them
  const float* bias_tile = bias + (slab * Lq + q0) * (int64_t)Lk + k0;
  float bfrag[kAccS], acc[kAccS];
#pragma unroll
  for (int j = 0; j < kWalk / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row + 8 * r, kc = 8 * j + qcol;
      float2 bv = make_float2(0.0f, 0.0f);
      if (q0 + qr < Lq && kc < limit)  // Lk % 4 == 0: a pair is wholly in or out
        bv = *reinterpret_cast<const float2*>(bias_tile + (int64_t)qr * Lk + kc);
      bfrag[4 * j + 2 * r] = bv.x;
      bfrag[4 * j + 2 * r + 1] = bv.y;
      acc[4 * j + 2 * r] = acc[4 * j + 2 * r + 1] = 0.0f;
    }
  }
  const int own_off = cw * 64 * 128;

  for (int hh = 0; hh < heads_group; ++hh) {
    const int s = hh % kBwdStages;
    mbar_wait(&sm.full[s], (hh / kBwdStages) & 1);
    float sacc[kAccS], dpacc[kAccS];
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
    product_k_major(sacc, smem_u32(sm.q[s]) + own_off, kOwnPanel, smem_u32(sm.k[s]),
                    kWalkPanel);
    wgmma_commit();
    product_k_major(dpacc, smem_u32(sm.dout[s]) + own_off, kOwnPanel, smem_u32(sm.v[s]),
                    kWalkPanel);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);
    const float ll[2] = {sm.lse[s][row], sm.lse[s][row + 8]};
    const float dl[2] = {sm.delta[s][row], sm.delta[s][row + 8]};
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i / 2;
        const float p = 8 * j + qcol + i % 2 < limit
                            ? prob(biased_logit(sacc[4 * j + i], scale, bfrag[4 * j + i]),
                                   ll[r])
                            : 0.0f;
        acc[4 * j + i] = __fadd_rn(acc[4 * j + i],
                                   __fmul_rn(p, __fsub_rn(dpacc[4 * j + i], dl[r])));
      }
    }
    release(&sm.empty[s], lane);
  }
  float* db_tile = db + (slab * Lq + q0) * (int64_t)Lk + k0;
#pragma unroll
  for (int j = 0; j < kWalk / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = row + 8 * r, kc = 8 * j + qcol;
      if (q0 + qr < Lq && kc < limit)
        *reinterpret_cast<float2*>(db_tile + (int64_t)qr * Lk + kc) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Tensor map of a contiguous [B, H, L, kD] bf16 tensor, boxes of `rows` rows.
static int head_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int rows) {
  const long long sl = kD, sh = (long long)L * kD, sb = (long long)H * sh;
  return make_map(map, ptr, B, H, L, kD, sb, sh, sl, rows);
}

// Tensor map of the f32 bias slabs [Bb, Lq, Lk]: boxes of 32 columns (128
// bytes, one swizzle row) x `rows` query rows.
static int bias_map(CUtensorMap* map, const void* ptr, int slabs, int Lq, int Lk,
                    int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)Lk, (cuuint64_t)Lq, (cuuint64_t)slabs, 1};
  const cuuint64_t row_bytes = (cuuint64_t)Lk * 4;
  const cuuint64_t slab_bytes = row_bytes * Lq;
  const cuuint64_t strides[3] = {row_bytes, slab_bytes, slab_bytes * slabs};
  const cuuint32_t box[4] = {32, (cuuint32_t)rows, 1, 1};
  return make_map_raw(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides, box);
}

template <typename Smem, typename Kernel>
static int prepare(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem) + 1024));
}

static int check_args(int B, int H, int Lk, int heads_group, int d) {
  if (d != kD || Lk % 4 != 0 || heads_group <= 0 || (B * H) % heads_group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace avatar_dense_sm90

// C entries for ctypes, with the arguments of flash_dense.cu's. `bias` is
// [B*H / heads_group, Lq, Lk] f32 with Lk % 4 == 0. Each returns a
// cudaError_t (0 = success).
extern "C" int flash_dense_fwd_sm90_bf16(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, void* lse, int B,
                                         int H, int Lq, int Lk, int heads_group, int d,
                                         float scale, void* stream) {
  using namespace avatar_dense_sm90;
  int err = check_args(B, H, Lk, heads_group, d);
  CUtensorMap tq, tk, tv, tb;
  if (!err) err = head_map(&tq, q, B, H, Lq, kOwn);
  if (!err) err = head_map(&tk, k, B, H, Lk, kFwdN);
  if (!err) err = head_map(&tv, v, B, H, Lk, kFwdN);
  if (!err) err = bias_map(&tb, bias, B * H / heads_group, Lq, Lk, kOwn);
  if (!err) err = prepare<FwdSmem>(flash_dense_fwd_sm90_kernel);
  if (err) return err;
  const int items = (Lq + kOwn - 1) / kOwn * H * B;
  flash_dense_fwd_sm90_kernel<<<items, kThreads, sizeof(FwdSmem) + 1024,
                                static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tb, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Lq,
      Lk, heads_group, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dense_bwd_dkv_sm90_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, const void* bias,
                                             void* dk, void* dv, int B, int H, int Lq,
                                             int Lk, int heads_group, int d, float scale,
                                             void* stream) {
  using namespace avatar_dense_sm90;
  int err = check_args(B, H, Lk, heads_group, d);
  CUtensorMap tq, tk, tv, tdo, tb;
  if (!err) err = head_map(&tq, q, B, H, Lq, kWalk);
  if (!err) err = head_map(&tdo, dout, B, H, Lq, kWalk);
  if (!err) err = head_map(&tk, k, B, H, Lk, kOwn);
  if (!err) err = head_map(&tv, v, B, H, Lk, kOwn);
  if (!err) err = bias_map(&tb, bias, B * H / heads_group, Lq, Lk, kWalk);
  if (!err) err = prepare<DkvSmem>(flash_dense_bwd_dkv_sm90_kernel);
  if (err) return err;
  const int items = (Lk + kOwn - 1) / kOwn * H * B;
  flash_dense_bwd_dkv_sm90_kernel<<<items, kThreads, sizeof(DkvSmem) + 1024,
                                    static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, tb, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Lq, Lk,
      heads_group, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dense_bwd_dq_sm90_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, const void* bias, void* dq,
                                            int B, int H, int Lq, int Lk, int heads_group,
                                            int d, float scale, void* stream) {
  using namespace avatar_dense_sm90;
  int err = check_args(B, H, Lk, heads_group, d);
  CUtensorMap tq, tk, tv, tdo, tb;
  if (!err) err = head_map(&tq, q, B, H, Lq, kOwn);
  if (!err) err = head_map(&tdo, dout, B, H, Lq, kOwn);
  if (!err) err = head_map(&tk, k, B, H, Lk, kWalk);
  if (!err) err = head_map(&tv, v, B, H, Lk, kWalk);
  if (!err) err = bias_map(&tb, bias, B * H / heads_group, Lq, Lk, kOwn);
  if (!err) err = prepare<DqSmem>(flash_dense_bwd_dq_sm90_kernel);
  if (err) return err;
  const int items = (Lq + kOwn - 1) / kOwn * H * B;
  flash_dense_bwd_dq_sm90_kernel<<<items, kThreads, sizeof(DqSmem) + 1024,
                                   static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, tb, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Lq, Lk, heads_group, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dense_bwd_db_sm90_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, const void* bias, void* db,
                                            int B, int H, int Lq, int Lk, int heads_group,
                                            int d, float scale, void* stream) {
  using namespace avatar_dense_sm90;
  int err = check_args(B, H, Lk, heads_group, d);
  CUtensorMap tq, tk, tv, tdo;
  if (!err) err = head_map(&tq, q, B, H, Lq, kOwn);
  if (!err) err = head_map(&tdo, dout, B, H, Lq, kOwn);
  if (!err) err = head_map(&tk, k, B, H, Lk, kWalk);
  if (!err) err = head_map(&tv, v, B, H, Lk, kWalk);
  if (!err) err = prepare<DbSmem>(flash_dense_bwd_db_sm90_kernel);
  if (err) return err;
  dim3 grid((Lk + kWalk - 1) / kWalk, (Lq + kOwn - 1) / kOwn, B * H / heads_group);
  flash_dense_bwd_db_sm90_kernel<<<grid, kThreads, sizeof(DbSmem) + 1024,
                                   static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<float*>(db), H, Lq, Lk, heads_group,
      scale);
  return static_cast<int>(cudaGetLastError());
}
