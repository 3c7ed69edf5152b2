// The consumer side of the Hopper (sm_90a) attention forward kernels,
// shared by flash_forward_sm90.cu (C, D, E), token_attention_sm90.cu (B)
// and rope_attention_sm90.cu (A): the tile shape, S = Q K^T by wgmma, the
// softmax on the accumulator fragment, O += P V with P as the register A
// operand, and the epilogue; and the whole kernel of the forwards whose
// producer only issues TMA loads (B, C, D, E: fwd_sm90).
//
// Persistent: one CTA of kThreads = 384 per SM walks work items of
// (batch, head, kBlockM = 128 query rows): warpgroup 0 produces (each
// kernel its own way), warpgroups 1 and 2 consume 64 rows each. The
// producer fills a ring of kStages stages, each one K tile and one V tile
// of kBlockN = 128 keys in 128-byte-swizzled panels of 64 columns
// (sm90.cuh), signals a stage's full mbarrier when it has landed and waits
// on its empty mbarrier (one arrival per consumer warp) before refilling
// it; its ring positions run on from one item to the next. The Q tile
// sits in the same panel layout and is refilled for the next item once
// both consumers have issued their last S; each consumer stages its O rows
// in an O tile for a TMA store that completes under the next item. So one
// item's epilogue and the next one's loads overlap the compute, where a
// CTA per item would expose them at every item.
//
// Softmax modes (exp2 of the logits times log2(e), folded into the scale):
// - kModeBounded: p = exp(min(s, 80)), no max (qk-normed logits);
// - kModeOnline: running max, O and l rescaled when it rises;
// - kModeSingle: the whole-row max in a first pass over the key tiles (S
//   alone; the producer streams K alone), then p = exp(s - m) against
//   that fixed max in a second pass over K and V again, no rescale.
// Masked keys (keep flag 0) sit at -1e30 for the max and past-end keys
// (flag -1) at -inf; both get p = 0. A row with no kept key returns O = 0
// and lse = 1e30. kSumRounded: l sums the bf16-rounded p (the values the
// PV product uses) instead of the f32 p.
//
// Ping-pong: the two consumer warpgroups take turns to issue their S = Q
// K^T (named barriers 3 and 4), so that one's softmax runs while the
// other's products do (FlashAttention-3's warp-scheduler barrier).
#pragma once

#include "sm90.cuh"

#ifndef ATTN_D
#define ATTN_D 64
#endif

namespace avatar_sm90 {

constexpr int kD = ATTN_D;
static_assert(kD == 64 || kD == 128, "the Hopper kernels take head_dim 64 or 128");
constexpr int kBlockM = 128;                 // query rows per work item
constexpr int kBlockN = 128;                 // keys per stage
constexpr int kPanels = kD / 64;             // 64-column swizzle panels
constexpr int kPanelBytes = 128 * 128;       // 128 rows x 128 bytes
constexpr int kTileBytes = kPanels * kPanelBytes;
constexpr int kThreads = 384;
constexpr int kO = kD / 2;                   // O accumulator registers per thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kBoundedClamp = 80.0f;
constexpr float kNegInf = -1e30f;            // a masked logit
constexpr float kLseMasked = 1e30f;

constexpr int kModeBounded = 0;
constexpr int kModeOnline = 1;
constexpr int kModeSingle = 2;

// Ring positions a CTA walks over n_tiles key tiles: one per tile, or two
// in the whole-row mode (positions n_tiles + t carry K and V, positions t
// below n_tiles K alone).
__device__ __forceinline__ int ring_positions(int mode, int n_tiles) {
  return mode == kModeSingle ? 2 * n_tiles : n_tiles;
}

// Byte offset of element column `col` (a multiple of 8) of row `row` in a
// K-major 128-byte-swizzled tile of 128 rows: 16-byte chunk c of a row sits
// at c ^ (row % 8), as TMA's 128-byte swizzle lays it out.
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col) {
  return (col / 64) * kPanelBytes + row * 128 + ((((col % 64) / 8) ^ (row % 8)) * 16);
}

// Keep flag of key column `col` of the tile: staged flags (1 kept, 0
// masked, -1 past end) with a mask, else kept below `limit`.
template <bool kMask>
__device__ __forceinline__ float key_flag(const float* keep, int col, int limit) {
  if constexpr (kMask) return keep[col];
  return col < limit ? 1.0f : -1.0f;
}

// S = Q K^T for this warpgroup's 64 rows against one K tile, taking its
// ping-pong turn.
__device__ __forceinline__ void qk_product(float (&sacc)[64], uint32_t q_addr,
                                           uint32_t k_addr, int cw) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + cw) : "memory");
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss_n128(sacc, sw128_desc(q_addr + off, 16, 1024),
                  sw128_desc(k_addr + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  asm volatile("bar.arrive %0, 256;" ::"r"(3 + (cw ^ 1)) : "memory");
  wgmma_wait_all();
  fence_regs(sacc);
}

// The max of this thread's two rows over one tile (log2 units, masked keys
// at -1e30, past-end keys -inf), reduced over the row's quad. sacc[4j + e]
// is (row r, column 8j + qcol + e), sacc[4j + 2 + e] (row r + 8, the same
// column). With kStore the scaled, masked logits replace sacc.
template <bool kMask, bool kStore>
__device__ __forceinline__ void tile_row_max(float (&sacc)[64], const float* keep,
                                             int limit, int qcol, float scale_log2,
                                             float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float flag = key_flag<kMask>(keep, 8 * j + qcol + e, limit);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = sacc[4 * j + 2 * r + e] * scale_log2;
        x = flag > 0.5f ? x : (flag < -0.5f ? -INFINITY : kNegInf);
        if (kStore) sacc[4 * j + 2 * r + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// p of one tile on the fragment, l and O updated, then O += P V against the
// stage's V tile. kMode kModeSingle: `m` is the whole-row max (fixed).
template <int kMode, bool kMask, bool kSumRounded>
__device__ __forceinline__ void softmax_pv(float (&sacc)[64], float (&o)[kO],
                                           float (&m)[2], float (&l)[2],
                                           const float* keep, int limit, int qcol,
                                           float scale_log2, uint32_t v_addr) {
  float alpha[2] = {1.0f, 1.0f};
  if (kMode == kModeOnline) {
    float mx[2];
    tile_row_max<kMask, true>(sacc, keep, limit, qcol, scale_log2, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
  }
  uint32_t pa[32];
  float psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool kept = key_flag<kMask>(keep, 8 * j + qcol + e, limit) > 0.5f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x = sacc[4 * j + 2 * r + e];
        float pv;
        if (kMode == kModeBounded)
          pv = fast_exp2(fminf(x * scale_log2, kBoundedClamp * kLog2e));
        else if (kMode == kModeOnline)
          pv = fast_exp2(x - m[r]);
        else
          pv = fast_exp2(x * scale_log2 - m[r]);
        p[2 * r + e] = kept ? pv : 0.0f;
      }
    }
    // A operand of k-slice j / 2: regs (row r, cols lo), (row r + 8, cols
    // lo), (row r, cols lo + 8), (row r + 8, cols lo + 8)
    const uint32_t top = pack_bf16(p[0], p[1]);
    const uint32_t bottom = pack_bf16(p[2], p[3]);
    pa[(j / 2) * 4 + (j % 2) * 2 + 0] = top;
    pa[(j / 2) * 4 + (j % 2) * 2 + 1] = bottom;
    if (kSumRounded) {
      const __nv_bfloat162 tb = *reinterpret_cast<const __nv_bfloat162*>(&top);
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(&bottom);
      const float2 tf = __bfloat1622float2(tb);
      const float2 bf = __bfloat1622float2(bb);
      psum[0] += tf.x + tf.y;
      psum[1] += bf.x + bf.y;
    } else {
      psum[0] += p[0] + p[1];
      psum[1] += p[2] + p[3];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
  if (kMode == kModeOnline) {
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_rs<kO>(o, pa + 4 * kk, sw128_desc(v_addr + kk * 16 * 128, kPanelBytes, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

// A CTA's work items: (q tile, head, batch), the q tile fastest so that
// the CTAs running at once share their heads' K and V in L2. CTA c takes
// items c, c + gridDim.x, ...
struct WorkItem {
  int q0, h, b;
};

__device__ __forceinline__ WorkItem work_item(int w, int q_tiles, int H) {
  return {(w % q_tiles) * kBlockM, (w / q_tiles) % H, w / (q_tiles * H)};
}

// The shared memory a consumer reads: the Q tile (q_full when it has
// landed; each consumer warp arrives on q_empty after its item's last S),
// the O staging tile, and the ring: stage s holds K at k + s * kTileBytes,
// V at v + s * kTileBytes and, with a mask, its keep flags at keep + s *
// kBlockN.
struct FwdRing {
  uint8_t* q;
  uint8_t* o;
  uint8_t* k;
  uint8_t* v;
  const float* keep;
  uint64_t* q_full;
  uint64_t* q_empty;
  uint64_t* full;
  uint64_t* empty;
};

// One consumer warpgroup (cw = 0 or 1, thread tid of 128) over this CTA's
// work items: for each, every key tile of Lk through the ring (positions
// counted across items, as the producer counts them), then its epilogue:
// O / l in bf16 staged in rows 64 cw of the O tile and stored by TMA into
// tm_o at (column 0, row q0 + 64 cw, head h, batch b), clipped past Lq,
// while the next item runs; with `lse` ([B, H, Lq], or null) the row
// log-sum-exp.
template <int kMode, bool kMask, bool kSumRounded, int kStages>
__device__ __forceinline__ void consume(const FwdRing& ring, int cw, int tid, int B, int H,
                                        int Lq, int Lk, float scale_log2,
                                        const CUtensorMap* tm_o, float* lse) {
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;  // first of this thread's two columns per 8
  const int n_tiles = (Lk + kBlockN - 1) / kBlockN;
  const int q_tiles = (Lq + kBlockM - 1) / kBlockM;
  const int n_items = q_tiles * H * B;
  const int row = cw * 64 + warp * 16 + lane / 4;  // this thread's row in the tile
  const uint32_t q_addr = smem_u32(ring.q) + cw * 64 * 128;
  auto keep_of = [&](int s) { return kMask ? ring.keep + s * kBlockN : nullptr; };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // ping-pong turns run on across items: one arrival ahead here, consumed
  // after the last item
  if (cw == 1) asm volatile("bar.arrive 3, 256;" ::: "memory");
  int pos = 0;  // ring position
  int it = 0;   // this CTA's item count
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
    const WorkItem wi = work_item(w, q_tiles, H);
    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.0f;
    // this thread's two rows r and r + 8: max (log2 units) and sum
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    mbar_wait(ring.q_full, it & 1);
    if (kMode == kModeSingle) {
      // pass 1: the row max over every key
      for (int t = 0; t < n_tiles; ++t, ++pos) {
        const int s = pos % kStages;
        mbar_wait(&ring.full[s], (pos / kStages) & 1);
        float sacc[64];
        qk_product(sacc, q_addr, smem_u32(ring.k + s * kTileBytes), cw);
        float mx[2];
        tile_row_max<kMask, false>(sacc, keep_of(s), Lk - t * kBlockN, qcol, scale_log2,
                                   mx);
        m[0] = fmaxf(m[0], mx[0]);
        m[1] = fmaxf(m[1], mx[1]);
        release(&ring.empty[s]);
      }
    }
    for (int t = 0; t < n_tiles; ++t, ++pos) {
      const int s = pos % kStages;
      mbar_wait(&ring.full[s], (pos / kStages) & 1);
      float sacc[64];
      qk_product(sacc, q_addr, smem_u32(ring.k + s * kTileBytes), cw);
      // the item's last S: the producer may load the next Q
      if (t == n_tiles - 1) release(ring.q_empty);
      softmax_pv<kMode, kMask, kSumRounded>(sacc, o, m, l, keep_of(s), Lk - t * kBlockN,
                                            qcol, scale_log2,
                                            smem_u32(ring.v + s * kTileBytes));
      release(&ring.empty[s]);
    }

    // ---- epilogue ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.0f / (l[0] == 0.0f ? 1.0f : l[0]);
    const float inv1 = 1.0f / (l[1] == 0.0f ? 1.0f : l[1]);
    // the previous item's store has read this warpgroup's staging rows
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j;
      uint8_t* dst = ring.o + swizzled_offset(row, col) + qcol * 2;
      uint8_t* dst8 = ring.o + swizzled_offset(row + 8, col) + qcol * 2;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(dst8) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (tid == 0 && wi.q0 + cw * 64 < Lq) {
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_store(tm_o, ring.o + p * kPanelBytes + cw * 64 * 128, p * 64,
                  wi.q0 + cw * 64, wi.h, wi.b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (lse != nullptr && lane % 4 == 0) {
      float* lse_head = lse + ((int64_t)wi.b * H + wi.h) * Lq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qrow = wi.q0 + row + 8 * r;
        if (qrow < Lq) {
          float val = kLseMasked;
          if (l[r] != 0.0f) val = (kMode == kModeBounded ? 0.0f : m[r] * kLn2) + logf(l[r]);
          lse_head[qrow] = val;
        }
      }
    }
  }
  // the one turn arrival no S consumed
  if (cw == 0) asm volatile("bar.sync 3, 256;" ::: "memory");
  // the staging rows stay valid until the last store has read them
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// CTAs of a persistent launch: one per SM, at most one per work item.
static int persistent_ctas(int n_items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return n_items < sms ? n_items : sms;
}

// ---------------------------------------------------------------------------
// The body of the forwards whose producer only issues TMA loads (B, C, D,
// E): q, k, v and o each through one 4-D tensor map (d, L, H, B) built from
// its strides, so a tile past a head's last row reads TMA's zero fill,
// never the next head's rows
// ---------------------------------------------------------------------------

template <int kStages>
struct alignas(1024) FwdSmem {
  uint8_t q[kTileBytes];
  uint8_t o[kTileBytes];                     // the O staging
  uint8_t k[kStages][kTileBytes];
  uint8_t v[kStages][kTileBytes];
  float keep[kStages][kBlockN];              // 1 kept, 0 masked, -1 past end
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// The body of a kernel of kThreads threads, called with its
// __grid_constant__ tensor maps. Warpgroup 0's first warp produces: each
// item's Q tile (once both consumers have issued the previous item's last
// S), then K and V tiles of kBlockN keys into the ring (K alone in the
// whole-row mode's first pass), and with a mask the tile's keep
// flags, staged by the warp's lanes. setmaxnreg moves registers from the
// producer (40) to the consumers (232). `lse` may be null.
template <int kMode, bool kMask, bool kSumRounded, int kStages>
__device__ __forceinline__ void fwd_sm90(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                         const CUtensorMap& tm_v, const CUtensorMap& tm_o,
                                         const float* __restrict__ mask,
                                         float* __restrict__ lse, int B, int H, int Lq,
                                         int Lk, float scale_log2) {
  using Smem = FwdSmem<kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  const int n_tiles = (Lk + kBlockN - 1) / kBlockN;
  const int q_tiles = (Lq + kBlockM - 1) / kBlockM;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 8);  // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 32) return;
    const int lane = tid;
    const int n_pos = ring_positions(kMode, n_tiles);
    int pos = 0;  // ring position, counted across items as the consumers count it
    int it = 0;
    for (int w = blockIdx.x; w < q_tiles * H * B; w += gridDim.x, ++it) {
      const WorkItem wi = work_item(w, q_tiles, H);
      if (lane == 0) {
        mbar_wait(&sm.q_empty, (it & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.q_full, kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load(sm.q + p * kPanelBytes, &tm_q, &sm.q_full, p * 64, wi.q0, wi.h, wi.b);
      }
      for (int i = 0; i < n_pos; ++i, ++pos) {
        const int s = pos % kStages;
        mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
        const int t = i < n_tiles ? i : i - n_tiles;
        // the whole-row mode's first pass reads K alone
        const bool with_v = n_pos == n_tiles || i >= n_tiles;
        const int k0 = t * kBlockN;
        if (kMask) {
          for (int j = lane; j < kBlockN; j += 32) {
            float f = -1.0f;
            if (k0 + j < Lk) f = mask[(int64_t)wi.b * Lk + k0 + j] > 0.5f ? 1.0f : 0.0f;
            sm.keep[s][j] = f;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], (with_v ? 2 : 1) * kTileBytes);
#pragma unroll
          for (int p = 0; p < kPanels; ++p) {
            tma_load(sm.k[s] + p * kPanelBytes, &tm_k, &sm.full[s], p * 64, k0, wi.h, wi.b);
            if (with_v)
              tma_load(sm.v[s] + p * kPanelBytes, &tm_v, &sm.full[s], p * 64, k0, wi.h,
                       wi.b);
          }
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg - 1 owns query rows [(wg - 1) * 64, +64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const FwdRing ring{sm.q, sm.o, &sm.k[0][0], &sm.v[0][0], &sm.keep[0][0], &sm.q_full,
                     &sm.q_empty, sm.full, sm.empty};
  consume<kMode, kMask, kSumRounded, kStages>(ring, wg - 1, tid, B, H, Lq, Lk, scale_log2,
                                              &tm_o, lse);
}

// Launches kKernel, a kernel that runs fwd_sm90 with kStages stages,
// persistent, one CTA per SM; returns a cudaError_t. Its shared-memory
// attribute is set once per device: the call is host time on every launch.
template <int kStages, auto kKernel>
static int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                      const CUtensorMap& to, const float* mask, float* lse, int B, int H,
                      int Lq, int Lk, float scale_log2, cudaStream_t stream) {
  const int smem = (int)sizeof(FwdSmem<kStages>) + 1024;
  static int sized_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sized_for != dev) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized_for = dev;
  }
  const int ctas = persistent_ctas((Lq + kBlockM - 1) / kBlockM * H * B);
  kKernel<<<ctas, kThreads, smem, stream>>>(tq, tk, tv, to, mask, lse, B, H, Lq, Lk,
                                            scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace avatar_sm90
