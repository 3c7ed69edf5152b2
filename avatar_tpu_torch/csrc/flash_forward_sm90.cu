// Head-major flash attention forward for Hopper (sm_90a), bf16, head_dim 64
// or 128 (ATTN_D at build time): q/o [B, H, Lq, d] and k/v [B, H, Lk, d]
// given by their element strides (the last stride 1, the others multiples
// of 8: a head-major view of token-major [B, L, H*d] tensors is read in
// place), optional [B, Lk] f32 keep-mask (> 0.5 keeps), lse [B, H, Lq] f32.
//
// Replaces, at bf16 and head_dim 64 / 128, the WMMA kernels of
// flash_forward.cu for two TPU kernels that `_flash_forward`
// (avatar_tpu/ops/flash_attention.py:452) launches:
// - bounded (C): `_fwd_kernel_bounded` (:241, `_nomask` :310). Max-free
//   softmax for qk-normed logits, p = exp(min(s, 80)), lse = log l. The
//   long-sequence self-attention of the DiT (512 px, 161 frames: 5376
//   tokens).
// - online (D): `_fwd_kernel` (:140, `_nomask` :228). Running max, masked
//   logits at -1e30 before the max, O and l rescaled in registers when the
//   max rises, lse = m + log l.
// Masked and past-end keys get p = 0; a row with no kept key returns O = 0
// and lse = 1e30. At head_dim 64 l sums the bf16-rounded p (the values the
// PV product uses), at 128 the f32 p, as the reference's `fuse_l = d < 128`.
// Exponentials are exp2 of the logits times log2(e) (folded into the
// scale); the bf16 output stays within 2 ulps of the plain version.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): self-attention
// over 5376 tokens x 32 heads at head_dim 64 does 4 * 5376^2 * 2048 =
// 236.8 GFLOP (239 us) and must move 88.8 MB (27 us): bound by operations.
//
// Design (warp-specialised, after FlashAttention-3):
// - One CTA of 384 threads owns (batch, head, 128 query rows): warpgroup 0
//   is the producer, warpgroups 1 and 2 consume 64 rows each. setmaxnreg
//   moves registers from the producer (40) to the consumers (232).
// - The producer's first warp issues TMA loads: the Q tile once, then K
//   and V tiles of 128 keys into a ring of kStages stages (3 at d = 64, 2
//   at 128) with a full and an empty mbarrier per stage. Each tensor has
//   one 4-D tensor map (d, L, H, B) built from its strides, so a tile past
//   a head's last row reads TMA's zero fill, never the next head's rows.
//   Tiles land in 128-byte-swizzled panels of 64 columns. With a mask the
//   producer warp also stages the tile's keep flags in shared memory.
// - S = Q K^T: wgmma m64n128k16, both operands in shared memory (K-major),
//   the 64 x 128 f32 accumulator in registers (64 per thread).
// - Softmax on the accumulator fragment in registers; the row max by quad
//   shuffles; l kept per thread and reduced once at the end.
// - O += P V: wgmma m64n{d}k16 with P as the register A operand (the S
//   fragment packed to bf16 pairs has the A layout) and V read from shared
//   memory as an MN-major ("transposed") B operand.
// - Ping-pong: the two consumer warpgroups take turns to issue their
//   S = Q K^T (named barriers 3 and 4), so that one's softmax runs while
//   the other's products do (FlashAttention-3's warp-scheduler barrier);
//   it shortens the online mode most, whose softmax is longest.
// - Epilogue: O / l to bf16 into the (now unused) Q panels, then out by
//   TMA store, which clips rows past Lq; lse per row.
// Not here: a persistent schedule, and the overlap of one tile's softmax
// with the PV product of the tile before inside a warpgroup. The latter
// holds each stage one tile longer; with K and V sharing this 2- or
// 3-stage ring it ran slower on an H100, so it waits for separate K and V
// stages.
#include "sm90.cuh"

#ifndef ATTN_D
#define ATTN_D 64
#endif

namespace avatar_sm90 {

constexpr int kD = ATTN_D;
static_assert(kD == 64 || kD == 128, "the Hopper kernel takes head_dim 64 or 128");
constexpr int kBlockM = 128;                 // query rows per CTA
constexpr int kBlockN = 128;                 // keys per stage
constexpr int kPanels = kD / 64;             // 64-column swizzle panels
constexpr int kPanelBytes = 128 * 128;       // 128 rows x 128 bytes
constexpr int kTileBytes = kPanels * kPanelBytes;
constexpr int kStages = kD == 64 ? 3 : 2;
constexpr int kThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kBoundedClamp = 80.0f;
constexpr float kNegInf = -1e30f;            // a masked logit (online)
constexpr float kLseMasked = 1e30f;

struct alignas(1024) Smem {
  uint8_t q[kTileBytes];                     // Q, then the O staging
  uint8_t k[kStages][kTileBytes];
  uint8_t v[kStages][kTileBytes];
  float keep[kStages][kBlockN];              // 1 kept, 0 masked, -1 past end
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <bool kBounded, bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_o,
                  const float* __restrict__ mask, float* __restrict__ lse,
                  int H, int Lq, int Lk, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (Lk + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
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
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kTileBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load(sm.q + p * kPanelBytes, &tm_q, &sm.q_full, p * 64, q0, h, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
      const int k0 = t * kBlockN;
      if (kMask) {
        for (int j = lane; j < kBlockN; j += 32) {
          float f = -1.0f;
          if (k0 + j < Lk) f = mask[(int64_t)b * Lk + k0 + j] > 0.5f ? 1.0f : 0.0f;
          sm.keep[s][j] = f;
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sm.k[s] + p * kPanelBytes, &tm_k, &sm.full[s], p * 64, k0, h, b);
          tma_load(sm.v[s] + p * kPanelBytes, &tm_v, &sm.full[s], p * 64, k0, h, b);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows [cw * 64, cw * 64 + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;  // first of this thread's two columns per 8
  constexpr int kO = kD / 2;        // accumulator registers of O per thread
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.0f;
  // this thread's two rows r and r + 8: running max (log2 units) and sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;

  mbar_wait(&sm.q_full, 0);
  // ping-pong: the two consumer warpgroups take turns issuing S = Q K^T
  // (named barriers 3 and 4), so one's softmax overlaps the other's GEMMs
  if (cw == 1) asm volatile("bar.arrive 3, 256;" ::: "memory");
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);

    float sacc[64];
    const uint32_t k_addr = smem_u32(sm.k[s]);
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

    // ---- softmax on the fragment: sacc[4j + e] is (row r, column 8j + qcol
    // + e), sacc[4j + 2 + e] is (row r + 8, the same column) ----
    const int limit = Lk - t * kBlockN;
    float alpha[2] = {1.0f, 1.0f};
    if (!kBounded) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + qcol + e;
          float flag;
          if (kMask) flag = sm.keep[s][col];
          else flag = col < limit ? 1.0f : -1.0f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = sacc[4 * j + 2 * r + e] * scale_log2;
            x = flag > 0.5f ? x : (flag < -0.5f ? -INFINITY : kNegInf);
            sacc[4 * j + 2 * r + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
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
        const int col = 8 * j + qcol + e;
        bool kept;
        if (kMask) kept = sm.keep[s][col] > 0.5f;
        else kept = col < limit;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = sacc[4 * j + 2 * r + e];
          float pv;
          if (kBounded) pv = fast_exp2(fminf(x * scale_log2, kBoundedClamp * kLog2e));
          else pv = fast_exp2(x - m[r]);
          p[2 * r + e] = kept ? pv : 0.0f;
        }
      }
      // A operand of k-slice j / 2: regs (row r, cols lo), (row r + 8, cols
      // lo), (row r, cols lo + 8), (row r + 8, cols lo + 8)
      const uint32_t top = pack_bf16(p[0], p[1]);
      const uint32_t bottom = pack_bf16(p[2], p[3]);
      pa[(j / 2) * 4 + (j % 2) * 2 + 0] = top;
      pa[(j / 2) * 4 + (j % 2) * 2 + 1] = bottom;
      if (kD < 128) {
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
    if (!kBounded) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }

    // ---- O += P V ----
    const uint32_t v_addr = smem_u32(sm.v[s]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs<kO>(o, pa + 4 * kk, sw128_desc(v_addr + kk * 16 * 128, kPanelBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // the one turn arrival no tile consumed
  if (cw == 0) asm volatile("bar.sync 3, 256;" ::: "memory");
  // ---- epilogue ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = cw * 64 + warp * 16 + lane / 4;  // row in the CTA tile
  uint8_t* stage = sm.q + row * 128 + qcol * 2;
  const float inv0 = 1.0f / (l[0] == 0.0f ? 1.0f : l[0]);
  const float inv1 = 1.0f / (l[1] == 0.0f ? 1.0f : l[1]);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    // swizzled as TMA reads it: 16-byte chunk c of row r at c ^ (r % 8)
    const int panel = j / 8;
    const int chunk = (j % 8) ^ (row % 8);
    uint8_t* dst = stage + panel * kPanelBytes + chunk * 16;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(dst + 8 * 128) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
  if (tid == 0 && q0 + cw * 64 < Lq) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      tma_store(&tm_o, sm.q + p * kPanelBytes + cw * 64 * 128, p * 64,
                q0 + cw * 64, h, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  if (lane % 4 == 0) {
    float* lse_head = lse + ((int64_t)b * H + h) * Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = q0 + row + 8 * r;
      if (qrow < Lq) {
        float val = kLseMasked;
        if (l[r] != 0.0f) val = (kBounded ? 0.0f : m[r] * kLn2) + logf(l[r]);
        lse_head[qrow] = val;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <bool kBounded, bool kMask>
static int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                  const CUtensorMap& to, const float* mask, float* lse, int B, int H,
                  int Lq, int Lk, float scale_log2, cudaStream_t stream) {
  auto kernel = flash_sm90_kernel<kBounded, kMask>;
  const int smem = (int)sizeof(Smem) + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + kBlockM - 1) / kBlockM, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, to, mask, lse, H, Lq, Lk,
                                            scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace avatar_sm90

// C entry for ctypes. Strides are in elements, (batch, head, row) for each of
// q, k, v and out; `mask` may be null. Returns a cudaError_t (0 = success).
extern "C" int flash_sm90_bf16(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B, int H,
                               int Lq, int Lk, int d, long long qsb, long long qsh,
                               long long qsl, long long ksb, long long ksh,
                               long long ksl, long long vsb, long long vsh,
                               long long vsl, long long osb, long long osh,
                               long long osl, float scale, int bounded, void* stream) {
  using namespace avatar_sm90;
  if (d != kD) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  int err = make_map(&tq, q, B, H, Lq, kD, qsb, qsh, qsl, kBlockM);
  if (!err) err = make_map(&tk, k, B, H, Lk, kD, ksb, ksh, ksl, kBlockN);
  if (!err) err = make_map(&tv, v, B, H, Lk, kD, vsb, vsh, vsl, kBlockN);
  if (!err) err = make_map(&to, out, B, H, Lq, kD, osb, osh, osl, 64);
  if (err) return err;
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  const float sl2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bounded)
    return m ? launch<true, true>(tq, tk, tv, to, m, l, B, H, Lq, Lk, sl2, st)
             : launch<true, false>(tq, tk, tv, to, m, l, B, H, Lq, Lk, sl2, st);
  return m ? launch<false, true>(tq, tk, tv, to, m, l, B, H, Lq, Lk, sl2, st)
           : launch<false, false>(tq, tk, tv, to, m, l, B, H, Lq, Lk, sl2, st);
}
