// Self-attention with split-half RoPE applied in the kernel, for Hopper
// (sm_90a), bf16, head_dim 64 or 128 (ATTN_D at build time). q/k arrive
// [B, L, C] in global split-half channel order: head h reads its halves at
// columns [h*d/2, (h+1)*d/2) and [C/2 + h*d/2, ...), and cos/sin
// [B, L, C/2] at [l, h*d/2 + i]. v and the output are token-major with head
// h at columns [h*d, (h+1)*d).
//
// Replaces, at bf16 and head_dim 64 / 128, the WMMA kernel of
// rope_attention.cu for the TPU kernel `_rope_token_kernel`
// (avatar_tpu/ops/flash_attention.py:729, launched by `_rope_fused_impl`
// through `rope_fused_attention`): the DiT's self-attention on every
// inference path at 256 px (1 x 832 tokens, 3 x 832 guided) and in the
// training forward (8 x 480). The rotation [x1*c - x2*s | x2*c + x1*s] is
// done in f32 and rounded once to bf16, as `apply_rotary_emb_split`. Bounded
// (qk-normed) logits: p = exp(min(s, 80)), no max; otherwise the whole-row
// max first (two passes over the key tiles, as E). l sums the f32 p.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): at 1 x 832 tokens
// x 32 heads it does 4 * 832^2 * 2048 = 5.67 GFLOP (5.73 us) and must move
// 17.0 MB (q, k, v, o, cos, sin once each; 5.1 us): bound by operations.
// At the training shape 8 x 480 it moves 78.6 MB (23.5 us): bound by bytes.
//
// Design: no rotated copy of q or k ever reaches device memory; the
// rotation writes the wgmma operand layout in shared memory.
// - Persistent: one CTA of 384 threads per SM walks work items of (batch,
//   head, 128 query rows); warpgroups 1 and 2 consume 64 rows each with
//   the shared consumer of attention_fwd_sm90.cuh (S = Q K^T by wgmma from
//   shared memory, the softmax on the accumulator fragment, O += P V with
//   P as the register A operand, ping-pong, TMA-store epilogue into the
//   token-major output under the next item).
// - Warpgroup 0 produces. Its first warp's lane 0 issues every TMA load:
//   the raw halves x1, x2 and the cos, sin rows of 64-row chunks (four
//   4-D maps per tensor pair, (d/2, L, H, B) views of the token-major
//   tensors, unswizzled) into a staging ring of chunks with full/empty
//   mbarriers, and the V tiles (128-byte-swizzled panels) straight into
//   the K/V ring. Its other three warps rotate each staged chunk in
//   registers and write [r1 | r2] into the K stage (or the next item's Q
//   tile, once the consumers have issued their last S) in the
//   128-byte-swizzled K-major layout wgmma reads, fence the writes to the
//   async proxy and arrive on the stage's full mbarrier, which also
//   carries V's transaction bytes. setmaxnreg gives the producer 56
//   registers and the consumers 224.
// - Every q-tile item of a head rotates the head's K tiles again (7x at
//   832 tokens, 4x at 480), reading them from L2; the staging ring keeps
//   the rotation two tiles ahead of the consumers at d = 64 (half a tile
//   at 128, where shared memory holds one chunk). On an H100 the rotation
//   costs about a quarter over the bounded C kernel on pre-rotated inputs
//   (PERF.md).
// Not here: sharing one rotated K tile among a head's q-tile items (a
// cluster with multicast); 224 items at 832 tokens leave 40 of 132 CTAs
// one item short.
#include "attention_fwd_sm90.cuh"

namespace avatar_sm90 {

constexpr int kStages = kD == 64 ? 3 : 2;    // K/V ring
constexpr int kChunkRows = 64;               // rows of one staged chunk
constexpr int kHalf = kD / 2;                // elements of one half
constexpr int kBufBytes = kChunkRows * kHalf * 2;
constexpr int kChunkBytes = 4 * kBufBytes;   // x1, x2, cos, sin
constexpr int kRaw = kD == 64 ? 4 : 1;       // staging ring of chunks
constexpr int kRotators = 96;                // warps 1-3 of the producer

struct alignas(1024) RopeSmem {
  uint8_t q[kTileBytes];                     // rotated Q
  uint8_t o[kTileBytes];                     // the O staging
  uint8_t k[kStages][kTileBytes];            // rotated K
  uint8_t v[kStages][kTileBytes];
  uint8_t raw[kRaw][kChunkBytes];            // x1 | x2 | cos | sin, 64 rows each
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t raw_full[kRaw];
  uint64_t raw_empty[kRaw];
};

// Rotate one staged chunk (64 rows of x1, x2, cos, sin, each [64][d/2]
// dense) into rows [row0, row0 + 64) of a K-major swizzled tile: thread rt
// of kRotators takes 8 columns of a row at a time.
__device__ __forceinline__ void rotate_chunk(uint8_t* tile, int row0, const uint8_t* raw,
                                             int rt) {
  constexpr int kVecs = kHalf / 8;  // 16-byte vectors per half row
#pragma unroll 2
  for (int i = rt; i < kChunkRows * kVecs; i += kRotators) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const int off = (r * kHalf + c) * 2;
    const uint4 x1v = *reinterpret_cast<const uint4*>(raw + off);
    const uint4 x2v = *reinterpret_cast<const uint4*>(raw + kBufBytes + off);
    const uint4 cv = *reinterpret_cast<const uint4*>(raw + 2 * kBufBytes + off);
    const uint4 sv = *reinterpret_cast<const uint4*>(raw + 3 * kBufBytes + off);
    const __nv_bfloat162* x1 = reinterpret_cast<const __nv_bfloat162*>(&x1v);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x2v);
    const __nv_bfloat162* cs = reinterpret_cast<const __nv_bfloat162*>(&cv);
    const __nv_bfloat162* sn = reinterpret_cast<const __nv_bfloat162*>(&sv);
    uint4 r1v, r2v;
    uint32_t* r1 = reinterpret_cast<uint32_t*>(&r1v);
    uint32_t* r2 = reinterpret_cast<uint32_t*>(&r2v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bf16 x bf16 products are exact in f32: one rounding in the sum,
      // one to bf16, as the plain version
      const float2 a = __bfloat1622float2(x1[j]);
      const float2 bb = __bfloat1622float2(x2[j]);
      const float2 co = __bfloat1622float2(cs[j]);
      const float2 si = __bfloat1622float2(sn[j]);
      r1[j] = pack_bf16(a.x * co.x - bb.x * si.x, a.y * co.y - bb.y * si.y);
      r2[j] = pack_bf16(bb.x * co.x + a.x * si.x, bb.y * co.y + a.y * si.y);
    }
    const int row = row0 + r;
    *reinterpret_cast<uint4*>(tile + swizzled_offset(row, c)) = r1v;
    *reinterpret_cast<uint4*>(tile + swizzled_offset(row, kHalf + c)) = r2v;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
rope_sm90_kernel(const __grid_constant__ CUtensorMap tm_q1,
                 const __grid_constant__ CUtensorMap tm_q2,
                 const __grid_constant__ CUtensorMap tm_k1,
                 const __grid_constant__ CUtensorMap tm_k2,
                 const __grid_constant__ CUtensorMap tm_cos,
                 const __grid_constant__ CUtensorMap tm_sin,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, int B, int H, int L,
                 float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  RopeSmem& sm = *reinterpret_cast<RopeSmem*>(smem_raw + pad);
  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  const int q_tiles = (L + kBlockM - 1) / kBlockM;
  const int n_items = q_tiles * H * B;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, kRotators);
    mbar_init(&sm.q_empty, 8);                // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1 + kRotators);  // the TMA lane (V bytes) and rotators
      mbar_init(&sm.empty[s], 8);             // lane 0 of each consumer warp
    }
#pragma unroll
    for (int c = 0; c < kRaw; ++c) {
      mbar_init(&sm.raw_full[c], 1);
      mbar_init(&sm.raw_empty[c], kRotators);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int n_pos = ring_positions(kMode, n_tiles);
    // positions counted across items, as the consumers count them
    int chunk = 0;  // staging ring position, in issue (= rotation) order
    int pos = 0;    // K/V ring position
    int it = 0;
    if (tid == 0) {
      // the TMA lane: per item the raw chunks of Q, then per ring position
      // V and the raw chunks of its K tile
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const WorkItem wi = work_item(w, q_tiles, H);
        auto load_chunk = [&](const CUtensorMap* x1, const CUtensorMap* x2, int row0) {
          const int c = chunk % kRaw;
          mbar_wait(&sm.raw_empty[c], ((chunk / kRaw) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.raw_full[c], kChunkBytes);
          uint8_t* dst = sm.raw[c];
          tma_load(dst, x1, &sm.raw_full[c], 0, row0, wi.h, wi.b);
          tma_load(dst + kBufBytes, x2, &sm.raw_full[c], 0, row0, wi.h, wi.b);
          tma_load(dst + 2 * kBufBytes, &tm_cos, &sm.raw_full[c], 0, row0, wi.h, wi.b);
          tma_load(dst + 3 * kBufBytes, &tm_sin, &sm.raw_full[c], 0, row0, wi.h, wi.b);
          ++chunk;
        };
        for (int r = 0; r < kBlockM; r += kChunkRows) load_chunk(&tm_q1, &tm_q2, wi.q0 + r);
        for (int i = 0; i < n_pos; ++i, ++pos) {
          const int s = pos % kStages;
          mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
          const int t = i < n_tiles ? i : i - n_tiles;
          // the whole-row mode's first pass reads K alone
          if (n_pos == n_tiles || i >= n_tiles) {
            mbar_arrive_expect_tx(&sm.full[s], kTileBytes);
#pragma unroll
            for (int p = 0; p < kPanels; ++p)
              tma_load(sm.v[s] + p * kPanelBytes, &tm_v, &sm.full[s], p * 64,
                       t * kBlockN, wi.h, wi.b);
          } else {
            mbar_arrive(&sm.full[s]);
          }
          for (int r = 0; r < kBlockN; r += kChunkRows)
            load_chunk(&tm_k1, &tm_k2, t * kBlockN + r);
        }
      }
    } else if (tid >= 32) {
      // the rotators, in the same chunk order
      const int rt = tid - 32;
      auto rotate = [&](uint8_t* tile, int row0) {
        const int c = chunk % kRaw;
        mbar_wait(&sm.raw_full[c], (chunk / kRaw) & 1);
        rotate_chunk(tile, row0, sm.raw[c], rt);
        mbar_arrive(&sm.raw_empty[c]);
        ++chunk;
      };
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        // the consumers have issued the previous item's last S
        mbar_wait(&sm.q_empty, (it & 1) ^ 1);
        for (int r = 0; r < kBlockM; r += kChunkRows) rotate(sm.q, r);
        // generic-proxy writes that wgmma (the async proxy) reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&sm.q_full);
        for (int i = 0; i < n_pos; ++i, ++pos) {
          const int s = pos % kStages;
          mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
          for (int r = 0; r < kBlockN; r += kChunkRows) rotate(sm.k[s], r);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(&sm.full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const FwdRing ring{sm.q, sm.o, &sm.k[0][0], &sm.v[0][0], nullptr, &sm.q_full,
                     &sm.q_empty, sm.full, sm.empty};
  consume<kMode, false, false, kStages>(ring, wg - 1, tid, B, H, L, L, scale_log2, &tm_o,
                                        nullptr);
}

template <int kMode>
static int launch(const CUtensorMap* maps, int B, int L, int H, float scale_log2,
                  cudaStream_t stream) {
  auto kernel = rope_sm90_kernel<kMode>;
  const int smem = (int)sizeof(RopeSmem) + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = persistent_ctas((L + kBlockM - 1) / kBlockM * H * B);
  kernel<<<ctas, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                           maps[5], maps[6], maps[7], B, H, L, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace avatar_sm90

// C entry for ctypes, with the arguments of rope_attention_bf16: q, k, v,
// out [B, L, H*d] and cos, sin [B, L, H*d/2], contiguous, 16-byte aligned.
// Returns a cudaError_t (0 = success).
extern "C" int rope_attention_sm90_bf16(const void* q, const void* k, const void* v,
                                        const void* cos_s, const void* sin_s, void* out,
                                        int B, int L, int H, int d, float scale,
                                        int bounded, void* stream) {
  using namespace avatar_sm90;
  if (d != kD) return static_cast<int>(cudaErrorInvalidValue);
  const long long C = (long long)H * kD;
  const long long half = C / 2;
  const char* qb = static_cast<const char*>(q);
  const char* kb = static_cast<const char*>(k);
  // maps: q1, q2, k1, k2, cos, sin as (d/2, L, H, B) views with 64-row,
  // unswizzled boxes; v and out as (d, L, H, B) views, swizzled panels
  CUtensorMap maps[8];
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  int err = make_map(&maps[0], qb, B, H, L, kHalf, L * C, kHalf, C, kChunkRows, kHalf, none);
  if (!err) err = make_map(&maps[1], qb + half * 2, B, H, L, kHalf, L * C, kHalf, C,
                           kChunkRows, kHalf, none);
  if (!err) err = make_map(&maps[2], kb, B, H, L, kHalf, L * C, kHalf, C, kChunkRows,
                           kHalf, none);
  if (!err) err = make_map(&maps[3], kb + half * 2, B, H, L, kHalf, L * C, kHalf, C,
                           kChunkRows, kHalf, none);
  if (!err) err = make_map(&maps[4], cos_s, B, H, L, kHalf, L * half, kHalf, half,
                           kChunkRows, kHalf, none);
  if (!err) err = make_map(&maps[5], sin_s, B, H, L, kHalf, L * half, kHalf, half,
                           kChunkRows, kHalf, none);
  if (!err) err = make_map(&maps[6], v, B, H, L, kD, L * C, kD, C, kBlockN);
  if (!err) err = make_map(&maps[7], out, B, H, L, kD, L * C, kD, C, 64);
  if (err) return err;
  const float sl2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bounded ? launch<kModeBounded>(maps, B, L, H, sl2, st)
                 : launch<kModeSingle>(maps, B, L, H, sl2, st);
}
