// W8A8 3D convolution for Hopper (sm_90a), kernel L's second design: L1
// quantize and relayout with 16-byte loads, L2 an implicit GEMM on wgmma s8
// with both operands brought by TMA, persistent, K split across CTAs where
// the output tiles are fewer than the SMs.
//
// Replaces no Pallas kernel: the reference runs XLA's int8 convolution in
// conv3d_same (avatar_tpu/ops/causal_conv3d.py:73-77 the per-tensor levels,
// :94-104 the int8 conv and its epilogue). The function is int8_conv3d.cu's,
// bit for bit:
//   L1: q = clip(rint(x / s), -127, 127), a true division and one rounding
//       conversion (a NaN gives level 0), x [B, C, F, H, W] (bf16 or f32) to
//       q [B, F, H, W, Cp] channels-last, Cp = C rounded up to 32, zeros past C;
//   L2: acc[m, n] = sum_k A[m, k] w[n, k] in int32 over K = kt kh kw Cp (taps
//       in (t, h, w) order, channels innermost), then out = cast(f32(acc) *
//       (s * w_s[n])) and + bias[n] in the output type (two roundings in
//       bf16), written [B, N, F', H', W'] (NCDHW).
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): L2 is bound by
// operations at every shape of the 2B VAE (the full-resolution 128 -> 128
// conv: 351 G operations, 0.178 ms; its bytes 0.05 ms). L1 moves 3 bytes an
// element (bf16 in, a level out) and issues a true division per element:
// its bound is the larger of the two (tools/act_quant_sass.py counts the
// instructions of its work in tools/conv_quant_work.cu).
//
// L2's design (int8_matmul_sm90.cu's shape):
// - The shapes it takes (ops/causal_conv3d.py:conv_plan): stride 1, zero
//   padding, odd kh and kw (the output has the input's H and W), H * W a
//   multiple of 64 with W dividing 64, Cp a multiple of 64. Everything else
//   runs int8_conv3d.cu's gather kernel.
// - A box of 64 output positions is whole rows of one frame (1 x 64, 2 x 32,
//   4 x 16 or 8 x 8). For the K stage of tap (dt, dh, dw) and channel chunk
//   c, the producer loads that box of the levels at the shifted coordinate
//   (chunk, dw - pw, h0 + dh - ph, clamp(f0 + dt - t_lo, 0, F - 1), b)
//   through a 5-D tensor map: TMA's zero fill is the zero spatial pad, the
//   clamp the repeated frames; no padded copy, no division per stage. The
//   weight [N, K] comes through a 2-D map (4-D with unit dims). Both are K-major, 128-byte rows
//   (Cp % 128 == 0) or 64-byte rows (Cp % 64 == 0), swizzled to match.
// - An output tile is 128 or 256 positions (2 or 4 boxes) x 128 channels;
//   warpgroup 0 is the producer (one thread), warpgroups 1 and 2 each own
//   one or two boxes and issue wgmma.m64n128k32.s32.s8.s8 on them; a ring of
//   4-8 stages with a full and an empty mbarrier each.
// - Split K: a work item is (output tile, K slice); slice j of S takes the
//   stages [j T / S, (j + 1) T / S) of the tile's T, so every slice starts
//   and ends on a tap x chunk boundary. With S > 1 each CTA adds its int32
//   partial sums into a zeroed workspace (red.global.add.s32; integer
//   addition is associative and |sum| <= 127^2 K < 2^31, so any order gives
//   the same sums), then counts itself in the tile's counter; the CTA that
//   counts last reads the sums back and runs the epilogue. One launch.
// - Epilogue: the reference's arithmetic per value, into a 128-byte-swizzled
//   staging tile of [128 channels][64 positions], which a TMA store writes
//   along positions (a box's 64 positions are contiguous for each channel),
//   clipping channels past N; the store drains under the next item's loop.
#include <string.h>

#include "int8_conv3d.cuh"
#include "sm90.cuh"

namespace avatar_conv8_sm90 {

using namespace avatar_conv8;
using namespace avatar_sm90;

// ---------------------------------------------------------------------------
// L1: quantize and relayout
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256;
constexpr int kQC = 32;  // channels per block

__device__ __forceinline__ uint32_t level_byte(float v, float s, int shift) {
  const int q = max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
  return (static_cast<uint32_t>(q) & 0xFFu) << shift;
}

// The kE values of a 16-byte load as floats.
template <typename InT>
__device__ __forceinline__ void unpack(float (&v)[16 / sizeof(InT)], const uint4& raw) {
  if constexpr (sizeof(InT) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
}

// A block of 256 threads quantizes kQP positions (128, or 64 for grids too
// small to fill the card) x 32 channels: each thread loads 16 bytes of one
// channel at a time (a warp reads contiguous bytes of it), all its loads
// issued before the first division, and writes their levels into a
// channel-major tile; then each position's 32 levels are stored as two
// 16-byte words, channels-last. Without kVec (P not a multiple of the
// 16-byte load, or x not 16-byte aligned) the same with scalar loads.
template <typename InT, bool kVec, int kQP>
__global__ void __launch_bounds__(kQThreads)
quant_levels_kernel(const InT* __restrict__ x, const float* __restrict__ act_scale,
                    int8_t* __restrict__ xq, int C, int P, int Cp) {
  constexpr int kE = 16 / sizeof(InT);  // values per load
  constexpr int kVPR = kQP / kE;        // loads per channel row
  constexpr int kLoads = kQC * kVPR / kQThreads;
  __shared__ __align__(16) uint8_t tile[kQC][kQP + 8];
  const int c0 = blockIdx.x * kQC;
  const int p0 = blockIdx.y * kQP;
  const int64_t b = blockIdx.z;
  uint4 raw[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = threadIdx.x + i * kQThreads;
    const int c = c0 + v / kVPR, p = p0 + (v % kVPR) * kE;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (kVec && c < C && p < P)
      raw[i] = *reinterpret_cast<const uint4*>(x + (b * C + c) * P + p);
  }
  const float s = *act_scale;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = threadIdx.x + i * kQThreads;
    const int cl = v / kVPR, vec = v % kVPR;
    const int c = c0 + cl, p = p0 + vec * kE;
    float vals[kE];
    unpack<InT>(vals, raw[i]);
    if (!kVec && c < C) {
      const InT* src = x + (b * C + c) * P + p;
#pragma unroll
      for (int e = 0; e < kE; ++e) vals[e] = p + e < P ? to_f32(src[e]) : 0.0f;
    }
    uint32_t words[kE / 4];
#pragma unroll
    for (int w = 0; w < kE / 4; ++w) {
      words[w] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) words[w] |= level_byte(vals[4 * w + e], s, 8 * e);
    }
    if constexpr (kE == 8)
      *reinterpret_cast<uint2*>(&tile[cl][vec * kE]) = make_uint2(words[0], words[1]);
    else
      *reinterpret_cast<uint32_t*>(&tile[cl][vec * kE]) = words[0];
  }
  __syncthreads();
  // output o: position o % kQP, half (o / kQP) ^ (bit 4 of o): lanes 0-15
  // and 16-31 of a warp take opposite halves, so that their byte reads fall
  // in different banks
#pragma unroll
  for (int o = threadIdx.x; o < 2 * kQP; o += kQThreads) {
    const int pos = o % kQP;
    const int h = (o / kQP) ^ ((o >> 4) & 1);
    const int p = p0 + pos;
    if (p >= P) continue;
    uint32_t w[4];
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      w[j4] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j4] |= static_cast<uint32_t>(tile[16 * h + 4 * j4 + j][pos]) << (8 * j);
    }
    *reinterpret_cast<uint4*>(xq + (b * P + p) * Cp + c0 + 16 * h) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------------------
// L2: implicit GEMM on wgmma
// ---------------------------------------------------------------------------

constexpr int kBN = 128;  // output channels per tile
constexpr int kBox = 64;  // output positions per TMA box and per m64 wgmma
constexpr int kThreads = 384;
constexpr int kSmemLimit = 232448;

// kMW: boxes per consumer warpgroup (tile of 128 kMW positions); kCK: bytes
// of K per stage (one tap's channel chunk, a swizzle row)
template <int kMW, int kCK, typename OutT>
struct Cfg {
  static constexpr int kBM = 2 * kBox * kMW;
  static constexpr int kStageA = kBM * kCK;
  static constexpr int kStageB = kBN * kCK;
  // a consumer warpgroup stages one box at a time: [kBN][64] of OutT as
  // 128-byte rows, kPanel positions each
  static constexpr int kPanel = 128 / static_cast<int>(sizeof(OutT));
  static constexpr int kStaging = kBox * kBN * static_cast<int>(sizeof(OutT));
  static constexpr int kFit = (kSmemLimit - 2048 - 2 * kStaging) / (kStageA + kStageB);
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
};

template <int kMW, int kCK, typename OutT>
struct alignas(1024) Smem {
  using C = Cfg<kMW, kCK, OutT>;
  uint8_t a[C::kStages][C::kStageA];
  uint8_t b[C::kStages][C::kStageB];
  uint8_t staging[2][C::kStaging];
  uint64_t full[C::kStages];
  uint64_t empty[C::kStages];
  int last;  // split K: this CTA finishes the tile
};

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2, int c3,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Descriptor of a K-major operand in kCK-byte swizzled rows: 128-byte rows
// as sm90.cuh's, 64-byte rows with the 64-byte swizzle (8-row groups of 512
// bytes).
template <int kCK>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  if constexpr (kCK == 128) {
    return sw128_desc(addr, 16, 1024);
  } else {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16)
           | (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
  }
}

template <int N>
__device__ __forceinline__ void fence_iregs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] B[128 x 32]^T in s32, int8 A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The consumer warpgroups' own barrier (the producer warpgroup has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// One work item: output tile `tile` (m tiles fastest) and K slice `slice`.
struct Item {
  int tile, m0, n0, k0, k1;
};

__device__ __forceinline__ Item item_of(int w, int tiles, int m_tiles, int bm, int steps,
                                        int split) {
  Item it;
  it.tile = w % tiles;
  const int slice = w / tiles;
  it.m0 = (it.tile % m_tiles) * bm;
  it.n0 = (it.tile / m_tiles) * kBN;
  it.k0 = static_cast<int>(static_cast<int64_t>(slice) * steps / split);
  it.k1 = static_cast<int>(static_cast<int64_t>(slice + 1) * steps / split);
  return it;
}

template <int kMW, int kCK, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_out,
                 const float* __restrict__ act_scale, const float* __restrict__ ws,
                 const OutT* __restrict__ bias, int* __restrict__ partial,
                 int* __restrict__ counters, ConvShape s, int split) {
  using C = Cfg<kMW, kCK, OutT>;
  constexpr int kStages = C::kStages;
  constexpr int kBM = C::kBM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem<kMW, kCK, OutT>& sm = *reinterpret_cast<Smem<kMW, kCK, OutT>*>(smem_raw + pad);
  const int plane = s.H * s.W;
  const int Po = s.F * plane;
  const int M = s.B * Po;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int tiles = m_tiles * ((s.N + kBN - 1) / kBN);
  const int n_items = tiles * split;
  const int cpt = s.Cp / kCK;  // stages per tap
  const int steps = s.kt * s.kh * s.kw * cpt;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);   // the producer thread, with the bytes
      mbar_init(&sm.empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    int pos = 0;  // ring position, counted across items as the consumers count it
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const Item it = item_of(w, tiles, m_tiles, kBM, steps, split);
      // each box: its batch (-1 past M), the window's first frame and row
      int bb[2 * kMW], bf[2 * kMW], bh[2 * kMW];
      int boxes = 0;
#pragma unroll
      for (int j = 0; j < 2 * kMW; ++j) {
        const int m = it.m0 + j * kBox;
        bb[j] = -1;
        bf[j] = bh[j] = 0;
        if (m < M) {
          const int b = m / Po;
          const int r = m - b * Po;
          const int fo = r / plane;
          bb[j] = b;
          bf[j] = fo - s.t_lo;
          bh[j] = (r - fo * plane) / s.W - s.ph;
          ++boxes;
        }
      }
      // the tap and chunk of the slice's first stage, then counted up
      int tap = it.k0 / cpt;
      int chunk = it.k0 - tap * cpt;
      int dt = tap / (s.kh * s.kw);
      const int rem = tap - dt * s.kh * s.kw;
      int dh = rem / s.kw;
      int dw = rem - dh * s.kw;
      for (int ks = it.k0; ks < it.k1; ++ks, ++pos) {
        const int st = pos % kStages;
        mbar_wait(&sm.empty[st], ((pos / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[st], boxes * kBox * kCK + C::kStageB);
#pragma unroll
        for (int j = 0; j < 2 * kMW; ++j)
          if (bb[j] >= 0)
            tma_load_5d(sm.a[st] + j * kBox * kCK, &tm_x, &sm.full[st], chunk * kCK,
                        dw - s.pw, bh[j] + dh, min(max(bf[j] + dt, 0), s.F - 1), bb[j]);
        tma_load(sm.b[st], &tm_w, &sm.full[st], ks * kCK, it.n0, 0, 0);
        if (++chunk == cpt) {
          chunk = 0;
          if (++dw == s.kw) {
            dw = 0;
            if (++dh == s.kh) {
              dh = 0;
              ++dt;
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns boxes [cw kMW, cw kMW + kMW) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int ct = cw * 128 + tid;  // consumer thread
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lrow = warp * 16 + lane / 4;  // this thread's positions in a box (and + 8)
  const int qcol = (lane % 4) * 2;        // ... and its columns in each 8
  uint8_t* staging = sm.staging[cw];
  const float as = *act_scale;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int pos = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const Item it = item_of(w, tiles, m_tiles, kBM, steps, split);
    int acc[kMW][64];
    for (int ks = it.k0; ks < it.k1; ++ks, ++pos) {
      const int st = pos % kStages;
      mbar_wait(&sm.full[st], (pos / kStages) & 1);
      const uint32_t a_addr = smem_u32(sm.a[st]) + cw * kMW * kBox * kCK;
      const uint32_t b_addr = smem_u32(sm.b[st]);
#pragma unroll
      for (int i = 0; i < kMW; ++i) fence_iregs(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCK / 32; ++kk)
#pragma unroll
        for (int i = 0; i < kMW; ++i)
          wgmma_s8_n128(acc[i], kmajor_desc<kCK>(a_addr + i * kBox * kCK + kk * 32),
                        kmajor_desc<kCK>(b_addr + kk * 32), ks > it.k0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < kMW; ++i) fence_iregs(acc[i]);
      if (ks > it.k0) release(&sm.empty[(pos - 1) % kStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kMW; ++i) fence_iregs(acc[i]);
    release(&sm.empty[(pos - 1) % kStages]);

    if (split > 1) {
      // partial sums of the tile: [box row block i * 64 + register][consumer thread]
      int* part = partial + static_cast<int64_t>(it.tile) * kBM * kBN;
#pragma unroll
      for (int i = 0; i < kMW; ++i)
        if (it.m0 + (cw * kMW + i) * kBox < M)
#pragma unroll
          for (int r = 0; r < 64; ++r) atomicAdd(part + (i * 64 + r) * 256 + ct, acc[i][r]);
      __threadfence();
      consumers_sync();
      if (ct == 0) sm.last = atomicAdd(counters + it.tile, 1) == split - 1;
      consumers_sync();
      if (!sm.last) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < kMW; ++i)
        if (it.m0 + (cw * kMW + i) * kBox < M)
#pragma unroll
          for (int r = 0; r < 64; ++r) acc[i][r] = __ldcg(part + (i * 64 + r) * 256 + ct);
    }

    // ---- epilogue, box by box ----
#pragma unroll
    for (int i = 0; i < kMW; ++i) {
      const int m = it.m0 + (cw * kMW + i) * kBox;
      if (m >= M) continue;  // the same for the whole warpgroup
      const int b = m / Po;
      const int p0 = m - b * Po;
      // this warpgroup's previous stores have read the staging tile
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nl = 8 * j + qcol + e;
          const int n = it.n0 + nl;
          const bool in = n < s.N;
          const float scale = in ? __fmul_rn(as, ws[n]) : 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = lrow + 8 * h;
            const int ob = (r % C::kPanel) * static_cast<int>(sizeof(OutT));
            uint8_t* at = staging + (r / C::kPanel) * (kBN * 128) + nl * 128
                          + (((ob >> 4) ^ (nl & 7)) << 4) + (ob & 15);
            *reinterpret_cast<OutT*>(at) =
                finish(__fmul_rn(__int2float_rn(acc[i][4 * j + 2 * h + e]), scale),
                       in ? bias : nullptr, n);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      if (tid == 0) {
#pragma unroll
        for (int p = 0; p < kBox / C::kPanel; ++p)
          tma_store(&tm_out, staging + p * (kBN * 128), p0 + p * C::kPanel, it.n0, b, 0);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  // the staging tiles stay valid until the last stores have read them
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Tensor map of `rank` dims (innermost first), byte strides of dims 1..,
// boxes of `box` elements, the given swizzle; boxes past an edge read zeros
// and stores there are clipped.
static int encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                  const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <int kMW, int kCK, typename OutT>
static int launch(const void* xq, const void* act_scale, const void* wq, const void* ws,
                  const void* bias, void* out, const ConvShape& s, int split,
                  void* workspace, cudaStream_t stream) {
  using C = Cfg<kMW, kCK, OutT>;
  const CUtensorMapSwizzle sw =
      kCK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int64_t K = static_cast<int64_t>(s.kt) * s.kh * s.kw * s.Cp;
  const int64_t Po = static_cast<int64_t>(s.F) * s.H * s.W;
  CUtensorMap tx, tw, to;
  // the levels [B, F, H, W, Cp]: boxes of kCK channels x W columns x 64 / W rows
  const cuuint64_t xd[5] = {(cuuint64_t)s.Cp, (cuuint64_t)s.W, (cuuint64_t)s.H,
                            (cuuint64_t)s.F, (cuuint64_t)s.B};
  const cuuint64_t xs[4] = {(cuuint64_t)s.Cp, (cuuint64_t)s.W * s.Cp,
                            (cuuint64_t)Po / s.F * s.Cp, (cuuint64_t)Po * s.Cp};
  const cuuint32_t xb[5] = {(cuuint32_t)kCK, (cuuint32_t)s.W, (cuuint32_t)(kBox / s.W), 1, 1};
  int err = encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, xq, xd, xs, xb, sw);
  // the weight [N, K] (unit 3rd and 4th dims for the 4-D load): boxes of
  // kCK x 128 rows
  const cuuint64_t wd[4] = {(cuuint64_t)K, (cuuint64_t)s.N, 1, 1};
  const cuuint64_t wst[3] = {(cuuint64_t)K, (cuuint64_t)K * s.N, (cuuint64_t)K * s.N};
  const cuuint32_t wb[4] = {(cuuint32_t)kCK, (cuuint32_t)kBN, 1, 1};
  if (!err) err = encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, wq, wd, wst, wb, sw);
  // the output [B, N, Po] (a unit 4th dim for sm90.cuh's 4-D store): boxes of
  // one 128-byte panel of positions x 128 channels
  const int es = static_cast<int>(sizeof(OutT));
  const cuuint64_t od[4] = {(cuuint64_t)Po, (cuuint64_t)s.N, (cuuint64_t)s.B, 1};
  const cuuint64_t os[3] = {(cuuint64_t)Po * es, (cuuint64_t)Po * es * s.N,
                            (cuuint64_t)Po * es * s.N * s.B};
  const cuuint32_t ob[4] = {(cuuint32_t)C::kPanel, (cuuint32_t)kBN, 1, 1};
  if (!err)
    err = encode(&to,
                 sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 4, out, od, os, ob, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;

  const int64_t M = s.B * Po;
  const int tiles = static_cast<int>((M + C::kBM - 1) / C::kBM) * ((s.N + kBN - 1) / kBN);
  int* partial = nullptr;
  int* counters = nullptr;
  if (split > 1) {
    partial = static_cast<int*>(workspace);
    counters = partial + static_cast<int64_t>(tiles) * C::kBM * kBN;
    cudaError_t e = cudaMemsetAsync(
        workspace, 0, (static_cast<size_t>(tiles) * C::kBM * kBN + tiles) * sizeof(int),
        stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kernel = conv_sm90_kernel<kMW, kCK, OutT>;
  const int smem = static_cast<int>(sizeof(Smem<kMW, kCK, OutT>)) + 1024;
  static_assert(sizeof(Smem<kMW, kCK, OutT>) + 1024 <= kSmemLimit, "shared memory");
  // the attribute once per instantiation and device
  static int sized_for = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sized_for != dev) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized_for = dev;
  }
  const int items = tiles * split;
  const int ctas = items < sm_count() ? items : sm_count();
  kernel<<<ctas, kThreads, smem, stream>>>(
      tx, tw, to, static_cast<const float*>(act_scale), static_cast<const float*>(ws),
      static_cast<const OutT*>(bias), partial, counters, s, split);
  return static_cast<int>(cudaGetLastError());
}

template <typename InT, bool kVec, int kQP>
static cudaError_t launch_quant_tile(const void* x, const void* act_scale, void* xq, int B,
                                     int C, int P, int Cp, cudaStream_t stream) {
  // the channel groups of a position tile neighbours, so that they write
  // whole lines of the levels together
  if ((P + kQP - 1) / kQP > 65535) return cudaErrorInvalidValue;
  dim3 grid(Cp / kQC, (P + kQP - 1) / kQP, B);
  quant_levels_kernel<InT, kVec, kQP><<<grid, kQThreads, 0, stream>>>(
      static_cast<const InT*>(x), static_cast<const float*>(act_scale),
      static_cast<int8_t*>(xq), C, P, Cp);
  return cudaGetLastError();
}

// 128-position tiles where they give at least four blocks per SM, else 64
// (tools/kernel_ab.py's levels family times 64 and 256 beside them)
template <typename InT>
static cudaError_t launch_quant(const void* x, const void* act_scale, void* xq, int B,
                                int C, int P, int Cp, cudaStream_t stream) {
  const bool vec = P % (16 / sizeof(InT)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wide = static_cast<int64_t>(Cp / kQC) * ((P + 127) / 128) * B >= 4 * sm_count();
  if (wide)
    return vec ? launch_quant_tile<InT, true, 128>(x, act_scale, xq, B, C, P, Cp, stream)
               : launch_quant_tile<InT, false, 128>(x, act_scale, xq, B, C, P, Cp, stream);
  return vec ? launch_quant_tile<InT, true, 64>(x, act_scale, xq, B, C, P, Cp, stream)
             : launch_quant_tile<InT, false, 64>(x, act_scale, xq, B, C, P, Cp, stream);
}

}  // namespace avatar_conv8_sm90

// C entries for ctypes; each returns the cudaError_t of its launch (0 =
// success).
//
// L1, with int8_conv3d.cu's int8_conv3d_quant arguments: x [B, C, P] (P =
// F * H * W; bf16, or f32 when x_f32), act_scale one f32 on the card, xq
// [B, P, Cp] int8 (16-byte aligned) with Cp a multiple of 32.
extern "C" int int8_conv3d_quant_sm90(const void* x, const void* act_scale, void* xq,
                                      int B, int C, int P, int Cp, int x_f32,
                                      void* stream) {
  using namespace avatar_conv8_sm90;
  if (Cp % kQC != 0 || B <= 0 || B > 65535 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_f32 ? launch_quant<float>(x, act_scale, xq, B, C, P, Cp, s)
            : launch_quant<__nv_bfloat16>(x, act_scale, xq, B, C, P, Cp, s));
}

// L2 on the wgmma kernel, with int8_conv3d.cu's int8_conv3d arguments and
// the plan of ops/causal_conv3d.py:conv_plan: tile_m 128 or 256 positions
// (256 in bf16 only), chunk 128 or 64 bytes of K per stage (Cp a multiple
// of it), split K slices; workspace, with split > 1, int32 of tiles x tile_m
// x 128 partial sums and tiles counters (zeroed here before the launch),
// else null. Refuses (cudaErrorInvalidValue) a shape the kernel does not
// take.
extern "C" int int8_conv3d_sm90(const void* xq, const void* act_scale, const void* wq,
                                const void* ws, const void* bias, void* out,
                                const int* shape, int out_f32, int tile_m, int chunk,
                                int split, void* workspace, void* stream) {
  using namespace avatar_conv8_sm90;
  avatar_conv8::ConvShape s;
  static_assert(sizeof(avatar_conv8::ConvShape) == 19 * sizeof(int), "ConvShape layout");
  memcpy(&s, shape, sizeof(s));
  const bool ok = s.st == 1 && s.sh == 1 && s.sw == 1 && !s.replicate && s.kh % 2 == 1 &&
                  s.kw % 2 == 1 && s.Fo == s.F && s.Ho == s.H && s.Wo == s.W &&
                  s.W <= kBox && kBox % s.W == 0 && s.H % (kBox / s.W) == 0 &&
                  chunk > 0 && s.Cp % chunk == 0 && split >= 1 &&
                  split <= s.kt * s.kh * s.kw * (s.Cp / chunk) &&
                  (split == 1 || workspace != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    if (tile_m == 128 && chunk == 128)
      return launch<1, 128, float>(xq, act_scale, wq, ws, bias, out, s, split, workspace, st);
    if (tile_m == 128 && chunk == 64)
      return launch<1, 64, float>(xq, act_scale, wq, ws, bias, out, s, split, workspace, st);
  } else {
    if (tile_m == 128 && chunk == 128)
      return launch<1, 128, __nv_bfloat16>(xq, act_scale, wq, ws, bias, out, s, split,
                                           workspace, st);
    if (tile_m == 128 && chunk == 64)
      return launch<1, 64, __nv_bfloat16>(xq, act_scale, wq, ws, bias, out, s, split,
                                          workspace, st);
    if (tile_m == 256 && chunk == 128)
      return launch<2, 128, __nv_bfloat16>(xq, act_scale, wq, ws, bias, out, s, split,
                                           workspace, st);
    if (tile_m == 256 && chunk == 64)
      return launch<2, 64, __nv_bfloat16>(xq, act_scale, wq, ws, bias, out, s, split,
                                          workspace, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
