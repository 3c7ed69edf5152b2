// W8A8 3D convolution: per-tensor int8 activation levels, per-output-channel
// int8 weights, int32 sums (kernel L).
//
// Replaces no Pallas kernel: the reference runs XLA's int8 convolution in
// conv3d_same (avatar_tpu/ops/causal_conv3d.py:36-115, the kernel_q8 path of
// conv3d_params, :149-168), and PyTorch has no int8 conv3d on CUDA. Two
// kernels compute what it computes:
//
// L1 int8_conv3d_quant: q = clip(rint(x / s), -127, 127) with a true
//   division and one rounding conversion (a NaN gives level 0; the scale s,
//   max(max|x|, 1e-8) / 127 from the wrapper, is then NaN and so is every
//   output), read from x [B, C, F, H, W] (bf16 or f32) and written
//   channels-last, q [B, F, H, W, Cp], Cp = C rounded up to 32, zeros past C.
// L2 int8_conv3d: an implicit GEMM over those levels,
//   acc[m, n] = sum_k A[m, k] * w[n, k]   (int32)
//   M = B * F' * H' * W' output positions, N = C_out,
//   K = kt * kh * kw * Cp (taps in (t, h, w) order, channels innermost),
//   with the reference's epilogue in its order, each step rounded on its own:
//   out = cast(f32(acc) * (s * w_s[n])) then + cast(bias[n]) in the output
//   type (two roundings in bf16), written as out [B, N, F', H', W'], the
//   port's NCDHW. The padding is index arithmetic on the levels: a frame
//   index is clamped to [0, F) (the causal or non-causal time pad repeats
//   the first and last frames), a spatial index is clamped (replicate) or
//   reads level 0 (zeros).
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): the 2B VAE
// decoder's full-resolution 128 -> 128 3x3x3 conv at 97 x 64 x 64 positions
// does 2 * 397,312 * 128 * 3,456 = 351 G int8 operations (0.18 ms) and must
// move its 51 MB of levels and 102 MB of bf16 output once (0.05 ms): bound
// by operations. L1 is bound by bytes (read x once, write the levels once).
//
// Design: L2 is H's mma.sync kernel (csrc/int8_matmul.cu) with A gathered:
// a 128 x 128 output tile per block of 8 warps, each warp 64 x 32; K walked
// in 64-byte tiles through a 3-stage cp.async ring (rows padded to 80 bytes
// for conflict-free ldmatrix). Each thread owns two A rows and two B rows of
// every tile and 16 bytes of each; it decodes its rows' output positions
// once, and each 16-byte chunk (16 channels of one tap: Cp is a multiple of
// 32) is one cp.async, zero-filled where the tap falls in a zero pad or past
// K. The output tile is staged through shared memory so that the NCDHW
// stores run along positions. This reaches the legacy mma.sync rate, not the
// card's int8 peak: int8_conv3d_sm90.cu (wgmma, TMA) takes the shapes its
// boxes can read, and this kernel stays their gather route for the rest
// (strides, replicate padding, other widths) and the comparison.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_conv3d.cuh"

namespace avatar_conv8 {

// ---------------------------------------------------------------------------
// L1: quantize and relayout
// ---------------------------------------------------------------------------

constexpr int kQP = 64;  // positions per block
constexpr int kQC = 32;  // channels per block
constexpr int kQThreads = 256;

template <typename InT>
__global__ void __launch_bounds__(kQThreads)
quant_relayout_kernel(const InT* __restrict__ x, const float* __restrict__ act_scale,
                      int8_t* __restrict__ xq, int C, int P, int Cp) {
  __shared__ __align__(16) int8_t tile[kQP][kQC + 4];
  const int p0 = blockIdx.x * kQP;
  const int c0 = blockIdx.y * kQC;
  const int64_t b = blockIdx.z;
  const float s = *act_scale;
  // read along positions: a warp reads 32 neighbouring values of a channel
  for (int i = threadIdx.x; i < kQP * kQC; i += kQThreads) {
    const int pl = i % kQP, cl = i / kQP;
    const int p = p0 + pl, c = c0 + cl;
    int q = 0;
    if (p < P && c < C) {
      q = __float2int_rn(__fdiv_rn(to_f32(x[(b * C + c) * P + p]), s));
      q = max(-127, min(127, q));
    }
    tile[pl][cl] = static_cast<int8_t>(q);
  }
  __syncthreads();
  // write along channels, 4 levels (one word) a thread
  for (int i = threadIdx.x; i < kQP * (kQC / 4); i += kQThreads) {
    const int pl = i / (kQC / 4), wl = i % (kQC / 4);
    const int p = p0 + pl;
    if (p < P)
      *reinterpret_cast<int*>(xq + (b * P + p) * Cp + c0 + wl * 4) =
          *reinterpret_cast<const int*>(&tile[pl][wl * 4]);
  }
}

// ---------------------------------------------------------------------------
// L2: implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kLds = kBK + 16;  // bytes per shared-memory row
constexpr int kTileBytes = (kBM + kBN) * kLds;
constexpr int kRingBytes = kStages * kTileBytes;
// the output tile, [kBN][kBM + pad] of the output type, reuses the ring
template <typename OutT>
struct OutTile {
  static constexpr int kLd = sizeof(OutT) == 4 ? kBM + 4 : kBM + 8;
  static constexpr int kBytes = kBN * kLd * static_cast<int>(sizeof(OutT));
  static constexpr int kSmem = kBytes > kRingBytes ? kBytes : kRingBytes;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output position of an A row, decoded once: its batch's first level,
// the first input frame / row / column of its window, and whether m < M.
struct RowOrigin {
  const int8_t* batch;
  int f0, h0, w0;
  bool valid;
};

__device__ __forceinline__ RowOrigin row_origin(const int8_t* xq, const ConvShape& s,
                                                int m, int M) {
  RowOrigin r;
  r.valid = m < M;
  const int mm = r.valid ? m : 0;
  const int wo = mm % s.Wo;
  int t = mm / s.Wo;
  const int ho = t % s.Ho;
  t /= s.Ho;
  const int fo = t % s.Fo;
  const int b = t / s.Fo;
  r.batch = xq + static_cast<int64_t>(b) * s.F * s.H * s.W * s.Cp;
  r.f0 = fo * s.st - s.t_lo;
  r.h0 = ho * s.sh - s.ph;
  r.w0 = wo * s.sw - s.pw;
  return r;
}

// One K tile into a ring stage: this thread's 16 bytes of its two A rows
// (the levels of tap k / Cp, channels k % Cp + 0..15) and its two B rows.
__device__ __forceinline__ void load_stage(int8_t* stage, const ConvShape& s,
                                           const RowOrigin (&rows)[2],
                                           const int8_t* __restrict__ wq, int N, int K,
                                           int n0, int k0, int row, int col) {
  const int k = k0 + col;
  const bool k_in = k < K;
  const int tap = k / s.Cp;
  const int c = k - tap * s.Cp;
  const int dt = tap / (s.kh * s.kw);
  const int rem = tap - dt * s.kh * s.kw;
  const int dh = rem / s.kw;
  const int dw = rem - dh * s.kw;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const RowOrigin& r = rows[j];
    const int fi = min(max(r.f0 + dt, 0), s.F - 1);
    int hi = r.h0 + dh, wi = r.w0 + dw;
    bool ok = r.valid && k_in;
    if (s.replicate) {
      hi = min(max(hi, 0), s.H - 1);
      wi = min(max(wi, 0), s.W - 1);
    } else {
      ok = ok && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
    }
    const int8_t* src =
        ok ? r.batch + ((static_cast<int64_t>(fi) * s.H + hi) * s.W + wi) * s.Cp + c
           : r.batch;
    cp_async16(stage + (row + j * 64) * kLds + col, src, ok);
  }
  int8_t* sb = stage + kBM * kLds;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gn = n0 + row + j * 64;
    const bool ok = gn < N && k_in;
    cp_async16(sb + (row + j * 64) * kLds + col,
               ok ? wq + static_cast<int64_t>(gn) * K + k : wq, ok);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv3d_kernel(const int8_t* __restrict__ xq, const float* __restrict__ act_scale,
                   const int8_t* __restrict__ wq, const float* __restrict__ ws,
                   const OutT* __restrict__ bias, OutT* __restrict__ out, ConvShape s) {
  extern __shared__ __align__(128) int8_t smem[];
  const int Po = s.Fo * s.Ho * s.Wo;
  const int M = s.B * Po;
  const int N = s.N;
  const int K = s.kt * s.kh * s.kw * s.Cp;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;   // warp's column offset

  // this thread's rows (row, row + 64) and 16-byte column of every stage
  const int row = threadIdx.x >> 2;
  const int col = (threadIdx.x & 3) * 16;
  RowOrigin rows[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) rows[j] = row_origin(xq, s, m0 + row + j * 64, M);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles)
      load_stage(smem + st * kTileBytes, s, rows, wq, N, K, n0, st * kBK, row, col);
    cp_async_commit();
  }
  // ldmatrix lane addresses, as in csrc/int8_matmul.cu
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles)
      load_stage(smem + (next % kStages) * kTileBytes, s, rows, wq, N, K, n0, next * kBK,
                 row, col);
    cp_async_commit();

    const int8_t* sa = smem + (kt % kStages) * kTileBytes;
    const int8_t* sb = sa + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[4][4];
      unsigned bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], sa + (wm + i * 16 + a_row) * kLds + kk + a_col);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(bf[j], sb + (wn + j * 16 + b_row) * kLds + kk + b_col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the output tile takes its place

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8
  OutT* tile = reinterpret_cast<OutT*>(smem);
  constexpr int kLd = OutTile<OutT>::kLd;
  const float as = *act_scale;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nl = wn + j * 8 + t * 2 + e;
      const int n = n0 + nl;
      const float scale = n < N ? __fmul_rn(as, ws[n]) : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), scale);
          tile[nl * kLd + wm + i * 16 + g + h * 8] = finish(v, n < N ? bias : nullptr, n);
        }
    }
  }
  __syncthreads();
  // stores along positions: out[b, n, pos] with m = b * Po + pos
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int nl = idx / kBM, ml = idx % kBM;
    const int n = n0 + nl, m = m0 + ml;
    if (n < N && m < M) {
      const int b = m / Po;
      out[(static_cast<int64_t>(b) * N + n) * Po + (m - b * Po)] = tile[nl * kLd + ml];
    }
  }
}

template <typename InT>
static cudaError_t launch_quant(const void* x, const void* act_scale, void* xq, int B,
                                int C, int P, int Cp, cudaStream_t stream) {
  dim3 grid((P + kQP - 1) / kQP, Cp / kQC, B);
  quant_relayout_kernel<InT><<<grid, kQThreads, 0, stream>>>(
      static_cast<const InT*>(x), static_cast<const float*>(act_scale),
      static_cast<int8_t*>(xq), C, P, Cp);
  return cudaGetLastError();
}

template <typename OutT>
static cudaError_t launch_conv(const void* xq, const void* act_scale, const void* wq,
                               const void* ws, const void* bias, void* out,
                               const ConvShape& s, cudaStream_t stream) {
  auto kernel = int8_conv3d_kernel<OutT>;
  constexpr int smem = OutTile<OutT>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = s.B * s.Fo * s.Ho * s.Wo;
  dim3 grid((M + kBM - 1) / kBM, (s.N + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(act_scale),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const OutT*>(bias), static_cast<OutT*>(out), s);
  return cudaGetLastError();
}

}  // namespace avatar_conv8

// C entries for ctypes; each returns the cudaError_t of its launch (0 =
// success).
//
// L1: x [B, C, P] (P = F * H * W; bf16, or f32 when x_f32), act_scale one
// f32 on the card, xq [B, P, Cp] int8 with Cp a multiple of 32.
extern "C" int int8_conv3d_quant(const void* x, const void* act_scale, void* xq, int B,
                                 int C, int P, int Cp, int x_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_f32 ? avatar_conv8::launch_quant<float>(x, act_scale, xq, B, C, P, Cp, s)
            : avatar_conv8::launch_quant<__nv_bfloat16>(x, act_scale, xq, B, C, P, Cp, s);
  return static_cast<int>(err);
}

// L2: xq [B, F, H, W, Cp] int8, act_scale one f32, wq [N, kt*kh*kw*Cp] int8
// (16-byte aligned), ws [N] f32, bias [N] of the output type or null, out
// [B, N, Fo, Ho, Wo] bf16 (out_f32 = 0) or f32; shape holds ConvShape's 19
// ints in its order.
extern "C" int int8_conv3d(const void* xq, const void* act_scale, const void* wq,
                           const void* ws, const void* bias, void* out, const int* shape,
                           int out_f32, void* stream) {
  avatar_conv8::ConvShape s;
  static_assert(sizeof(avatar_conv8::ConvShape) == 19 * sizeof(int), "ConvShape layout");
  memcpy(&s, shape, sizeof(s));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_f32 ? avatar_conv8::launch_conv<float>(xq, act_scale, wq, ws, bias, out, s, st)
              : avatar_conv8::launch_conv<__nv_bfloat16>(xq, act_scale, wq, ws, bias, out,
                                                          s, st);
  return static_cast<int>(err);
}
