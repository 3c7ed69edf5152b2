// int8 x int8 matrix product with the dequant epilogue fused (W8A8).
//
// Replaces the TPU kernels `_kernel` and `_kernel_ksplit` of
// avatar_tpu/ops/int8_matmul.py:47/57 (launched by `w8a8_matmul`). Both
// compute
//   out[m, n] = cast(((float)acc[m, n] * x_s[m]) * w_s[n] (+ bias[n]))
//   acc[m, n] = sum_k x_q[m, k] * w_q[n, k]   (int32)
// with x_q [M, K] int8 (per-row activation scale x_s [M] f32) and the weight
// w_q [N, K] int8, the port's [out, in] layout (per-column scale w_s [N] f32).
// The epilogue runs in the Pallas kernel's order, each step rounded on its
// own (no fused multiply-add), and the bias is added in f32 before the cast.
// `_kernel_ksplit` and the TPU's block picker are fast-memory tiling
// devices: here one kernel loops over K in tiles and keeps the int32 sums
// in registers, which covers both.
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): the DiT's
// 5376 x 2048 x 2048 product does 45.1 G int8 operations (22.8 us) and must
// move 37 MB (x_q, w_q, the bf16 output and the scales once each; 11 us);
// the FF products, 5376 x 2048 x 8192 and 5376 x 8192 x 2048, 180 G
// operations (91 us). All three are bound by operations.
//
// Design: a 128 x 128 output tile per block of 8 warps, each warp 64 x 32.
// K is walked in 64-byte tiles through a 3-stage cp.async ring in shared
// memory (rows padded to 80 bytes, so the ldmatrix reads are free of bank
// conflicts); fragments come from ldmatrix and the products run on the
// tensor cores as mma.sync m16n8k32 s8 x s8 -> s32. Rows past M and
// columns past N are zero-filled on load and not stored, so M may be
// ragged. This reaches the legacy mma.sync rate, not the card's int8 peak,
// which needs wgmma and TMA (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avatar_int8 {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kLds = kBK + 16;  // bytes per shared-memory row
constexpr int kTileBytes = (kBM + kBN) * kLds;
constexpr int kSmemBytes = kStages * kTileBytes;

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

// One K tile of A [kBM rows] and B [kBN rows] into a ring stage; each row
// is 4 chunks of 16 bytes. K is a multiple of 16, so a chunk is wholly in
// or wholly past the end.
__device__ __forceinline__ void load_stage(int8_t* stage, const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b, int M, int N,
                                           int K, int m0, int n0, int k0) {
  int8_t* sa = stage;
  int8_t* sb = stage + kBM * kLds;
  for (int c = threadIdx.x; c < (kBM + kBN) * 4; c += kThreads) {
    const int row = (c >> 2) % kBM;
    const int col = (c & 3) * 16;
    const int gk = k0 + col;
    if (c < kBM * 4) {
      const int gm = m0 + row;
      const bool ok = gm < M && gk < K;
      cp_async16(sa + row * kLds + col, ok ? a + (int64_t)gm * K + gk : a, ok);
    } else {
      const int gn = n0 + row;
      const bool ok = gn < N && gk < K;
      cp_async16(sb + row * kLds + col, ok ? b + (int64_t)gn * K + gk : b, ok);
    }
  }
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float v0, float v1);

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float v0,
                                                      float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ float dequant(int acc, float xs, float ws, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), bias);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
w8a8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ wq, const float* __restrict__ ws,
                   const float* __restrict__ bias, OutT* __restrict__ out, int M,
                   int N, int K) {
  extern __shared__ __align__(128) int8_t smem[];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;   // warp's column offset

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(smem + s * kTileBytes, xq, wq, M, N, K, m0, n0, s * kBK);
    cp_async_commit();
  }
  // ldmatrix lane addresses: A's four 8 x 16-byte matrices are (rows 0-7 |
  // 8-15) x (bytes 0-15 | 16-31) of a 16 x 32 fragment; B's are n rows 0-7
  // bytes 0-15, n 0-7 bytes 16-31, n 8-15 bytes 0-15, n 8-15 bytes 16-31.
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles)
      load_stage(smem + (next % kStages) * kTileBytes, xq, wq, M, N, K, m0, n0,
                 next * kBK);
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

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + t * 2;
    if (col >= N) continue;
    const float ws0 = ws[col], ws1 = ws[col + 1];
    const float b0 = bias == nullptr ? 0.0f : bias[col];
    const float b1 = bias == nullptr ? 0.0f : bias[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= M) continue;
        const float x = xs[row];
        store2<OutT>(out + (int64_t)row * N + col,
                     dequant(acc[i][j][2 * h], x, ws0, b0),
                     dequant(acc[i][j][2 * h + 1], x, ws1, b1));
      }
    }
  }
}

template <typename OutT>
static cudaError_t launch(const void* xq, const void* xs, const void* wq, const void* ws,
                          const void* bias, void* out, int M, int N, int K,
                          cudaStream_t stream) {
  auto kernel = w8a8_matmul_kernel<OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace avatar_int8

// C entry for ctypes. x_q [M, K] int8, x_s [M] f32, w_q [N, K] int8, w_s
// [N] f32, bias [N] f32 or null, out [M, N] bf16 (out_f32 = 0) or f32.
// Needs K % 16 == 0, N % 2 == 0 and 16-byte aligned operands (the wrapper
// checks). Returns the cudaError_t of the launch (0 = success).
extern "C" int w8a8_matmul(const void* xq, const void* xs, const void* wq,
                           const void* ws, const void* bias, void* out, int M, int N,
                           int K, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_f32 ? avatar_int8::launch<float>(xq, xs, wq, ws, bias, out, M, N, K, s)
              : avatar_int8::launch<__nv_bfloat16>(xq, xs, wq, ws, bias, out, M, N, K, s);
  return static_cast<int>(err);
}
