// int8 x int8 matrix product with the dequant epilogue fused (W8A8), for
// Hopper (sm_90a): wgmma on s8 operands, TMA, warp-specialised, persistent.
//
// Replaces, on the card, the mma.sync kernel of int8_matmul.cu (kept as the
// comparison) for the TPU kernels `_kernel` and `_kernel_ksplit` of
// avatar_tpu/ops/int8_matmul.py:47/57 (launched by `w8a8_matmul` :214 /
// :176). The function is unchanged:
//   out[m, n] = cast(((float)acc[m, n] * x_s[m]) * w_s[n] (+ bias[n]))
//   acc[m, n] = sum_k x_q[m, k] * w_q[n, k]   (int32, exact)
// with x_q [M, K] int8 (row scale x_s [M] f32) and the weight w_q [N, K]
// int8, the port's [out, in] layout (column scale w_s [N] f32); each f32
// step of the epilogue rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add, int8_matmul.cu says why). Any M, K % 16 == 0, even N; bf16
// or f32 out.
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): 5376 x 2048 x
// 2048 does 45.1 G operations (22.8 us) and must move 37 MB (11 us); the FF
// products 5376 x 2048 x 8192 and 5376 x 8192 x 2048 180 G (91 us). All three
// are bound by operations, so every product runs on wgmma, the only way to
// the int8 peak, its operands brought by TMA.
//
// Design (the Hopper GEMM's usual shape):
// - Both operands are K-major in device memory, as 8-bit wgmma
//   (m64nNk32.s32.s8.s8) needs them in shared memory: no transpose pass.
//   A K step of 128 bytes is one 128-byte swizzle row, four k32 slices.
// - Persistent: one CTA of 384 threads per SM walks output tiles of 128
//   rows x kBN columns (kBN 256 or 128, chosen by the wrapper), the M tile
//   fastest, so the CTAs running at once share the weight panels in L2.
// - Warpgroup 0 is the producer: one thread issues the TMA loads of the x
//   and w tiles into a ring of stages (3 of 48 KB at kBN = 256, 5 of 32 KB
//   at 128) with a full and an empty mbarrier per stage, on from one output
//   tile to the next, so the next tile's loads run under this tile's
//   epilogue; rows past M or N and K past the end read TMA's zero fill.
// - Warpgroups 1 and 2 each own 64 rows of the tile and hold its 64 x kBN
//   s32 sums in registers (128 a thread at kBN = 256; setmaxnreg 40 / 232).
//   Each K step issues four wgmmas as one group; the stage before is
//   released once at most this group is in flight.
// - Epilogue: x_s per row and w_s, bias per column pair from global memory,
//   dequant in f32 from the registers; bf16 rows (N % 8 == 0) go through a
//   128-byte-swizzled staging tile per warpgroup to TMA stores, which clip
//   rows past M and columns past N and drain under the next tile's main
//   loop; f32, or N % 8 != 0 (a bf16 row stride TMA cannot step), is
//   stored from the registers in pairs (N even: a pair is wholly in or
//   out). The tensor cores idle while the two warpgroups run their
//   epilogues, so the epilogue is what this design can still lose:
//   `python3 -m avatar_tpu_torch.tools.kernel_ab int8` times the kernel
//   without it (`no_epilogue`) and with the bf16 rows stored from the
//   registers (`register_store`); PERF.md has the numbers.
#include "sm90.cuh"

namespace avatar_int8_sm90 {

using namespace avatar_sm90;

constexpr int kBM = 128;     // tile rows: two consumer warpgroups of 64
constexpr int kBK = 128;     // bytes of K per stage: one swizzle row
constexpr int kThreads = 384;
constexpr int kStageA = kBM * kBK;

template <int kBN>
struct Cfg {
  static constexpr int kStages = kBN == 256 ? 3 : 5;
  static constexpr int kStageB = kBN * kBK;
  static constexpr int kAcc = kBN / 2;          // s32 registers a thread
  static constexpr int kStaging = 64 * kBN * 2; // a warpgroup's bf16 rows
};

template <int kBN>
struct alignas(1024) Smem {
  uint8_t a[Cfg<kBN>::kStages][kStageA];
  uint8_t b[Cfg<kBN>::kStages][Cfg<kBN>::kStageB];
  // per consumer warpgroup: kBN / 64 panels of 64 rows x 128 bytes
  uint8_t staging[2][Cfg<kBN>::kStaging];
  uint64_t full[Cfg<kBN>::kStages];
  uint64_t empty[Cfg<kBN>::kStages];
};

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

// D[64 x 256] (+)= A[64 x 32] B[256 x 32]^T in s32, int8 A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int R>
__device__ __forceinline__ void wgmma_s8(int (&d)[R], uint64_t da, uint64_t db,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  wgmma_s8_n128(d, da, db, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  wgmma_s8_n256(d, da, db, accumulate);
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

// kTmaOut: bf16 rows out through the staging tiles and TMA stores into
// tm_out; else pairs stored from the registers into `out`.
template <int kBN, typename OutT, bool kTmaOut>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_out,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
                 int K) {
  using C = Cfg<kBN>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem<kBN>& sm = *reinterpret_cast<Smem<kBN>*>(smem_raw + pad);
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_items = m_tiles * ((N + kBN - 1) / kBN);
  const int k_steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);   // the producer thread, with the bytes
      mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    int pos = 0;  // ring position, counted across tiles as the consumers count it
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int m0 = (w % m_tiles) * kBM;
      const int n0 = (w / m_tiles) * kBN;
      for (int ks = 0; ks < k_steps; ++ks, ++pos) {
        const int s = pos % kStages;
        mbar_wait(&sm.empty[s], ((pos / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], kStageA + C::kStageB);
        tma_load(sm.a[s], &tm_x, &sm.full[s], ks * kBK, m0, 0, 0);
        tma_load(sm.b[s], &tm_w, &sm.full[s], ks * kBK, n0, 0, 0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [m0 + 64 cw, m0 + 64 cw + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qcol = (lane % 4) * 2;
  const int lrow = warp * 16 + lane / 4;  // this thread's rows in the warpgroup's 64
  const int row = cw * 64 + lrow;         // ... in the tile (and row + 8)
  uint8_t* staging = sm.staging[cw];
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // w_s and the bias of a column pair, 0 past N
  auto column_pair = [&](const float* v, int col) {
    return v != nullptr && col < N ? *reinterpret_cast<const float2*>(v + col)
                                   : make_float2(0.0f, 0.0f);
  };
  int pos = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int m0 = (w % m_tiles) * kBM;
    const int n0 = (w / m_tiles) * kBN;
    int acc[C::kAcc];
    for (int ks = 0; ks < k_steps; ++ks, ++pos) {
      const int s = pos % kStages;
      mbar_wait(&sm.full[s], (pos / kStages) & 1);
      const uint32_t a_addr = smem_u32(sm.a[s]) + cw * 64 * 128;
      const uint32_t b_addr = smem_u32(sm.b[s]);
      fence_iregs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8<C::kAcc>(acc, sw128_desc(a_addr + kk * 32, 16, 1024),
                          sw128_desc(b_addr + kk * 32, 16, 1024), ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_iregs(acc);
      if (ks > 0) release(&sm.empty[(pos - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_iregs(acc);
    release(&sm.empty[(pos - 1) % kStages]);

    // ---- epilogue ----
    const int r0 = m0 + row;
    const int r1 = r0 + 8;
    const float x0 = r0 < M ? xs[r0] : 0.0f;
    const float x1 = r1 < M ? xs[r1] : 0.0f;
    if constexpr (kTmaOut) {
      // this warpgroup's previous stores have read the staging tile
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + qcol;
        const float2 w2 = column_pair(ws, col);
        const float2 b2 = column_pair(bias, col);
        uint8_t* at = staging + (j / 8) * (64 * 128) + lrow * 128 + qcol * 2;
        *reinterpret_cast<uint32_t*>(at + (((j % 8) ^ (lrow % 8)) * 16)) =
            pack_bf16(dequant(acc[4 * j], x0, w2.x, b2.x),
                      dequant(acc[4 * j + 1], x0, w2.y, b2.y));
        *reinterpret_cast<uint32_t*>(at + 8 * 128 + (((j % 8) ^ ((lrow + 8) % 8)) * 16)) =
            pack_bf16(dequant(acc[4 * j + 2], x1, w2.x, b2.x),
                      dequant(acc[4 * j + 3], x1, w2.y, b2.y));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      if (tid == 0 && m0 + cw * 64 < M) {
#pragma unroll
        for (int p = 0; p < kBN / 64; ++p)
          if (n0 + 64 * p < N) tma_store(&tm_out, staging + p * (64 * 128), n0 + 64 * p,
                                         m0 + cw * 64, 0, 0);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + qcol;
        if (col < N) {
          const float2 w2 = column_pair(ws, col);
          const float2 b2 = column_pair(bias, col);
          if (r0 < M)
            store2<OutT>(out + (int64_t)r0 * N + col, dequant(acc[4 * j], x0, w2.x, b2.x),
                         dequant(acc[4 * j + 1], x0, w2.y, b2.y));
          if (r1 < M)
            store2<OutT>(out + (int64_t)r1 * N + col, dequant(acc[4 * j + 2], x1, w2.x, b2.x),
                         dequant(acc[4 * j + 3], x1, w2.y, b2.y));
        }
      }
    }
  }
  // the staging tiles stay valid until the last stores have read them
  if (kTmaOut && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Tensor map of a [rows, cols] matrix of `type` (elem_bytes each, rows
// contiguous), boxes of box_cols x box_rows, 128-byte swizzle.
static int matrix_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                      const void* ptr, int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
  const cuuint64_t bytes = (cuuint64_t)rows * cols * elem_bytes;
  const cuuint64_t strides[3] = {(cuuint64_t)cols * elem_bytes, bytes, bytes};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  return make_map_raw(map, type, ptr, dims, strides, box);
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

template <int kBN, typename OutT, bool kTmaOut>
static int launch(const void* xq, const void* xs, const void* wq, const void* ws,
                  const void* bias, void* out, int M, int N, int K,
                  cudaStream_t stream) {
  CUtensorMap tx, tw, to = {};
  int err = matrix_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, kBK, kBM);
  if (!err) err = matrix_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, kBK, kBN);
  // the bf16 out rows in boxes of 64 columns (128 bytes) x 64 rows
  if (!err && kTmaOut)
    err = matrix_map(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, M, N, 64, 64);
  if (err) return err;
  auto kernel = w8a8_sm90_kernel<kBN, OutT, kTmaOut>;
  const int smem = (int)sizeof(Smem<kBN>) + 1024;
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
  const int items = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  // persistent: one CTA per SM, fewer where there are fewer tiles
  const int ctas = items < sm_count() ? items : sm_count();
  kernel<<<ctas, kThreads, smem, stream>>>(
      tx, tw, to, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int kBN>
static int launch_out(int out_f32, const void* xq, const void* xs, const void* wq,
                      const void* ws, const void* bias, void* out, int M, int N, int K,
                      cudaStream_t stream) {
  if (out_f32)
    return launch<kBN, float, false>(xq, xs, wq, ws, bias, out, M, N, K, stream);
  if (N % 8 == 0)
    return launch<kBN, __nv_bfloat16, true>(xq, xs, wq, ws, bias, out, M, N, K, stream);
  return launch<kBN, __nv_bfloat16, false>(xq, xs, wq, ws, bias, out, M, N, K, stream);
}

}  // namespace avatar_int8_sm90

// C entry for ctypes, with the arguments of int8_matmul.cu's w8a8_matmul and
// `tile_n` columns per output tile (128 or 256), one persistent CTA per SM.
// x_q, w_q 16-byte aligned, K % 16 == 0, N even (the wrapper checks). Returns the cudaError_t of the launch.
extern "C" int w8a8_matmul_sm90(const void* xq, const void* xs, const void* wq,
                                const void* ws, const void* bias, void* out, int M,
                                int N, int K, int out_f32, int tile_n, void* stream) {
  using namespace avatar_int8_sm90;
  if (K % 16 != 0 || N % 2 != 0 || M <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_n == 256)
    return launch_out<256>(out_f32, xq, xs, wq, ws, bias, out, M, N, K, s);
  if (tile_n == 128)
    return launch_out<128>(out_f32, xq, xs, wq, ws, bias, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
