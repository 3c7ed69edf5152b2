// Kernel M: self-attention's q/k prologue in one pass. It replaces no TPU
// kernel: on the TPU, XLA fuses this chain into the relayout at memory
// speed. It is added because on the card the same chain runs as some 40
// eager PyTorch passes a block, most of them over f32 temporaries.
// Launched by `ops/flash_attention.py:qk_norm_rope` where
// `models/dit.py:_attention` applies the split-half RoPE in plain code
// before the head-major kernel C (at 5376 tokens A's 6 MiB cap sends
// self-attention there).
//
// For each token row x of q and of k ([rows, width], the global split-half
// channel order [x1 (width/2) | x2 (width/2)]) it computes what
// ops/normalization.py:rms_norm, ops/rope.py:apply_rotary_emb_split,
// ops/flash_attention.py:split_to_head_major and, for q, fold_scale's
// power-of-two multiply compute, rounding where they round:
//   r  = rsqrtf(sum(x^2) * (1 / width) + eps)
//   m  = T(T(x * r) * w)                          (w the norm's scale)
//   o1 = T(m1 * cos - m2 * sin),  o2 = T(m2 * cos + m1 * sin)   (in f32)
//   q: o = T(o * q_scale)                          (exact: a power of two)
// where T() rounds to the element type (bf16: to nearest even; f32: none).
// Every product and sum is rounded on its own (no fused multiply-add), as
// the eager passes round them, and rsqrtf is the function torch.rsqrt
// calls on the card; the mean is the sum times the f32 reciprocal of the
// width, as torch's mean reduction computes it. Only the order of the sum of squares differs from
// torch's reduction, which can move r by an f32 ulp; in bf16 that reaches
// an output only where it crosses a rounding boundary (one bf16 ulp on a
// few elements in 10^5).
// Pair i of the row (x1[i], x2[i], cos[i], sin[i]) lands in head
// h = i / (d/2) at out[h d + i mod (d/2)] and out[h d + d/2 + i mod (d/2)]:
// the per-head [x1_h | x2_h] order whose head-major view C reads in place.
//
// Tables: either one pair [table_rows, width / 2] in the global split-half
// order (LTX-Video's RoPE over the whole width), or, with head_tables, one
// pair [table_rows, d / 2] that every head shares (Wan2.1's per-head RoPE:
// pair i of the row reads table column i mod (d/2)). The head tables are
// read inside the pair loop, from the cache: a row of them is d bytes.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At the DiT's long shape, q and
// k [5376, 2048] bf16 (44 MB) and the tables [5376, 1024] twice (22 MB)
// are read once and q', k' (44 MB) written once: 110 MB, 32.9 us. The
// eager chain moved about 2.3 GB.
//
// Design, for bytes: one launch for q and k, a pair of warps a token (the
// even warp q, the odd one k), two tokens a CTA. Both warps of a pair read
// the token's cos / sin row; the second read is served from the cache, so
// the tables cross device memory once. A lane holds groups lane, lane + 32,
// ... (kGroups of them) of 16 bytes of each half of its row and of the
// tables (bf16: 8 values; the DiT's 2048 wide rows are 4 groups a lane, 64
// registers of data) and issues all its loads before it computes; the sum
// of squares is warp shuffles, no shared memory and no barrier; no f32
// value reaches device memory. A group of pairs lies inside one head's half
// (d/2 a multiple of the group), so its outputs leave as two 16-byte
// stores, a head's half contiguous. (One warp a token for q and k together
// held twice the data: 227 registers, 8 warps an SM, 58 us at the long
// shape against this design's 43 us on an H100.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avatar_qknr {

constexpr int kPairs = 2;  // tokens a CTA takes, a pair of warps each
constexpr int kThreads = 64 * kPairs;

// The element type's 16-byte group: its value count, how a value is read
// from and written into it, and the rounding to the type.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float get(const uint4& v, int e) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[e]);
  }
  __device__ static void put(uint4& v, int e, float x) {
    reinterpret_cast<__nv_bfloat16*>(&v)[e] = __float2bfloat16_rn(x);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float get(const uint4& v, int e) {
    return reinterpret_cast<const float*>(&v)[e];
  }
  __device__ static void put(uint4& v, int e, float x) { reinterpret_cast<float*>(&v)[e] = x; }
  __device__ static float round(float x) { return x; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One pair of one tensor: the norm's two roundings, the rotation, the scale.
template <typename T>
__device__ __forceinline__ void norm_rotate(float x1, float x2, float r, float w1, float w2,
                                            float c, float s, float scale, float& o1,
                                            float& o2) {
  using E = Elem<T>;
  const float m1 = E::round(__fmul_rn(E::round(__fmul_rn(x1, r)), w1));
  const float m2 = E::round(__fmul_rn(E::round(__fmul_rn(x2, r)), w2));
  o1 = E::round(__fsub_rn(__fmul_rn(m1, c), __fmul_rn(m2, s)));
  o2 = E::round(__fadd_rn(__fmul_rn(m2, c), __fmul_rn(m1, s)));
  o1 = E::round(__fmul_rn(o1, scale));
  o2 = E::round(__fmul_rn(o2, scale));
}

// q, k, q_out, k_out [rows, width]; wq, wk [width]; cos_t, sin_t
// [table_rows, width / 2] (kHeadTable: [table_rows, half_head]), token r
// reading table row r % table_rows. Warp pair p of a CTA takes token
// blockIdx.x * kPairs + p: its even warp q, its odd warp k.
template <typename T, int kGroups, bool kHeadTable>
__global__ void __launch_bounds__(kThreads)
qk_norm_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ wq, const T* __restrict__ wk,
                    const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                    T* __restrict__ q_out, T* __restrict__ k_out, int64_t rows,
                    int64_t table_rows, int width, int half_head, float eps, float q_scale) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kPairs + (warp >> 1);
  if (r >= rows) return;
  const bool is_k = warp & 1;
  const int half = width / 2;
  const int n = half / V;  // 16-byte groups of a half row
  const int64_t base = r * width;
  const int64_t tbase = (r % table_rows) * (kHeadTable ? half_head : half);
  const uint4* src = reinterpret_cast<const uint4*>((is_k ? k : q) + base);
  const uint4* w4 = reinterpret_cast<const uint4*>(is_k ? wk : wq);
  const uint4* ct = reinterpret_cast<const uint4*>(cos_t + tbase);
  const uint4* st = reinterpret_cast<const uint4*>(sin_t + tbase);
  T* dst = (is_k ? k_out : q_out) + base;
  const float scale = is_k ? 1.0f : q_scale;

  uint4 x[2][kGroups];  // [x1, x2][group]
  uint4 cs[kGroups], sn[kGroups];
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    const int g = lane + 32 * c;
    if (g >= n) continue;
    x[0][c] = __ldg(src + g);
    x[1][c] = __ldg(src + n + g);
    if (!kHeadTable) {
      cs[c] = __ldg(ct + g);
      sn[c] = __ldg(st + g);
    }
  }

  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    if (lane + 32 * c >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = E::get(x[h][c], e);
        ss = __fadd_rn(ss, __fmul_rn(v, v));
      }
  }
  // torch's mean multiplies the sum by the f32 1 / width, then adds eps
  const float inv_width = 1.0f / static_cast<float>(width);
  const float rr = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(ss), inv_width), eps));

#pragma unroll
  for (int c = 0; c < kGroups; ++c) {
    const int g = lane + 32 * c;
    if (g >= n) continue;
    const int i = g * V;  // the group's first pair
    const int head = i / half_head;
    const int o = head * 2 * half_head + (i - head * half_head);
    const uint4 w1 = __ldg(w4 + g), w2 = __ldg(w4 + n + g);
    if (kHeadTable) {
      const int tg = (i - head * half_head) / V;  // the group's column group of a head
      cs[c] = __ldg(ct + tg);
      sn[c] = __ldg(st + tg);
    }
    uint4 out1, out2;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float o1, o2;
      norm_rotate<T>(E::get(x[0][c], e), E::get(x[1][c], e), rr, E::get(w1, e),
                     E::get(w2, e), E::get(cs[c], e), E::get(sn[c], e), scale, o1, o2);
      E::put(out1, e, o1);
      E::put(out2, e, o2);
    }
    *reinterpret_cast<uint4*>(dst + o) = out1;
    *reinterpret_cast<uint4*>(dst + o + half_head) = out2;
  }
}

template <typename T, int kGroups>
static cudaError_t launch(const void* q, const void* k, const void* wq, const void* wk,
                          const void* cos_t, const void* sin_t, void* q_out, void* k_out,
                          int64_t rows, int64_t table_rows, int width, int half_head,
                          float eps, float q_scale, bool head_tables, cudaStream_t stream) {
  const int64_t blocks = (rows + kPairs - 1) / kPairs;
  auto kernel = head_tables ? qk_norm_rope_kernel<T, kGroups, true>
                            : qk_norm_rope_kernel<T, kGroups, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(cos_t), static_cast<const T*>(sin_t),
      static_cast<T*>(q_out), static_cast<T*>(k_out), rows, table_rows, width, half_head, eps,
      q_scale);
  return cudaGetLastError();
}

// Groups a lane holds: the least of 1, 2, 4, 8, 10 that covers a half row
// (10: Wan2.1's 5120 wide rows in bf16).
template <typename T>
static cudaError_t dispatch(const void* q, const void* k, const void* wq, const void* wk,
                            const void* cos_t, const void* sin_t, void* q_out, void* k_out,
                            int64_t rows, int64_t table_rows, int width, int heads, float eps,
                            float q_scale, bool ht, cudaStream_t st) {
  constexpr int V = Elem<T>::kVec;
  if (rows <= 0 || table_rows <= 0 || heads <= 0 || width <= 0 || width % heads)
    return cudaErrorInvalidValue;
  const int half_head = width / heads / 2;
  if (half_head <= 0 || half_head % V) return cudaErrorInvalidValue;
  const int per_lane = (width / 2 / V + 31) / 32;
  if (per_lane <= 1)
    return launch<T, 1>(q, k, wq, wk, cos_t, sin_t, q_out, k_out, rows, table_rows, width,
                        half_head, eps, q_scale, ht, st);
  if (per_lane <= 2)
    return launch<T, 2>(q, k, wq, wk, cos_t, sin_t, q_out, k_out, rows, table_rows, width,
                        half_head, eps, q_scale, ht, st);
  if (per_lane <= 4)
    return launch<T, 4>(q, k, wq, wk, cos_t, sin_t, q_out, k_out, rows, table_rows, width,
                        half_head, eps, q_scale, ht, st);
  if (per_lane <= 8)
    return launch<T, 8>(q, k, wq, wk, cos_t, sin_t, q_out, k_out, rows, table_rows, width,
                        half_head, eps, q_scale, ht, st);
  if (per_lane <= 10)
    return launch<T, 10>(q, k, wq, wk, cos_t, sin_t, q_out, k_out, rows, table_rows, width,
                         half_head, eps, q_scale, ht, st);
  return cudaErrorInvalidValue;
}

}  // namespace avatar_qknr

// C entry for ctypes: q, k, q_out, k_out [rows, width], wq, wk [width],
// cos_t, sin_t [table_rows, width / 2] (head_tables = 0) or [table_rows,
// width / heads / 2] shared by every head (head_tables = 1), all
// contiguous, 16-byte aligned, bf16 (in_f32 = 0) or f32; rows a multiple
// of table_rows. Returns the cudaError_t of the launch.
extern "C" int qk_norm_rope(const void* q, const void* k, const void* wq, const void* wk,
                            const void* cos_t, const void* sin_t, void* q_out, void* k_out,
                            long long rows, long long table_rows, int width, int heads,
                            float eps, float q_scale, int in_f32, int head_tables,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ht = head_tables != 0;
  return static_cast<int>(
      in_f32 ? avatar_qknr::dispatch<float>(q, k, wq, wk, cos_t, sin_t, q_out, k_out, rows,
                                            table_rows, width, heads, eps, q_scale, ht, st)
             : avatar_qknr::dispatch<__nv_bfloat16>(q, k, wq, wk, cos_t, sin_t, q_out, k_out,
                                                    rows, table_rows, width, heads, eps,
                                                    q_scale, ht, st));
}
