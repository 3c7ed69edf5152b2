// Per-row dynamic int8 quantization and the two fused producers that end
// in it. One kernel per TPU kernel of avatar_tpu/ops/int8_matmul.py, and a
// second one for the last:
//
// - quantize_rows (replaces `_quant_rows_kernel`, :231, launched by
//   `quantize_rows_pallas`): y = x in f32;
// - rms_mod_quant (replaces `_rms_mod_quant_kernel`, :305, launched by
//   `fused_rms_mod_quant`): y = (x * (1 / sqrt(mean(x^2) + eps))) * cvec
//   (+ shift), in f32, cvec and shift per batch row; two kernels:
//   rms_mod_quant_regs_kernel for bf16 rows whose width is a multiple of 8
//   (the DiT's), rms_mod_quant_kernel (the "row block" one) for every
//   other width and for f32;
// - act_quant (replaces `_act_quant_kernel`, :392, launched by
//   `fused_act_quant`): y = gelu-tanh(h), gelu-erf(h) or, for geglu,
//   h[:, :W] * gelu-erf(h[:, W:]) with W = C2 / 2, in f32; two kernels:
//   act_quant_regs_kernel for bf16 rows whose output width W is a multiple
//   of 8 (the DiT's), act_quant_kernel (the "row block" one) for every
//   other width and for f32;
//
// each followed by the same epilogue:
//   s = max(max|y|, 1e-30) / 127,  q = clip(round(y * (1 / s)), -127, 127)
// with round half to even, the reciprocal by IEEE division, and no fused
// multiply-add anywhere (every product and sum is rounded on its own, as
// the TPU kernels' f32 expressions are), so a rounding tie lands where the
// plain version puts it. Build without --use_fast_math. The kernels'
// transcendentals (sqrtf, erff, tanhf) may differ from the host's by an ulp,
// which can move an element across a rounding boundary: one int8 level.
// The level is one conversion that rounds half to even,
// __float2int_rn(y * inv): the clip never binds on a finite row (|y| <=
// amax, so |y * inv| <= amax * fl(1 / fl(amax / 127)) (1 + 2^-24) < 127 (1
// + 2^-21) < 127.5), and the conversion turns a NaN into 0, as the
// reference's cast does. Every max is max_nan, which keeps a NaN as
// jnp.max and jnp.maximum do. So on a row that is not finite the kernels
// write what the reference writes: a NaN in y gives s = NaN and inv = NaN,
// so every level is 0; an inf (and no NaN) gives s = inf and inv = 0, so
// every product is 0 or NaN and every level is 0. (J: an inf or NaN in x
// makes the sum of squares inf or NaN and every y 0 or NaN, so s = NaN.)
// The two kernels of K, and the two of J up to the order of J's sum of
// squares, compute the same f32 expressions: K's are equal bit for bit on
// every row, finite or not.
//
// Bound on an H100 SXM (3.35 TB/s): quantize_rows and rms_mod_quant are
// bound by bytes. At the DiT's shapes they read a [5376, 2048] bf16 input
// (22 MB) and write its int8 (11 MB): about 10 us. act_quant reads
// [5376, 8192] bf16 (88 MB) and writes 44 MB of int8: 39.4 us of bytes;
// but accurate tanhf and erff take tens of instructions each, so its bound
// is the larger of that and the instructions its function needs per
// element over the SMs' issue rate (four warp instructions per clock per
// SM): 30 for gelu-approximate on an H100 at 1980 MHz, 39.5 us, a tie;
// counted from the SASS of avatar_tpu_torch/tools/act_quant_work.cu by
// avatar_tpu_torch/tools/act_quant_sass.py (PERF.md).
//
// Design of quantize_rows and the row-block rms_mod_quant and act_quant: one
// block of 256 threads per row. The row is read once from device memory
// into shared memory as f32 (y), with the row's sum of squares or its
// activation computed on the way; block reductions (warp shuffles, then
// one value per warp) give the mean square and max|y|; the quantized row
// and its scale are written once. Width up to 16,384 f32 in shared memory
// (64 KB).
//
// Design of act_quant_regs_kernel (the Hopper route), for what bounds it,
// the instructions: one block of 256 threads per row, each thread's share
// of the row in its registers (up to 8 chunks of 8 values); y never
// touches shared memory (no store and two loads per element); 16-byte
// loads of 8 bf16; the level in one conversion (see the kernel); max|y| by
// warp shuffles and one value per warp; each chunk of 8 levels leaves as
// one 8-byte store. A thread issues all its loads (both halves for geglu)
// before it computes, so a CTA keeps its whole row in flight (16 KB at W
// = 8192) beside the other CTAs of its SM.
//
// Design of rms_mod_quant_regs_kernel (the Hopper route of J). At the DiT's
// width (2,048) a row is 4 KB, so per-row overhead, not bytes, bounded the
// row-block kernel (26.5-27.0 us against 9.87 of bytes on an H100: five
// barriers a row, the f32 row through shared memory twice, 16 KB of cvec
// and shift read again from L1/L2 for every row). Here one warp takes a
// row of up to 2,048 values (kRowChunks chunks of 8 a lane, in registers;
// a lane issues all its 16-byte loads before it computes); the sum of
// squares and max|y| are warp shuffles, no barrier; the levels leave in
// 8-byte stores, the scale in one 4-byte store. Wider rows take a group of
// 2, 4 or 8 warps, which exchange one value a warp through shared memory
// per reduction under a named barrier of the group. A CTA of 256 threads
// stages its batch row's cvec and shift in shared memory once, as f32
// (16 KB at 2,048 with a shift; lanes read them back as float4, swizzled
// so that a quarter-warp's reads hit distinct banks), then walks rows of
// that batch row with a stride of the grid, the grid sized to the CTAs the
// SMs hold at once: 16 or more warps an SM, each with its row (4 KB) in
// flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avatar_quant {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 16384;

enum Act { kGeluTanh = 0, kGeluErf = 1, kGeglu = 2 };

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// max(a, b), NaN if either is NaN (jnp.maximum's rule; fmaxf skips a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int kOp>
__device__ __forceinline__ float reduce_op(float a, float b) {
  return kOp == 0 ? max_nan(a, b) : __fadd_rn(a, b);
}

template <int kOp>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = reduce_op<kOp>(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Every thread gets the block's max (op 0) or sum (op 1) of v.
template <int kOp>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = warp_reduce<kOp>(v);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by an earlier reduction
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = reduce_op<kOp>(v, red[w]);
  return v;
}

__device__ __forceinline__ float gelu_erf(float x) {
  // 0.5 * x * (1 + erf(x * 2^-0.5))
  return __fmul_rn(__fmul_rn(0.5f, x),
                   __fadd_rn(1.0f, erff(__fmul_rn(x, 0.70710678118654752f))));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.5 * x * (1 + tanh(c * (x + 0.044715 * x * x * x))), c = sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.79788456080286536f, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// The shared epilogue over the f32 row y [width] in shared memory.
__device__ __forceinline__ void quantize_row(const float* y, int width,
                                             int8_t* __restrict__ q,
                                             float* __restrict__ s_out, float* red) {
  float amax = 0.0f;
  for (int i = threadIdx.x; i < width; i += kThreads) amax = max_nan(amax, fabsf(y[i]));
  amax = block_reduce<0>(amax, red);
  const float s = __fdiv_rn(max_nan(amax, 1e-30f), 127.0f);
  const float inv = __fdiv_rn(1.0f, s);
  for (int i = threadIdx.x; i < width; i += kThreads)
    q[i] = static_cast<int8_t>(__float2int_rn(__fmul_rn(y[i], inv)));
  if (threadIdx.x == 0) *s_out = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int width) {
  extern __shared__ float y[];
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * width;
  for (int i = threadIdx.x; i < width; i += kThreads) y[i] = to_f32(xr[i]);
  __syncthreads();
  quantize_row(y, width, q + row * width, s + row, red);
}

template <typename T, bool kShift>
__global__ void __launch_bounds__(kThreads)
rms_mod_quant_kernel(const T* __restrict__ x, const float* __restrict__ cvec,
                     const float* __restrict__ shift, int8_t* __restrict__ q,
                     float* __restrict__ s, int rows_per_batch, int width, float eps) {
  extern __shared__ float y[];
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const int64_t b = row / rows_per_batch;
  const T* xr = x + row * width;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const float v = to_f32(xr[i]);
    y[i] = v;
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  ss = block_reduce<1>(ss, red);
  const float ms = __fdiv_rn(ss, static_cast<float>(width));
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
  const float* cv = cvec + b * width;
  const float* sh = kShift ? shift + b * width : nullptr;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    float v = __fmul_rn(__fmul_rn(y[i], r), cv[i]);
    if (kShift) v = __fadd_rn(v, sh[i]);
    y[i] = v;
  }
  __syncthreads();
  quantize_row(y, width, q + row * width, s + row, red);
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const T* __restrict__ h, int8_t* __restrict__ q,
                 float* __restrict__ s, int in_width, int width) {
  extern __shared__ float y[];
  __shared__ float red[kWarps];
  const int64_t row = blockIdx.x;
  const T* hr = h + row * in_width;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const float v = to_f32(hr[i]);
    if (kAct == kGeglu)
      y[i] = __fmul_rn(v, gelu_erf(to_f32(hr[width + i])));
    else if (kAct == kGeluErf)
      y[i] = gelu_erf(v);
    else
      y[i] = gelu_tanh(v);
  }
  __syncthreads();
  quantize_row(y, width, q + row * width, s + row, red);
}

// act_quant over bf16 rows whose output width is a multiple of 8, in
// registers: a block of kThreads per row, thread t holds chunks t, t +
// kThreads, ... (kChunks of them) of 8 values. (128 threads of twice the
// elements each issue fewer instructions per element, the per-row work
// spread over more, but leave fewer warps to hide each one's latencies:
// 4% slower at 8,192 values, gelu-approximate, on an H100; PERF.md.)
// The same f32 expressions as act_quant_kernel and quantize_row, the level
// in one rounding conversion (see the top of this file).
template <int kAct, int kChunks>
__global__ void __launch_bounds__(kThreads)
act_quant_regs_kernel(const __nv_bfloat16* __restrict__ h, int8_t* __restrict__ q,
                      float* __restrict__ s, int in_width, int width) {
  __shared__ float red[kWarps];
  constexpr bool kGated = kAct == kGeglu;
  const int64_t row = blockIdx.x;
  const int n = width / 8;  // 16-byte chunks of the output row
  const uint4* hr = reinterpret_cast<const uint4*>(h + row * in_width);
  uint4 x[kChunks], gate[kGated ? kChunks : 1];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < n) {
      x[c] = __ldg(hr + i);
      if (kGated) gate[c] = __ldg(hr + n + i);
    }
  }
  float y[kChunks][8];
  float amax = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (threadIdx.x + c * kThreads >= n) continue;
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x[c]);
    const __nv_bfloat162* gv =
        reinterpret_cast<const __nv_bfloat162*>(&gate[kGated ? c : 0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(xv[e]);
      float2 a;
      if (kGated) {
        const float2 gf = __bfloat1622float2(gv[e]);
        a = make_float2(__fmul_rn(v.x, gelu_erf(gf.x)), __fmul_rn(v.y, gelu_erf(gf.y)));
      } else if (kAct == kGeluErf) {
        a = make_float2(gelu_erf(v.x), gelu_erf(v.y));
      } else {
        a = make_float2(gelu_tanh(v.x), gelu_tanh(v.y));
      }
      y[c][2 * e] = a.x;
      y[c][2 * e + 1] = a.y;
      amax = max_nan(amax, max_nan(fabsf(a.x), fabsf(a.y)));
    }
  }
  amax = block_reduce<0>(amax, red);
  const float sc = __fdiv_rn(max_nan(amax, 1e-30f), 127.0f);
  const float inv = __fdiv_rn(1.0f, sc);
  int8_t* qr = q + row * width;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i >= n) continue;
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int level = __float2int_rn(__fmul_rn(y[c][e], inv));
      word[e / 4] |= (static_cast<uint32_t>(level) & 0xffu) << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(qr + 8 * i) = make_uint2(word[0], word[1]);
  }
  if (threadIdx.x == 0) s[row] = sc;
}

// rms_mod_quant_regs_kernel's layout. The rmsq family of
// avatar_tpu_torch/tools/kernel_ab.py builds variants of these three.
constexpr int kRowChunks = 8;            // chunks of 8 values a lane holds at most
constexpr bool kStageModulation = true;  // cvec and shift staged once per CTA
constexpr bool kNormModulate = true;     // false: y = x (I's function)

// Shared-memory slot of float4 i of a staged vector (chunk i / 2, half i %
// 2): the halves of chunks 4..7 of every 8 swap places, so that the 8 lanes
// of a quarter-warp, reading the same half of 8 neighbouring chunks, hit 32
// distinct banks.
__device__ __forceinline__ int mod_slot(int i) { return i ^ ((i >> 3) & 1); }

// bar.sync on barrier `id` (1..15; 0 is __syncthreads's) for `threads`
// threads
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The max (op 0) or sum (op 1) of v over a group of kGroup warps: warp
// shuffles, then, for kGroup > 1, one value a warp through red[] under the
// group's named barrier, summed in warp order.
template <int kOp, int kGroup>
__device__ __forceinline__ float group_reduce(float v, float* red, int group) {
  v = warp_reduce<kOp>(v);
  if (kGroup == 1) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  group_sync(1 + group, 32 * kGroup);
  v = red[group * kGroup];
#pragma unroll
  for (int w = 1; w < kGroup; ++w) v = reduce_op<kOp>(v, red[group * kGroup + w]);
  return v;
}

// J over bf16 rows whose width is a multiple of 8, in registers: a group
// of kGroup warps a row, its lane t holding chunks t, t + 32 kGroup, ...
// (kChunks of them) of 8 values; grid (CTAs, batch). Each reduction's
// slots (red[0], red[1]) are rewritten for the next row only after every
// warp of the group has passed the other reduction's barrier, so two
// barriers a row suffice.
template <bool kShift, int kGroup, int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
rms_mod_quant_regs_kernel(const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ cvec, const float* __restrict__ shift,
                          int8_t* __restrict__ q, float* __restrict__ s,
                          int rows_per_batch, int width, float eps) {
  extern __shared__ float4 mod[];  // cvec, then shift: 2 n float4 each
  __shared__ float red[2][kWarps];
  constexpr int kLanes = 32 * kGroup;
  constexpr int kRows = kWarps / kGroup;  // rows a CTA takes at a time
  constexpr bool kStaged = kNormModulate && kStageModulation;
  const int64_t b = blockIdx.y;
  const int n = width / 8;  // 16-byte chunks of the row
  const int group = (threadIdx.x >> 5) / kGroup;
  const int lane = threadIdx.x - group * kLanes;
  const float4* cv_g = reinterpret_cast<const float4*>(cvec + b * width);
  const float4* sh_g = reinterpret_cast<const float4*>(kShift ? shift + b * width : cvec);
  if (kStaged) {
    for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
      mod[mod_slot(i)] = __ldg(cv_g + i);
      if (kShift) mod[2 * n + mod_slot(i)] = __ldg(sh_g + i);
    }
    __syncthreads();
  }
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + group; row < rows_per_batch;
       row += static_cast<int64_t>(gridDim.x) * kRows) {
    const int64_t r = b * rows_per_batch + row;
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * width);
    uint4 raw[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = lane + c * kLanes;
      if (i < n) raw[c] = __ldg(xr + i);
    }
    float y[kChunks][8];
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (lane + c * kLanes >= n) continue;
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(xv[e]);
        y[c][2 * e] = v.x;
        y[c][2 * e + 1] = v.y;
        if (kNormModulate) {
          ss = __fadd_rn(ss, __fmul_rn(v.x, v.x));
          ss = __fadd_rn(ss, __fmul_rn(v.y, v.y));
        }
      }
    }
    float rr = 1.0f;
    if (kNormModulate) {
      ss = group_reduce<1, kGroup>(ss, red[0], group);
      const float ms = __fdiv_rn(ss, static_cast<float>(width));
      rr = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
    }
    float amax = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = lane + c * kLanes;
      if (i >= n) continue;
      if (kNormModulate) {
        float4 m[4];  // cvec halves, then shift halves
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m[h] = kStaged ? mod[mod_slot(2 * i + h)] : __ldg(cv_g + 2 * i + h);
          if (kShift) m[2 + h] = kStaged ? mod[2 * n + mod_slot(2 * i + h)]
                                         : __ldg(sh_g + 2 * i + h);
        }
        const float* cv = reinterpret_cast<const float*>(&m[0]);
        const float* sh = reinterpret_cast<const float*>(&m[2]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = __fmul_rn(__fmul_rn(y[c][e], rr), cv[e]);
          if (kShift) v = __fadd_rn(v, sh[e]);
          y[c][e] = v;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = max_nan(amax, fabsf(y[c][e]));
    }
    amax = group_reduce<0, kGroup>(amax, red[1], group);
    const float sc = __fdiv_rn(max_nan(amax, 1e-30f), 127.0f);
    const float inv = __fdiv_rn(1.0f, sc);
    int8_t* qr = q + r * width;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = lane + c * kLanes;
      if (i >= n) continue;
      uint32_t word[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int level = __float2int_rn(__fmul_rn(y[c][e], inv));
        word[e / 4] |= (static_cast<uint32_t>(level) & 0xffu) << (8 * (e % 4));
      }
      *reinterpret_cast<uint2*>(qr + 8 * i) = make_uint2(word[0], word[1]);
    }
    if (lane == 0) s[r] = sc;
  }
}

template <typename Kernel>
static cudaError_t prepare(Kernel kernel, int width, size_t* smem) {
  if (width <= 0 || width > kMaxWidth) return cudaErrorInvalidValue;
  *smem = static_cast<size_t>(width) * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T>
static cudaError_t launch_quantize_rows(const void* x, void* q, void* s, int rows,
                                        int width, cudaStream_t stream) {
  auto kernel = quantize_rows_kernel<T>;
  size_t smem;
  cudaError_t err = prepare(kernel, width, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<int8_t*>(q),
                                           static_cast<float*>(s), width);
  return cudaGetLastError();
}

template <typename T, bool kShift>
static cudaError_t launch_rms_mod_quant(const void* x, const void* cvec,
                                        const void* shift, void* q, void* s, int batch,
                                        int rows_per_batch, int width, float eps,
                                        cudaStream_t stream) {
  auto kernel = rms_mod_quant_kernel<T, kShift>;
  size_t smem;
  cudaError_t err = prepare(kernel, width, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch * rows_per_batch, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cvec),
      static_cast<const float*>(shift), static_cast<int8_t*>(q), static_cast<float*>(s),
      rows_per_batch, width, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_rms_mod_quant(const void* x, const void* cvec,
                                          const void* shift, void* q, void* s, int batch,
                                          int rows_per_batch, int width, float eps,
                                          cudaStream_t stream) {
  return shift ? launch_rms_mod_quant<T, true>(x, cvec, shift, q, s, batch,
                                               rows_per_batch, width, eps, stream)
               : launch_rms_mod_quant<T, false>(x, cvec, shift, q, s, batch,
                                                rows_per_batch, width, eps, stream);
}

template <typename T, int kAct>
static cudaError_t launch_act_quant(const void* h, void* q, void* s, int rows,
                                    int in_width, cudaStream_t stream) {
  auto kernel = act_quant_kernel<T, kAct>;
  const int width = kAct == kGeglu ? in_width / 2 : in_width;
  size_t smem;
  cudaError_t err = prepare(kernel, width, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, kThreads, smem, stream>>>(static_cast<const T*>(h),
                                           static_cast<int8_t*>(q),
                                           static_cast<float*>(s), in_width, width);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_act_quant(const void* h, void* q, void* s, int rows,
                                      int in_width, int act, cudaStream_t stream) {
  if (act == kGeglu) return launch_act_quant<T, kGeglu>(h, q, s, rows, in_width, stream);
  if (act == kGeluErf)
    return launch_act_quant<T, kGeluErf>(h, q, s, rows, in_width, stream);
  if (act == kGeluTanh)
    return launch_act_quant<T, kGeluTanh>(h, q, s, rows, in_width, stream);
  return cudaErrorInvalidValue;
}

// The Hopper route of act_quant: bf16 rows, output width a multiple of 8
// up to kMaxWidth; chunks per thread the least power of two that covers
// the row.
template <int kAct, int kChunks>
static cudaError_t launch_regs(const void* h, void* q, void* s, int rows, int in_width,
                               cudaStream_t stream) {
  const int width = kAct == kGeglu ? in_width / 2 : in_width;
  act_quant_regs_kernel<kAct, kChunks><<<rows, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<int8_t*>(q),
      static_cast<float*>(s), in_width, width);
  return cudaGetLastError();
}

template <int kAct>
static cudaError_t dispatch_regs(const void* h, void* q, void* s, int rows, int in_width,
                                 cudaStream_t st) {
  const int width = kAct == kGeglu ? in_width / 2 : in_width;
  if (width <= 0 || width % 8 || width > kMaxWidth || (kAct == kGeglu && in_width % 2))
    return cudaErrorInvalidValue;
  const int per_thread = (width / 8 + kThreads - 1) / kThreads;
  if (per_thread <= 1) return launch_regs<kAct, 1>(h, q, s, rows, in_width, st);
  if (per_thread <= 2) return launch_regs<kAct, 2>(h, q, s, rows, in_width, st);
  if (per_thread <= 4) return launch_regs<kAct, 4>(h, q, s, rows, in_width, st);
  if (per_thread <= 8) return launch_regs<kAct, 8>(h, q, s, rows, in_width, st);
  return cudaErrorInvalidValue;
}

// The Hopper route of J: bf16 rows, width a multiple of 8 up to kMaxWidth.
// A group of warps a row (one up to kRowChunks * 8 * 32 = 2,048 values,
// else the least power of two that holds the row), chunks a lane the least
// power of two that covers the row; CTAs per batch row as many as the SMs
// hold at once over the batch, at most one per kRows rows.
template <bool kShift, int kGroup, int kChunks>
static cudaError_t launch_rmsq(const void* x, const void* cvec, const void* shift, void* q,
                               void* s, int batch, int rows_per_batch, int width, float eps,
                               cudaStream_t stream) {
  auto kernel = rms_mod_quant_regs_kernel<kShift, kGroup, kChunks>;
  constexpr int kRows = kWarps / kGroup;
  const size_t smem = kNormModulate && kStageModulation
                          ? (kShift ? 2 : 1) * static_cast<size_t>(width) * sizeof(float)
                          : 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  // CTAs an SM holds, by the occupancy calculator, kept for the last
  // shared-memory size (the DiT calls one width)
  static size_t last_smem = ~size_t(0);
  static int per_sm = 0;
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && smem != last_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    last_smem = err == cudaSuccess ? smem : ~size_t(0);
  }
  if (err != cudaSuccess) return err;
  const int per_batch = (sms * (per_sm > 0 ? per_sm : 1) + batch - 1) / batch;
  const int needed = (rows_per_batch + kRows - 1) / kRows;
  const dim3 grid(needed < per_batch ? needed : per_batch, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(cvec),
      static_cast<const float*>(shift), static_cast<int8_t*>(q), static_cast<float*>(s),
      rows_per_batch, width, eps);
  return cudaGetLastError();
}

template <bool kShift, int kGroup>
static cudaError_t dispatch_rmsq_chunks(const void* x, const void* cvec, const void* shift,
                                        void* q, void* s, int batch, int rows_per_batch,
                                        int width, float eps, cudaStream_t st) {
  const int per_lane = (width / 8 + 32 * kGroup - 1) / (32 * kGroup);
  if (per_lane <= 1)
    return launch_rmsq<kShift, kGroup, 1>(x, cvec, shift, q, s, batch, rows_per_batch,
                                          width, eps, st);
  if (per_lane <= 2)
    return launch_rmsq<kShift, kGroup, 2>(x, cvec, shift, q, s, batch, rows_per_batch,
                                          width, eps, st);
  if (per_lane <= 4)
    return launch_rmsq<kShift, kGroup, 4>(x, cvec, shift, q, s, batch, rows_per_batch,
                                          width, eps, st);
  if (per_lane <= 8)
    return launch_rmsq<kShift, kGroup, 8>(x, cvec, shift, q, s, batch, rows_per_batch,
                                          width, eps, st);
  return cudaErrorInvalidValue;
}

template <bool kShift>
static cudaError_t dispatch_rmsq(const void* x, const void* cvec, const void* shift,
                                 void* q, void* s, int batch, int rows_per_batch, int width,
                                 float eps, cudaStream_t st) {
  if (width <= 0 || width % 8 || width > kMaxWidth || batch <= 0 || rows_per_batch <= 0)
    return cudaErrorInvalidValue;
  int group = 1;  // warps a row
  while (group < kWarps && group * 32 * 8 * kRowChunks < width) group *= 2;
  if (group == 1)
    return dispatch_rmsq_chunks<kShift, 1>(x, cvec, shift, q, s, batch, rows_per_batch,
                                           width, eps, st);
  if (group == 2)
    return dispatch_rmsq_chunks<kShift, 2>(x, cvec, shift, q, s, batch, rows_per_batch,
                                           width, eps, st);
  if (group == 4)
    return dispatch_rmsq_chunks<kShift, 4>(x, cvec, shift, q, s, batch, rows_per_batch,
                                           width, eps, st);
  return dispatch_rmsq_chunks<kShift, kWarps>(x, cvec, shift, q, s, batch, rows_per_batch,
                                              width, eps, st);
}

}  // namespace avatar_quant

// C entries for ctypes. x/h are row-major [rows, width] bf16 (in_f32 = 0)
// or f32; q [rows, out width] int8; s [rows] f32; cvec and shift [batch,
// width] f32 (shift may be null). Each returns the cudaError_t of its launch
// (0 = success).
extern "C" int quantize_rows(const void* x, void* q, void* s, int rows, int width,
                             int in_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_f32 ? avatar_quant::launch_quantize_rows<float>(x, q, s, rows, width, st)
             : avatar_quant::launch_quantize_rows<__nv_bfloat16>(x, q, s, rows, width, st));
}

extern "C" int rms_mod_quant(const void* x, const void* cvec, const void* shift, void* q,
                             void* s, int batch, int rows_per_batch, int width,
                             float eps, int in_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_f32 ? avatar_quant::dispatch_rms_mod_quant<float>(
                   x, cvec, shift, q, s, batch, rows_per_batch, width, eps, st)
             : avatar_quant::dispatch_rms_mod_quant<__nv_bfloat16>(
                   x, cvec, shift, q, s, batch, rows_per_batch, width, eps, st));
}

// The Hopper route of rms_mod_quant (rms_mod_quant_regs_kernel): bf16 x,
// width a multiple of 8; arguments as rms_mod_quant's.
extern "C" int rms_mod_quant_sm90(const void* x, const void* cvec, const void* shift,
                                  void* q, void* s, int batch, int rows_per_batch,
                                  int width, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      shift ? avatar_quant::dispatch_rmsq<true>(x, cvec, shift, q, s, batch, rows_per_batch,
                                                width, eps, st)
            : avatar_quant::dispatch_rmsq<false>(x, cvec, shift, q, s, batch,
                                                 rows_per_batch, width, eps, st));
}

// act: 0 gelu-approximate (tanh), 1 gelu (erf), 2 geglu (output width
// in_width / 2).
extern "C" int act_quant(const void* h, void* q, void* s, int rows, int in_width, int act,
                         int in_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_f32 ? avatar_quant::dispatch_act_quant<float>(h, q, s, rows, in_width, act, st)
             : avatar_quant::dispatch_act_quant<__nv_bfloat16>(h, q, s, rows, in_width,
                                                               act, st));
}

// The Hopper route of act_quant (act_quant_regs_kernel): bf16 h, output
// width a multiple of 8; act as above.
extern "C" int act_quant_sm90(const void* h, void* q, void* s, int rows, int in_width,
                              int act, void* stream) {
  using namespace avatar_quant;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kGeglu) err = dispatch_regs<kGeglu>(h, q, s, rows, in_width, st);
  if (act == kGeluErf) err = dispatch_regs<kGeluErf>(h, q, s, rows, in_width, st);
  if (act == kGeluTanh) err = dispatch_regs<kGeluTanh>(h, q, s, rows, in_width, st);
  return static_cast<int>(err);
}
