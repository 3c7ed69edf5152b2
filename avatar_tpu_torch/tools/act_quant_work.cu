// The work kernel K's function needs for each output element, apart from
// any kernel's own code, for counting in SASS (tools/act_quant_sass.py).
// Not a kernel of the port: nothing launches it.
//
// Two kernels per activation, each a loop of one element per iteration
// that the compiler may not unroll:
// - act_work<kAct, true>: load the input(s), then the function's work on
//   them: the bf16-to-f32 conversion, the activation as row_quant.cu
//   compiles it (its gelu_tanh / gelu_erf, under that file's rules: no
//   FMA contraction, accurate tanhf and erff), max|y|, the multiply by
//   1/s and one rounding conversion to the level; the level is folded
//   into an accumulator so that none of it is dead;
// - act_work<kAct, false>: the same loop, loads and accumulator, with the
//   raw input bits folded in instead of the work.
// The difference of the two loop bodies is the work per element. Index
// arithmetic, packing levels into words, the row's reductions and the
// scale are left out: they are a kernel's, not the function's.
#include "row_quant.cu"

namespace avatar_quant {

template <int kAct, bool kWork>
__global__ void act_work(const __nv_bfloat16* __restrict__ h, int n, float inv,
                         int* __restrict__ out) {
  float amax = 0.0f;
  int acc = 0;
#pragma unroll 1
  for (int i = threadIdx.x; i < n; i += 32) {
    const __nv_bfloat16 xv = h[i];
    const __nv_bfloat16 gv = kAct == kGeglu ? h[n + i] : xv;
    if (kWork) {
      const float x = __bfloat162float(xv);
      float y;
      if (kAct == kGeglu)
        y = __fmul_rn(x, gelu_erf(__bfloat162float(gv)));
      else if (kAct == kGeluErf)
        y = gelu_erf(x);
      else
        y = gelu_tanh(x);
      amax = max_nan(amax, fabsf(y));
      acc ^= __float2int_rn(__fmul_rn(y, inv));
    } else {
      acc ^= static_cast<int>(__bfloat16_as_ushort(xv)) ^
             (kAct == kGeglu ? static_cast<int>(__bfloat16_as_ushort(gv)) << 16 : 0);
    }
  }
  out[threadIdx.x] = acc;
  out[32 + threadIdx.x] = __float_as_int(amax);
}

template __global__ void act_work<kGeluTanh, true>(const __nv_bfloat16*, int, float, int*);
template __global__ void act_work<kGeluTanh, false>(const __nv_bfloat16*, int, float, int*);
template __global__ void act_work<kGeluErf, true>(const __nv_bfloat16*, int, float, int*);
template __global__ void act_work<kGeluErf, false>(const __nv_bfloat16*, int, float, int*);
template __global__ void act_work<kGeglu, true>(const __nv_bfloat16*, int, float, int*);
template __global__ void act_work<kGeglu, false>(const __nv_bfloat16*, int, float, int*);

}  // namespace avatar_quant
