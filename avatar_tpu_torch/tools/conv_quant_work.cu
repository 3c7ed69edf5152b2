// The work kernel L1's function (the levels of kernel L, csrc/int8_conv3d_sm90.cu)
// needs for each input element, apart from any kernel's own code, for
// counting in SASS (tools/act_quant_sass.py). Not a kernel of the port:
// nothing launches it.
//
// Two kernels per input type, each a loop of one element per iteration that
// the compiler may not unroll:
// - level_work<InT, true>: load the input, then the function's work on it:
//   the conversion to f32, the true division by the scale (__fdiv_rn, which
//   bit-equality with x / s requires), one rounding conversion and the clamp
//   to [-127, 127]; the level is folded into an accumulator so that none of
//   it is dead;
// - level_work<InT, false>: the same loop, load and accumulator, with the
//   raw input bits folded in instead of the work.
// The difference of the two loop bodies is the work per element. The
// relayout (packing levels into words, the transpose through shared memory)
// and the index arithmetic are left out: they are a kernel's, not the
// function's. The division's slow path, a subroutine the compiler calls
// only for operands its range check flags (subnormal or extreme
// exponents), is not counted.
#include <cuda_bf16.h>
#include <stdint.h>

namespace avatar_conv8_work {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int raw_bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ int raw_bits(__nv_bfloat16 v) {
  return static_cast<int>(__bfloat16_as_ushort(v));
}

template <typename InT, bool kWork>
__global__ void level_work(const InT* __restrict__ x, int n, float s, int* __restrict__ out) {
  int acc = 0;
#pragma unroll 1
  for (int i = threadIdx.x; i < n; i += 32) {
    const InT v = x[i];
    if (kWork)
      acc ^= max(-127, min(127, __float2int_rn(__fdiv_rn(to_f32(v), s))));
    else
      acc ^= raw_bits(v);
  }
  out[threadIdx.x] = acc;
}

template __global__ void level_work<__nv_bfloat16, true>(const __nv_bfloat16*, int, float, int*);
template __global__ void level_work<__nv_bfloat16, false>(const __nv_bfloat16*, int, float,
                                                          int*);
template __global__ void level_work<float, true>(const float*, int, float, int*);
template __global__ void level_work<float, false>(const float*, int, float, int*);

}  // namespace avatar_conv8_work
