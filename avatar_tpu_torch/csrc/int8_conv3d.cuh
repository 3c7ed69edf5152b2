// Pieces of kernel L shared by its two sources (int8_conv3d.cu, the first
// design and gather route; int8_conv3d_sm90.cu, the Hopper design): the
// conv's shape as the wrapper passes it, the input's conversion to f32, and
// the reference's epilogue after the scale product, each step rounded on its
// own.
#pragma once

#include <cuda_bf16.h>

namespace avatar_conv8 {

// The shape of one convolution, as the wrapper passes it (19 ints).
struct ConvShape {
  int B, F, H, W, Cp;  // levels [B, F, H, W, Cp]
  int N, Fo, Ho, Wo;   // out [B, N, Fo, Ho, Wo]
  int kt, kh, kw;
  int st, sh, sw;
  int t_lo, ph, pw;  // frames repeated in front; spatial pads
  int replicate;     // spatial pad: 1 replicate, 0 zeros
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float finish(float v, const float* bias, int n) {
  return bias == nullptr ? v : __fadd_rn(v, bias[n]);
}

__device__ __forceinline__ __nv_bfloat16 finish(float v, const __nv_bfloat16* bias,
                                                int n) {
  // rounded to bf16 first, then the bf16 bias added and rounded again
  const __nv_bfloat16 o = __float2bfloat16_rn(v);
  if (bias == nullptr) return o;
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), __bfloat162float(bias[n])));
}

}  // namespace avatar_conv8
