// Token-major attention with an optional [B, Lk] keep-mask for Hopper
// (sm_90a), bf16, head_dim 64 or 128 (ATTN_D at build time): q/o [B, Lq,
// C] and k/v [B, Lk, C], head h at columns [h*d, (h+1)*d), each read and
// written in place through tensor maps of its head-major view (strides
// (L*C, d, C) in elements, as `_tma_strides` gives them).
//
// Replaces, at bf16 and head_dim 64 / 128, the WMMA kernel of
// token_attention.cu for the TPU kernel `_token_major_kernel` (and its
// `_nomask` variant, avatar_tpu/ops/flash_attention.py:611/653, launched by
// `_fused_fwd_impl` through `fused_token_attention`): the DiT's
// cross-attention to the caption on every inference path (832 or 5376
// queries x 256 keys, 200 kept; batch 3 guided) and in the training
// forward (8 x 480 x 256). The reference's whole-row softmax:
// - bounded (qk-normed logits): p = exp(min(s, 80)), no max;
// - unbounded: the true row max over the masked logits, then p = exp(s - m);
// in both p = 0 on masked keys, l the sum of the f32 p (not of the
// bf16-rounded p the PV product uses), O = PV / l, and a row that keeps no
// key returns 0 (l = 0 is taken as 1). No lse.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): at 832 queries x
// 256 keys (200 kept) x 32 heads it does 4 * 832 * 200 * 2048 = 1.36 GFLOP
// (1.4 us) and must move 8.5 MB (q, o and the mask once each, k and v of
// the kept keys; 2.52 us): bound by bytes, as at every shape the DiT
// gives it.
//
// Design: fwd_sm90 of attention_fwd_sm90.cuh, the body of the persistent
// warp-specialised kernel of C, D and E (TMA ring, two consumer
// warpgroups of 64 query rows, ping-pong, softmax on the wgmma
// accumulator, P as the register A operand of PV, TMA-store epilogue under
// the next item), with l summed from the f32 p and no lse. The mode:
// - bounded: kModeBounded over the key tiles, one pass, no max (the DiT's
//   qk-normed cross-attention on every path);
// - unbounded: kModeSingle, E's two passes (the row max over K alone, then
//   p and PV against it), at any Lk.
// A head's K and V (64 KB at d = 64, Lk = 256) are read from L2 by each of
// its q-tile items, which run side by side on neighbouring CTAs (the q
// tile is the fastest index of the walk). The ring holds 4 stages at
// d = 64 (C-E hold 3), so the next item's first tiles land while this
// item's last are in use: 8-10% faster than 3 at the training shape
// (PERF.md); at d = 128 shared memory holds 2.
#include "attention_fwd_sm90.cuh"

namespace avatar_sm90 {

constexpr int kStages = kD == 64 ? 4 : 2;

template <int kMode, bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
token_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_o,
                  const float* __restrict__ mask, float* __restrict__ lse,
                  int B, int H, int Lq, int Lk, float scale_log2) {
  fwd_sm90<kMode, kMask, false, kStages>(tm_q, tm_k, tm_v, tm_o, mask, lse, B, H, Lq, Lk,
                                         scale_log2);
}

template <int kMode>
static int launch_mode(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       const CUtensorMap& to, const float* mask, int B, int H, int Lq,
                       int Lk, float scale_log2, cudaStream_t stream) {
  return mask ? launch_fwd<kStages, token_sm90_kernel<kMode, true>>(
                    tq, tk, tv, to, mask, nullptr, B, H, Lq, Lk, scale_log2, stream)
              : launch_fwd<kStages, token_sm90_kernel<kMode, false>>(
                    tq, tk, tv, to, mask, nullptr, B, H, Lq, Lk, scale_log2, stream);
}

}  // namespace avatar_sm90

// C entry for ctypes. Strides are in elements, (batch, head, row) of the
// head-major views of q, k, v and out; `mask` may be null; `bounded` picks
// the max-free softmax. Returns a cudaError_t (0 = success).
extern "C" int token_attention_sm90_bf16(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, int B, int H,
                                         int Lq, int Lk, int d, long long qsb,
                                         long long qsh, long long qsl, long long ksb,
                                         long long ksh, long long ksl, long long vsb,
                                         long long vsh, long long vsl, long long osb,
                                         long long osh, long long osl, float scale,
                                         int bounded, void* stream) {
  using namespace avatar_sm90;
  if (d != kD || Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  int err = make_map(&tq, q, B, H, Lq, kD, qsb, qsh, qsl, kBlockM);
  if (!err) err = make_map(&tk, k, B, H, Lk, kD, ksb, ksh, ksl, kBlockN);
  if (!err) err = make_map(&tv, v, B, H, Lk, kD, vsb, vsh, vsl, kBlockN);
  if (!err) err = make_map(&to, out, B, H, Lq, kD, osb, osh, osl, 64);
  if (err) return err;
  const float* m = static_cast<const float*>(mask);
  const float sl2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bounded) return launch_mode<kModeBounded>(tq, tk, tv, to, m, B, H, Lq, Lk, sl2, st);
  return launch_mode<kModeSingle>(tq, tk, tv, to, m, B, H, Lq, Lk, sl2, st);
}
