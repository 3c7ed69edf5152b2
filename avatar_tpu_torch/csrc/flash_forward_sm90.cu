// Head-major flash attention forward for Hopper (sm_90a), bf16, head_dim 64
// or 128 (ATTN_D at build time): q/o [B, H, Lq, d] and k/v [B, H, Lk, d]
// given by their element strides (the last stride 1, the others multiples
// of 8: a head-major view of token-major [B, L, H*d] tensors is read in
// place), optional [B, Lk] f32 keep-mask (> 0.5 keeps), lse [B, H, Lq] f32.
//
// Replaces, at bf16 and head_dim 64 / 128, the WMMA kernels of
// flash_forward.cu for the three TPU kernels that `_flash_forward`
// (avatar_tpu/ops/flash_attention.py:452) launches:
// - bounded (C): `_fwd_kernel_bounded` (:241, `_nomask` :310). Max-free
//   softmax for qk-normed logits, p = exp(min(s, 80)), lse = log l. The
//   long-sequence self-attention of the DiT (512 px, 161 frames: 5376
//   tokens).
// - online (D): `_fwd_kernel` (:140, `_nomask` :228). Running max, masked
//   logits at -1e30 before the max, O and l rescaled in registers when the
//   max rises, lse = m + log l.
// - whole-row (E): `_fwd_kernel_single` (:387, `_nomask` :419), taken when
//   both lengths fit one TPU block (at most 1024 after rounding up to 128):
//   the row max over every key first, then p = exp(s - m) with no rescale,
//   lse = m + log l. Every backward recompute of the DiT's attention in
//   training runs it ([8, 32, 480, 64] self-attention, 480 x 256 caption
//   keys with 200 kept).
// Masked and past-end keys get p = 0; a row with no kept key returns O = 0
// and lse = 1e30. At head_dim 64 the bounded and online modes sum the
// bf16-rounded p into l (the values the PV product uses), at 128 the f32 p,
// as the reference's `fuse_l = d < 128`; the whole-row mode sums the f32 p.
// Exponentials are exp2 of the logits times log2(e) (folded into the
// scale); the bf16 output stays within 2 ulps of the plain version.
//
// Bound on an H100 SXM (989 TF/s dense bf16, 3.35 TB/s): self-attention
// over 5376 tokens x 32 heads at head_dim 64 does 4 * 5376^2 * 2048 =
// 236.8 GFLOP (239 us) and must move 88.8 MB (27 us): bound by operations.
// The whole-row mode at the training shapes is bound by bytes:
// [8, 32, 480, 64] moves 63.4 MB (18.9 us) for 30.2 GFLOP (30.5 us of
// operations counts both products; 1.5x that with the max pass), the
// cross-attention 480 x 256 (200 keys kept, one sample fully masked) 43.4
// MB over its kept keys (13.0 us).
//
// Design (warp-specialised, after FlashAttention-3; the kernel's body is
// fwd_sm90 of attention_fwd_sm90.cuh, shared with kernel B, and its
// consumer side also with kernel A):
// - Persistent: one CTA of 384 threads per SM walks work items of (batch,
//   head, 128 query rows): warpgroup 0 is the producer, warpgroups 1 and 2
//   consume 64 rows each. setmaxnreg moves registers from the producer
//   (40) to the consumers (232).
// - The producer's first warp issues TMA loads: each item's Q tile (once
//   both consumers have issued the previous item's last S), then K and V
//   tiles of 128 keys into a ring of kStages stages (3 at d = 64, 2 at 128)
//   with a full and an empty mbarrier per stage, on from one item to the
//   next. Each tensor has one 4-D tensor map (d, L, H, B) built from its
//   strides, so a tile past a head's last row reads TMA's zero fill, never
//   the next head's rows. With a mask the producer warp also stages the
//   tile's keep flags in shared memory.
// - Whole-row mode: a 64 x 1024 f32 logits row does not fit the registers,
//   so the consumers walk the key tiles twice: S alone for the row max
//   (the producer streams K alone), then S, p and PV against that max (K
//   and V again, from L2). Holding every tile of a row of up to 4 tiles in
//   a 4-stage ring instead, filled once with K and V, ran 2-3% slower at
//   the training shapes on an H100: the first pass then waits for V too.
// - S = Q K^T: wgmma m64n128k16, both operands in shared memory (K-major),
//   the 64 x 128 f32 accumulator in registers; the softmax on that
//   fragment; O += P V: wgmma m64n{d}k16 with P as the register A operand
//   and V read MN-major; ping-pong between the consumer warpgroups.
// - Epilogue: O / l to bf16 into an O staging tile, then out by TMA store,
//   which clips rows past Lq and completes under the next item; lse per
//   row. Against a CTA per item this cut the training shapes' E by 8-16%
//   and C and D at 5376 tokens by 2-4% on an H100.
// Not here: the overlap of one tile's softmax with the PV product of the
// tile before inside a warpgroup. It holds each stage one tile longer;
// with K and V sharing this 2- or 3-stage ring it ran slower on an H100,
// so it waits for separate K and V stages.
#include "attention_fwd_sm90.cuh"

namespace avatar_sm90 {

constexpr int kStages = kD == 64 ? 3 : 2;

template <int kMode, bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_o,
                  const float* __restrict__ mask, float* __restrict__ lse,
                  int B, int H, int Lq, int Lk, float scale_log2) {
  fwd_sm90<kMode, kMask, kMode != kModeSingle && kD < 128, kStages>(
      tm_q, tm_k, tm_v, tm_o, mask, lse, B, H, Lq, Lk, scale_log2);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <int kMode>
static int launch_mode(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       const CUtensorMap& to, const float* mask, float* lse, int B, int H,
                       int Lq, int Lk, float scale_log2, cudaStream_t stream) {
  return mask ? launch_fwd<kStages, flash_sm90_kernel<kMode, true>>(
                    tq, tk, tv, to, mask, lse, B, H, Lq, Lk, scale_log2, stream)
              : launch_fwd<kStages, flash_sm90_kernel<kMode, false>>(
                    tq, tk, tv, to, mask, lse, B, H, Lq, Lk, scale_log2, stream);
}

}  // namespace avatar_sm90

// C entry for ctypes. Strides are in elements, (batch, head, row) for each of
// q, k, v and out; `mask` may be null; `mode` 0 bounded (C), 1 online (D),
// 2 whole-row (E). Returns a cudaError_t (0 = success).
extern "C" int flash_sm90_bf16(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B, int H,
                               int Lq, int Lk, int d, long long qsb, long long qsh,
                               long long qsl, long long ksb, long long ksh,
                               long long ksl, long long vsb, long long vsh,
                               long long vsl, long long osb, long long osh,
                               long long osl, float scale, int mode, void* stream) {
  using namespace avatar_sm90;
  if (d != kD || mode < kModeBounded || mode > kModeSingle)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  int err = make_map(&tq, q, B, H, Lq, kD, qsb, qsh, qsl, kBlockM);
  if (!err) err = make_map(&tk, k, B, H, Lk, kD, ksb, ksh, ksl, kBlockN);
  if (!err) err = make_map(&tv, v, B, H, Lk, kD, vsb, vsh, vsl, kBlockN);
  if (!err) err = make_map(&to, out, B, H, Lq, kD, osb, osh, osl, 64);
  if (err) return err;
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  const float sl2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kModeBounded)
    return launch_mode<kModeBounded>(tq, tk, tv, to, m, l, B, H, Lq, Lk, sl2, st);
  if (mode == kModeOnline)
    return launch_mode<kModeOnline>(tq, tk, tv, to, m, l, B, H, Lq, Lk, sl2, st);
  return launch_mode<kModeSingle>(tq, tk, tv, to, m, l, B, H, Lq, Lk, sl2, st);
}
