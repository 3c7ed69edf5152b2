"""The DiT's attention kernels (port of the keep-mask kernels of
``avatar_tpu/ops/flash_attention.py``, forward and backward).

Token-major, [B, L, heads*head_dim]:

- :func:`rope_fused_attention`: self-attention over split-half RoPE-layout
  q/k with the rotation done inside the kernel (``csrc/rope_attention_sm90.cu``
  and ``csrc/rope_attention.cu``, replacing ``_rope_token_kernel``).
- :func:`fused_token_attention`: attention with an optional [B, Lk]
  keep-mask (``csrc/token_attention_sm90.cu`` and
  ``csrc/token_attention.cu``, replacing ``_token_major_kernel``).

- :func:`qk_norm_rope`: the q/k prologue of self-attention where RoPE runs
  before a head-major kernel: q/k RMS norm, split-half RoPE, the per-head
  layout and the power-of-two softmax scale folded into q, in one pass
  (kernel M, ``csrc/qk_norm_rope.cu``; it replaces no TPU kernel).

Head-major, [B, H, L, head_dim]:

- :func:`flash_attention`: the three kernels of ``_flash_forward``
  (``csrc/flash_forward.cu``): the max-free ``_fwd_kernel_bounded``, the
  online-softmax ``_fwd_kernel`` and the whole-row ``_fwd_kernel_single``,
  each also returning the row log-sum-exp; its gradient runs the two
  kernels of ``_flash_backward``: ``_bwd_dkv_kernel`` and
  ``_bwd_dq_kernel``. With a dense additive bias [B, 1|H, Lq, Lk] it runs
  the four kernels of the dense-bias path (``csrc/flash_dense_sm90.cu``,
  ``csrc/flash_dense.cu``): ``_fwd_kernel_dense_bias``, and for the
  gradient ``_bwd_dkv_kernel_bias``, ``_bwd_dq_kernel_bias`` and
  ``_bwd_db_kernel`` (dBias summed over the heads that share a slab).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version beside it, which computes the same
function with the kernel's masking: masked keys get p = 0 and a row with
every key masked returns 0. ``bounded`` (qk-normed logits) drops the
softmax max pass: p = exp(min(s, 80)).

The kernels take bf16 and f32 and every head dim that the reference's
predicate for their path admits: a multiple of 8 up to 512 for the
head-major kernels (a multiple of 16 for A, up to 256 for A and B); fp16
reaches no path of either package and raises. The route is chosen from the
dtype and the head dim before the launch (:func:`forward_impl`,
:func:`rope_impl`, :func:`token_impl`): the three head-major forward
kernels (C, D, E) at bf16 with head dim 64 or 128 run the Hopper kernel
(``csrc/flash_forward_sm90.cu``: TMA and wgmma, and strided q/k/v read in
place), and so do A (``csrc/rope_attention_sm90.cu``: the rotation written
into the wgmma operand layout in shared memory) and B
(``csrc/token_attention_sm90.cu``: the token-major tensors read in place
by the kernel body of C, D and E); every other case runs the WMMA
tile code built for its (dtype, padded head dim) variant
(:func:`kernel_variant`).
The flash backward (F) routes the same way (:func:`backward_impl`): bf16
at head dim 64 or 128 runs ``csrc/flash_backward_sm90.cu`` (TMA and wgmma,
P and dS in registers), every other case ``csrc/flash_backward.cu``
(WMMA). The dense-bias kernels (G) route by :func:`dense_impl`: bf16 at head
dim 64 or 128 with ``Lk % 4 == 0`` runs ``csrc/flash_dense_sm90.cu`` (TMA
brings the f32 bias tiles beside K and V), every other case
``csrc/flash_dense.cu`` (WMMA). Neither route is a fallback of the other:
each (dtype, head dim, and for G the key length's residue) has exactly one.

Gradients follow the JAX package's custom VJPs. Where an input requires a
gradient, each of the three attention entries runs as a
``torch.autograd.Function``, on either device: :func:`flash_attention`
saves q, k, v, the mask (or the dense bias), O and lse and its backward is
the flash backward (the dense-bias backward);
the token-major entries save their inputs and their backward recomputes
the attention under autograd (:func:`_fused_recompute_fn`), RoPE first for
:func:`rope_fused_attention`. Without a gradient the wrappers run their
forward alone and save nothing.

The predicates :func:`supports`, :func:`rope_fused_supports`,
:func:`fused_supports` and :func:`dense_bias_supported` are the JAX
package's. Their 6 MiB caps are sizes of
the TPU's fast memory, not semantics, but they decide which kernel the
reference runs at which shape; the port keeps them so that each of its
paths is held against the same path of the reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from avatar_tpu_torch.ops.kernel_build import load
from avatar_tpu_torch.ops.normalization import rms_norm
from avatar_tpu_torch.ops.rope import apply_rotary_emb_split
from avatar_tpu_torch.utils.profiling import annotate, annotated

BOUNDED_LOGIT_CLAMP = 80.0
NEG_INF = -1e30
LSE_MASKED = 1e30  # lse of a row with no kept key
# padded head dims of the WMMA kernels' variants (zero columns fill the pad)
PADDED_HEAD_DIMS = (64, 128, 256, 512)
# head dims of the Hopper kernels, A, C-E and F (bf16 only)
SM90_HEAD_DIMS = (64, 128)
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# the reference's largest single block: up to this length (after rounding
# up to 128) for both q and kv, _flash_forward takes the whole-row kernel
SINGLE_BLOCK_MAX = 1024
# the DiT's q/k norm eps (its block norms take cfg.norm_eps)
QK_NORM_EPS = 1e-5
# groups of 16 bytes of a half row that a lane of kernel M holds at most
QK_NORM_ROPE_MAX_GROUPS = 10

# Launches of each CUDA kernel; a wrapper adds one where it launches.
# rope_fused_attention (A), fused_token_attention (B), flash_bounded /
# flash_online / flash_single (C, D, E), flash_bwd_dkv / flash_bwd_dq (F)
# and flash_dense_forward /
# flash_dense_bwd_dkv / _dq / _db (G) count every launch whatever the route;
# the _sm90 and _wmma counters split them by implementation.
launch_counts: Dict[str, int] = {
    "rope_fused_attention": 0, "fused_token_attention": 0,
    "rope_fused_attention_sm90": 0, "rope_fused_attention_wmma": 0,
    "fused_token_attention_sm90": 0, "fused_token_attention_wmma": 0,
    "flash_bounded": 0, "flash_online": 0, "flash_single": 0,
    "flash_bounded_sm90": 0, "flash_online_sm90": 0, "flash_single_sm90": 0,
    "flash_bounded_wmma": 0, "flash_online_wmma": 0, "flash_single_wmma": 0,
    "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
    "flash_bwd_dkv_sm90": 0, "flash_bwd_dq_sm90": 0,
    "flash_bwd_dkv_wmma": 0, "flash_bwd_dq_wmma": 0,
    "flash_dense_forward": 0, "flash_dense_bwd_dkv": 0, "flash_dense_bwd_dq": 0,
    "flash_dense_bwd_db": 0,
    "flash_dense_fwd_sm90": 0, "flash_dense_bwd_dkv_sm90": 0, "flash_dense_bwd_dq_sm90": 0,
    "flash_dense_bwd_db_sm90": 0,
    "flash_dense_fwd_wmma": 0, "flash_dense_bwd_dkv_wmma": 0, "flash_dense_bwd_dq_wmma": 0,
    "flash_dense_bwd_db_wmma": 0, "qk_norm_rope": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Which shapes each kernel path takes (the reference's predicates)
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _sublane(dtype: torch.dtype) -> int:
    return 16 if dtype == torch.bfloat16 else 8


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether "auto" sends head-major [B, H, L, D] tensors to
    :func:`flash_attention`."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        return False
    head_dim = q.shape[-1]
    if head_dim % 8 != 0 or head_dim > 512:
        return False
    return q.shape[2] * k.shape[2] >= 128 * 128


def fused_supports(lq: int, lk: int, heads: int, head_dim: int, dtype) -> bool:
    """Whether the token-major path (:func:`fused_token_attention`) takes
    these lengths: aligned, and an [Lq, Lk] f32 logits slab within 6 MiB."""
    sub = _sublane(dtype)
    max_group = min(heads, max(1, 256 // head_dim))
    groups = [n for n in range(1, max_group + 1) if heads % n == 0]
    return (
        head_dim % 8 == 0
        and head_dim <= 256
        and any((n * head_dim) % 128 == 0 or n == heads for n in groups)
        and lq % sub == 0
        and lk % sub == 0
        and lq * lk * 4 <= 6 * 1024 * 1024
    )


def dense_bias_supported(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether :func:`flash_attention` takes this dense additive bias to
    the dense-bias kernels: [B, 1 or H, Lq, Lk] over head-major q [B, H, Lq,
    D] with ``D % 8 == 0``, ``D <= 512`` and ``Lq * Lk >= 128 * 128``."""
    if bias.ndim != 4 or q.ndim != 4:
        return False
    b, h, lq, d = q.shape
    lk = k.shape[2]
    return (
        bias.shape[0] == b
        and bias.shape[1] in (1, h)
        and bias.shape[2] == lq
        and bias.shape[3] == lk
        and d % 8 == 0
        and d <= 512
        and lq * lk >= 128 * 128
    )


def rope_fused_supports(lq: int, heads: int, head_dim: int, dtype) -> bool:
    """Whether the RoPE-fused path (:func:`rope_fused_attention`) takes this
    length: aligned, and an [L, L] f32 logits slab within 6 MiB."""
    sub = _sublane(dtype)
    groups = [n for n in range(1, heads + 1) if heads % n == 0]
    return (
        head_dim % 16 == 0
        and head_dim <= 256
        and any((n * head_dim // 2) % 128 == 0 or n == heads for n in groups)
        and lq % sub == 0
        and lq * lq * 4 <= 6 * 1024 * 1024
    )


def qk_norm_rope_supports(c: int, heads: int, dtype) -> bool:
    """Whether kernel M (:func:`qk_norm_rope`) takes a width ``c`` over
    ``heads``: bf16 or f32, a head dim that holds whole 16-byte groups in
    each half (a multiple of 16 in bf16, of 8 in f32) and a half row of at
    most ``QK_NORM_ROPE_MAX_GROUPS`` groups a lane of a warp (bf16 up to
    5120 wide, f32 up to 2560)."""
    if dtype not in DTYPE_NAMES or c % heads:
        return False
    vec = 16 // dtype.itemsize  # values in 16 bytes
    return (c // heads) % (2 * vec) == 0 and c // 2 <= 32 * QK_NORM_ROPE_MAX_GROUPS * vec


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _token_attention_plain(q, k, v, kv_mask, heads, scale, bounded):
    b, lq, c = q.shape
    lk = k.shape[1]
    hd = c // heads

    def split(t, n):
        return t.reshape(b, n, heads, hd).transpose(1, 2).float()

    s = torch.einsum("bhqd,bhkd->bhqk", split(q, lq), split(k, lk)) * scale
    keep = None if kv_mask is None else (kv_mask > 0.5)[:, None, None, :]
    if bounded:
        p = torch.exp(torch.clamp(s, max=BOUNDED_LOGIT_CLAMP))
    else:
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), split(v, lk))
    out = (pv / l).to(q.dtype)
    return out.transpose(1, 2).reshape(b, lq, c)


def split_to_head_major(t: torch.Tensor, heads: int) -> torch.Tensor:
    """Global split-half [x1 (C/2) | x2 (C/2)] -> per head [x1_h | x2_h]."""
    b, n, c = t.shape
    t = t.reshape(b, n, 2, heads, c // heads // 2)
    return t.transpose(2, 3).reshape(b, n, c)


def _rope_attention_plain(q, k, v, cos_s, sin_s, heads, scale, bounded):
    qr = split_to_head_major(apply_rotary_emb_split(q, (cos_s, sin_s)), heads)
    kr = split_to_head_major(apply_rotary_emb_split(k, (cos_s, sin_s)), heads)
    return _token_attention_plain(qr, kr, v, None, heads, scale, bounded)


def head_tables(cos_s: torch.Tensor, c: int, heads: int) -> bool:
    """Whether RoPE tables [.., L, w] are per-head ones that every head
    shares (w = the head dim's half, Wan2.1's RoPE) rather than the global
    split-half ones (w = c / 2); with one head the two are the same."""
    return heads > 1 and cos_s.shape[-1] == c // heads // 2


def _qk_norm_rope_plain(q, k, q_weight, k_weight, cos_s, sin_s, heads, q_scale,
                        eps=QK_NORM_EPS):
    """Plain version of kernel M: the chain it replaces, op for op, for q
    and k: ``rms_norm`` (eps 1e-5, the LTX DiT's q/k norm, unless ``eps``
    says otherwise), the split-half RoPE in f32 rounded once, the per-head
    [x1_h | x2_h] order, and for q the multiply by ``q_scale`` (a power of
    two, exact; 1 leaves q). Per-head tables (:func:`head_tables`) are
    repeated over the heads first."""
    if head_tables(cos_s, q.shape[-1], heads):
        cos_s, sin_s = cos_s.repeat(1, 1, heads), sin_s.repeat(1, 1, heads)

    def prologue(t, w):
        t = rms_norm(t, w, eps=eps)
        return split_to_head_major(apply_rotary_emb_split(t, (cos_s, sin_s)), heads)

    q = prologue(q, q_weight)
    return (q * q_scale if q_scale != 1.0 else q), prologue(k, k_weight)


def _flash_plain(q, k, v, kv_mask, scale, mode):
    """Plain version of the three ``_flash_forward`` kernels over head-major
    [B, H, L, D]; returns (out [B, H, Lq, D], lse [B, H, Lq] f32).

    - "bounded" (``_fwd_kernel_bounded``): p = exp(min(s, 80)), lse = log l;
    - "online" (``_fwd_kernel``): masked logits at -1e30, p = exp(s - m),
      lse = m + log l. The kernel keeps a running max over key blocks; the
      final max used here gives the same sums up to the rounding of p;
    - "single" (``_fwd_kernel_single``): as "online" with the whole-row max.

    The denominator: at head_dim < 128 the reference's bounded and online
    kernels sum the p *rounded to the value dtype* (their l rides the PV
    product as a ones-column of v); the single kernel, and both others at
    head_dim >= 128, sum the f32 p. In f32 the two agree; in bf16 l and lse
    differ by up to ~2e-3 relative. Each mode follows its kernel.
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if scale != 1.0:
        s = s * scale
    keep = None if kv_mask is None else (kv_mask > 0.5)[:, None, None, :]
    if mode == "bounded":
        m = None
        p = torch.exp(torch.clamp(s, max=BOUNDED_LOGIT_CLAMP))
    else:
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    pb = p.to(v.dtype).float()
    rounded_sum = mode != "single" and q.shape[-1] < 128
    l = (pb if rounded_sum else p).sum(dim=-1, keepdim=True)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", pb, v.float()) / l_safe
    lse = torch.log(l_safe) if m is None else m + torch.log(l_safe)
    lse = torch.where(empty, torch.full_like(lse, LSE_MASKED), lse)
    return out.to(q.dtype), lse[..., 0]


def _flash_backward_plain(q, k, v, kv_mask, out, lse, g, scale):
    """Plain version of ``_flash_backward``'s two kernels over head-major
    [B, H, L, D]: (dq, dk, dv) from the forward's O and lse [B, H, Lq] and
    the output gradient ``g``. f32 logits and sums; masked keys at -1e30
    before the exp; p rounded to g's dtype for dV and dS to q's (k's) dtype
    for dK (dQ), as ``_bwd_dkv_kernel`` / ``_bwd_dq_kernel`` round them."""
    delta = (g.float() * out.float()).sum(-1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        keep = (kv_mask > 0.5)[:, None, None, :]
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _dense_logits(q, k, bias3, scale):
    """s = fl(fl(q k^T) scale) + bias in f32, [B, H, Lq, Lk]; ``bias3`` is
    the f32 [B or B*H, Lq, Lk] slab tensor."""
    b, _, lq, _ = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return s + bias3.reshape(b, -1, lq, k.shape[2])


def _flash_dense_plain(q, k, v, bias3, scale):
    """Plain version of ``_fwd_kernel_dense_bias``: (out [B, H, Lq, D],
    lse [B, H, Lq] f32). The kernel keeps a running max from -1e30 over key
    tiles; the whole-row max (floored at -1e30) gives the same sums up to
    the rounding of p. Entries with s <= -5e29 get p = 0; p is rounded to
    v's dtype for the PV product and summed in f32; a row with no entry left
    returns 0 and lse = 1e30 (``xla_attention`` would return the mean of v)."""
    s = _dense_logits(q, k, bias3, scale)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l_safe
    lse = torch.where(empty, torch.full_like(l, LSE_MASKED), m + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def _flash_dense_backward_plain(q, k, v, bias3, out, lse, g, scale, with_db=True):
    """Plain version of the dense-bias backward's three kernels: (dq, dk,
    dv, dbias3 or None). p = exp(s - lse) regenerated with the bias, p
    rounded to g's dtype for dV and dS = p (dP - delta) scale to q's (k's)
    dtype for dK (dQ); dBias = p (dP - delta), no scale, summed in f32 over
    the heads that share a slab, [Bb, Lq, Lk] f32."""
    delta = (g.float() * out.float()).sum(-1)
    p = torch.exp(_dense_logits(q, k, bias3, scale) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    dsr = p * (dp - delta[..., None])
    ds = dsr * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    db = None
    if with_db:
        db = dsr.reshape(bias3.shape[0], -1, *dsr.shape[2:]).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), db


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def padded_head_dim(d: int) -> int:
    """The WMMA variant's head dim for ``d``: the smallest of
    :data:`PADDED_HEAD_DIMS` that holds it."""
    return next(p for p in PADDED_HEAD_DIMS if p >= d)


def kernel_variant(dtype: torch.dtype, d: int) -> Tuple[str, Tuple[str, ...]]:
    """(C entry suffix, ``nvcc`` defines) of the WMMA attention kernels'
    build for ``dtype`` and head dim ``d``: ``("bf16", ())`` is the default
    bf16 / 64 build; f32 adds ``ATTN_F32=1``, a larger padded head dim
    ``ATTN_D=<dim>``."""
    defines = ("ATTN_F32=1",) if dtype == torch.float32 else ()
    kd = padded_head_dim(d)
    if kd != 64:
        defines += (f"ATTN_D={kd}",)
    return DTYPE_NAMES[dtype], defines


def _route(dtype: torch.dtype, d: int) -> str:
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS else "wmma"


def forward_impl(mode: str, dtype: torch.dtype, d: int) -> str:
    """Which implementation runs a ``_flash_forward`` mode (C, D or E; all
    three route alike) on the card: "sm90" (``csrc/flash_forward_sm90.cu``)
    at bf16 with head dim 64 or 128, else "wmma" (``csrc/flash_forward.cu``)."""
    return _route(dtype, d)


def rope_impl(dtype: torch.dtype, d: int) -> str:
    """Which implementation runs A on the card: "sm90"
    (``csrc/rope_attention_sm90.cu``) at bf16 with head dim 64 or 128, else
    "wmma" (``csrc/rope_attention.cu``)."""
    return _route(dtype, d)


def token_impl(dtype: torch.dtype, d: int) -> str:
    """Which implementation runs B on the card: "sm90"
    (``csrc/token_attention_sm90.cu``) at bf16 with head dim 64 or 128, else
    "wmma" (``csrc/token_attention.cu``)."""
    return _route(dtype, d)


def backward_impl(dtype: torch.dtype, d: int) -> str:
    """Which implementation runs the flash backward (F) on the card:
    "sm90" (``csrc/flash_backward_sm90.cu``) at bf16 with head dim 64 or
    128, else "wmma" (``csrc/flash_backward.cu``)."""
    return _route(dtype, d)


def dense_impl(dtype: torch.dtype, d: int, lk: int) -> str:
    """Which implementation runs the dense-bias attention's four kernels (G)
    on the card: "sm90" (``csrc/flash_dense_sm90.cu``) at bf16 with head dim
    64 or 128 and ``lk % 4 == 0`` (the f32 bias rows' stride, ``lk * 4``
    bytes, must be a multiple of 16 for the tensor maps that load the bias
    tiles), else "wmma" (``csrc/flash_dense.cu``)."""
    return _route(dtype, d) if lk % 4 == 0 else "wmma"


def sm90_defines(d: int) -> Tuple[str, ...]:
    """``nvcc`` defines of a Hopper kernel's build for head dim ``d``: none
    at 64, ``ATTN_D=128`` at 128."""
    return () if d == 64 else (f"ATTN_D={d}",)


def check_kernel_args(kernel: str, dtype: torch.dtype, d: int, max_d: int,
                      multiple: int = 8) -> None:
    """Raise where the reference's predicate for this kernel's path refuses:
    a dtype other than bf16 or f32 (fp16 reaches no path of either
    package), a head dim that is not a multiple of ``multiple`` or above
    ``max_d``."""
    if dtype not in DTYPE_NAMES:
        raise ValueError(f"{kernel}: the CUDA kernels take bf16 or f32, got {dtype}")
    if d < multiple or d % multiple or d > max_d:
        raise ValueError(f"{kernel}: head_dim must be a multiple of {multiple} up to "
                         f"{max_d}, got {d}")


def _check_cuda(name: str, t: torch.Tensor, shape, dtype, contiguous: bool = True):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if (contiguous and not t.is_contiguous()) or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _split_heads(kernel: str, c: int, heads: int, dtype, multiple: int) -> int:
    """Head dim of a token-major width ``c`` over ``heads``, checked
    against the token-major kernels' limits (up to 256)."""
    if c % heads:
        raise ValueError(f"{kernel}: width {c} does not split over {heads} heads")
    d = c // heads
    check_kernel_args(kernel, dtype, d, 256, multiple)
    return d


def _c_entry(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int,
             bounded_flag: bool = True, defines: Tuple[str, ...] = ()):
    """The C entry ``fn_name(ptr * n_ptrs, int * n_ints, float scale,
    [int bounded,] void* stream) -> cudaError_t`` of ``csrc/<lib_name>.cu``
    built with ``defines``."""
    fn = getattr(load(lib_name, defines), fn_name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float] + [ctypes.c_int] * bounded_flag
            + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def _wrapper_device(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@annotated("attn.A")
def _rope_forward(q, k, v, cos_s, sin_s, heads, scale, bounded):
    if _wrapper_device(q) == "cpu":
        return _rope_attention_plain(q, k, v, cos_s, sin_s, heads, scale, bounded)
    b, l, c = q.shape
    d = _split_heads("rope_fused_attention", c, heads, q.dtype, 16)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, (b, l, c), q.dtype)
    for name, t in (("cos", cos_s), ("sin", sin_s)):
        _check_cuda(name, t, (b, l, c // 2), q.dtype)
    out = torch.empty_like(q)
    impl = rope_impl(q.dtype, d)
    if impl == "sm90":
        lib, name, defines = "rope_attention_sm90", "rope_attention_sm90_bf16", sm90_defines(d)
    else:
        suffix, defines = kernel_variant(q.dtype, d)
        lib, name = "rope_attention", f"rope_attention_{suffix}"
    fn = _c_entry(lib, name, 6, 4, defines=defines)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_s.data_ptr(),
        sin_s.data_ptr(), out.data_ptr(), b, l, heads, d, float(scale),
        int(bool(bounded)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, name)
    launch_counts["rope_fused_attention"] += 1
    launch_counts[f"rope_fused_attention_{impl}"] += 1
    return out


@annotated("attn.B")
def _token_forward(q, k, v, kv_mask, heads, scale, bounded):
    if _wrapper_device(q) == "cpu":
        return _token_attention_plain(q, k, v, kv_mask, heads, scale, bounded)
    b, lq, c = q.shape
    lk = k.shape[1]
    d = _split_heads("fused_token_attention", c, heads, q.dtype, 8)
    _check_cuda("q", q, (b, lq, c), q.dtype)
    _check_cuda("k", k, (b, lk, c), q.dtype)
    _check_cuda("v", v, (b, lk, c), q.dtype)
    mask_ptr = None
    if kv_mask is not None:
        _check_cuda("kv_mask", kv_mask, (b, lk), torch.float32)
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    impl = token_impl(q.dtype, d)
    if impl == "sm90":
        name = "token_attention_sm90_bf16"
        fn = getattr(load("token_attention_sm90", sm90_defines(d)), name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 12
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        q_strides = token_major_strides(b, lq, c, heads)
        kv_strides = token_major_strides(b, lk, c, heads)
        strides = [*q_strides, *kv_strides, *kv_strides, *q_strides]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                 b, heads, lq, lk, d, *strides, float(scale), int(bool(bounded)), stream)
    else:
        suffix, defines = kernel_variant(q.dtype, d)
        name = f"token_attention_{suffix}"
        fn = _c_entry("token_attention", name, 5, 5, defines=defines)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                 b, lq, lk, heads, d, float(scale), int(bool(bounded)), stream)
    _raise_on(err, name)
    launch_counts["fused_token_attention"] += 1
    launch_counts[f"fused_token_attention_{impl}"] += 1
    return out


@annotated("attn.M")
def qk_norm_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    q_weight: torch.Tensor,
    k_weight: torch.Tensor,
    cos_s: torch.Tensor,
    sin_s: torch.Tensor,
    heads: int,
    scale: float,
    eps: float = QK_NORM_EPS,
) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Self-attention's q/k prologue where RoPE runs before a head-major
    kernel (kernel M, ``csrc/qk_norm_rope.cu``): q and k [B, L, C] in the
    global split-half order, their RMS norms' scales [C] (and ``eps``), the
    split tables cos_s / sin_s [B or 1, L, C/2], or per-head ones [B or 1,
    L, C/heads/2] that every head shares (:func:`head_tables`; Wan2.1's
    RoPE). Returns (q', k', the scale left for the
    attention): q' and k' [B, L, C] normed, rotated and in the per-head
    [x1_h | x2_h] order of :func:`split_to_head_major`, whose head-major
    views the Hopper C reads in place; a power-of-two ``scale`` is folded
    into q' as :func:`fold_scale` folds it (then 1.0 is left), any other
    stays. The same bits as that chain, up to the order of the sums of
    squares. No gradient: the caller takes the chain where one is needed."""
    folded = _folds(scale)
    q_scale, left = (scale, 1.0) if folded else (1.0, scale)
    if _wrapper_device(q) == "cpu":
        return (*_qk_norm_rope_plain(q, k, q_weight, k_weight, cos_s, sin_s, heads, q_scale,
                                     eps), left)
    b, l, c = q.shape
    per_head = head_tables(cos_s, c, heads)
    if not qk_norm_rope_supports(c, heads, q.dtype):
        raise ValueError(f"qk_norm_rope: width {c} over {heads} heads in {q.dtype} "
                         "is not one kernel M takes")
    q_weight, k_weight = q_weight.to(q.dtype), k_weight.to(q.dtype)
    for name, t in (("q", q), ("k", k)):
        _check_cuda(name, t, (b, l, c), q.dtype)
    for name, t in (("q_weight", q_weight), ("k_weight", k_weight)):
        _check_cuda(name, t, (c,), q.dtype)
    for name, t in (("cos", cos_s), ("sin", sin_s)):
        _check_cuda(name, t, (cos_s.shape[0] if cos_s.shape[0] == 1 else b, l,
                              c // heads // 2 if per_head else c // 2), q.dtype)
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    fn = getattr(load("qk_norm_rope"), "qk_norm_rope")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), q_weight.data_ptr(), k_weight.data_ptr(),
             cos_s.data_ptr(), sin_s.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
             b * l, cos_s.shape[0] * l, c, heads, eps, q_scale,
             int(q.dtype == torch.float32), int(per_head),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "qk_norm_rope")
    launch_counts["qk_norm_rope"] += 1
    return q_out, k_out, left


def _fused_recompute_fn(q_shape, heads, kv_mask, scale, k_len=None):
    """The function of (q, k, v) token-major that the token-major entries'
    backward differentiates (``_fused_recompute_fn`` of the JAX package):
    head-major :func:`flash_attention`, unbounded, whose own gradient is the
    flash backward, where ``head_dim % 8 == 0``, ``head_dim <= 512`` and
    ``lq * lk >= 128 * 128``; else plain attention with a -1e30 bias on
    masked keys. The JAX package also asks for a TPU backend before it takes
    the flash route; the port takes the same route on either device."""
    b, lq, c = q_shape
    hd = c // heads
    lk = lq if k_len is None else k_len

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)

    def merge(out):
        return out.transpose(1, 2).reshape(b, lq, c)

    if hd % 8 == 0 and hd <= 512 and lq * lk >= 128 * 128:
        return lambda q_, k_, v_: merge(flash_attention(
            split(q_), split(k_), split(v_), kv_mask=kv_mask, scale=scale))

    from avatar_tpu_torch.ops.attention import xla_attention

    bias = None
    if kv_mask is not None:
        bias = torch.where(kv_mask > 0.5, 0.0, NEG_INF).float()[:, None, None, :]
    return lambda q_, k_, v_: merge(xla_attention(
        split(q_), split(k_), split(v_), bias, scale))


def _recompute_grads(fn, tensors, g):
    """Gradients of ``fn(*tensors)`` against ``g``, recomputed under
    autograd from detached copies of ``tensors``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in tensors]
        return torch.autograd.grad(fn(*leaves), leaves, g)


class _RopeFusedFn(torch.autograd.Function):
    """Kernel A with the gradient of ``_rope_fused_bwd``: saves q, k, v and
    the (cos, sin) tables; the backward rotates q and k, relays them out
    head-major and recomputes the attention, all under autograd, so the
    RoPE's VJP chains onto the recompute's. cos and sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos_s, sin_s, heads, scale, bounded):
        ctx.save_for_backward(q, k, v, cos_s, sin_s)
        ctx.heads, ctx.scale = heads, scale
        return _rope_forward(q, k, v, cos_s, sin_s, heads, scale, bounded)

    @staticmethod
    def backward(ctx, g):
        q, k, v, cos_s, sin_s = ctx.saved_tensors
        heads = ctx.heads
        recompute = _fused_recompute_fn(q.shape, heads, None, ctx.scale)

        def ref(q_, k_, v_):
            qr = split_to_head_major(apply_rotary_emb_split(q_, (cos_s, sin_s)), heads)
            kr = split_to_head_major(apply_rotary_emb_split(k_, (cos_s, sin_s)), heads)
            return recompute(qr, kr, v_)

        dq, dk, dv = _recompute_grads(ref, (q, k, v), g)
        return dq, dk, dv, None, None, None, None, None


class _FusedTokenFn(torch.autograd.Function):
    """Kernel B with the gradient of ``_fused_bwd``: saves q, k, v and the
    mask; the backward recomputes the attention under autograd. The mask
    gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, heads, scale, bounded):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.heads, ctx.scale = heads, scale
        return _token_forward(q, k, v, kv_mask, heads, scale, bounded)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        recompute = _fused_recompute_fn(q.shape, ctx.heads, kv_mask, ctx.scale,
                                        k_len=k.shape[1])
        dq, dk, dv = _recompute_grads(recompute, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def rope_fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos_s: torch.Tensor,
    sin_s: torch.Tensor,
    heads: int,
    scale: float,
    bounded: bool = False,
) -> torch.Tensor:
    """Self-attention; q/k [B, L, C] in global split-half channel order,
    v [B, L, C] token-major, cos_s/sin_s [B, L, C/2]. Returns [B, L, C].
    Differentiable in q, k and v (:class:`_RopeFusedFn`)."""
    if _needs_grad(q, k, v):
        return _RopeFusedFn.apply(q, k, v, cos_s, sin_s, heads, scale, bounded)
    return _rope_forward(q, k, v, cos_s, sin_s, heads, scale, bounded)


def fused_token_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    heads: int,
    scale: float,
    bounded: bool = False,
) -> torch.Tensor:
    """Attention over token-major q [B, Lq, C] and k/v [B, Lk, C] with an
    optional [B, Lk] keep-mask (> 0.5 keeps). Returns [B, Lq, C].
    Differentiable in q, k and v (:class:`_FusedTokenFn`)."""
    if _needs_grad(q, k, v):
        return _FusedTokenFn.apply(q, k, v, kv_mask, heads, scale, bounded)
    return _token_forward(q, k, v, kv_mask, heads, scale, bounded)


def flash_mode(lq: int, lk: int, bounded: bool) -> str:
    """Which kernel ``_flash_forward`` runs: the whole-row one when both
    lengths fit one block of the reference (even when ``bounded``), else
    the max-free one for bounded logits, else the online one."""
    if (_round_up(lq, 128) <= SINGLE_BLOCK_MAX
            and _round_up(lk, 128) <= SINGLE_BLOCK_MAX):
        return "single"
    return "bounded" if bounded else "online"


def fold_scale(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """(q, scale) as ``_flash_forward`` hands them to its kernel: a
    power-of-two scale is folded into q, as the reference does: exact (an
    exponent shift; head_dim 64 gives 0.125), so the logits and the saved
    lse are the same bits either way. Any other scale stays, to multiply
    the f32 logits (folding it would round q)."""
    if _folds(scale):
        return q * scale, 1.0
    return q, scale


def _folds(scale: float) -> bool:
    """Whether :func:`fold_scale` folds ``scale`` into q: a power of two
    other than 1."""
    return scale > 0.0 and math.frexp(scale)[0] == 0.5 and scale != 1.0


def _tma_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """Element strides (batch, head, row) of a head-major [B, H, L, D] bf16
    tensor that the Hopper kernel's tensor maps can read in place (last
    stride 1, the others multiples of 8 elements, a 16-byte aligned base),
    else None. A dimension of size 1 gets a stride that TMA accepts."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    b, h, l, d = t.shape
    sb, sh, sl = t.stride(0), t.stride(1), t.stride(2)
    if l == 1:
        sl = d
    if h == 1:
        sh = l * sl
    if b == 1:
        sb = h * sh
    if any(x % 8 for x in (sb, sh, sl)):
        return None
    return sb, sh, sl


def token_major_strides(b: int, length: int, c: int, heads: int) -> Tuple[int, int, int]:
    """Element strides (batch, head, row) of the head-major view [B, H, L,
    d] of a contiguous token-major [B, L, H*d] tensor, as
    :func:`_tma_strides` gives them for that view (a size-1 dimension gets
    a stride TMA accepts), computed from the shape alone, without making
    the view: it runs on the host at every launch of the Hopper B."""
    d = c // heads
    sl = c if length > 1 else d
    sh = d if heads > 1 else length * sl
    sb = length * c if b > 1 else heads * sh
    return sb, sh, sl


# the mode argument of flash_sm90_bf16
SM90_MODES = {"bounded": 0, "online": 1, "single": 2}
# the span of each forward kernel
MODE_SPANS = {"bounded": "attn.C", "online": "attn.D", "single": "attn.E"}


def _flash_sm90_call(q, k, v, kv_mask, out, lse, mode, scale):
    """Launch ``flash_sm90_bf16`` (``csrc/flash_forward_sm90.cu``, the
    ``ATTN_D=128`` build at head dim 128) on tensors whose strides
    :func:`_tma_strides` takes."""
    b, heads, lq, d = q.shape
    lk = k.shape[2]
    fn = getattr(load("flash_forward_sm90", sm90_defines(d)), "flash_sm90_bf16")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    strides = [x for t in (q, k, v, out) for x in _tma_strides(t)]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, heads, lq, lk, d, *strides, float(scale),
             SM90_MODES[mode], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_sm90_bf16")


def _flash_forward(q, k, v, kv_mask, scale: float, bounded: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) through the kernel that :func:`flash_mode` names, by the
    route that :func:`forward_impl` names. The Hopper route reads q, k and
    v in place where their strides allow (the DiT's head-major views of
    token-major tensors) and writes O in q's layout; the WMMA route reads
    and writes contiguous tensors."""
    b, heads, lq, d = q.shape
    lk = k.shape[2]
    mode = flash_mode(lq, lk, bounded)
    with annotate(MODE_SPANS[mode]):
        q, scale = fold_scale(q, scale)
        if _wrapper_device(q) == "cpu":
            return _flash_plain(q, k, v, kv_mask, scale, mode)
        check_kernel_args("flash_attention", q.dtype, d, 512)
        impl = forward_impl(mode, q.dtype, d)
        if impl == "sm90":
            # a layout the tensor maps cannot read is copied, as on the WMMA route
            q, k, v = (t if _tma_strides(t) is not None else t.contiguous()
                       for t in (q, k, v))
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        for name, t, n in (("q", q, lq), ("k", k, lk), ("v", v, lk)):
            _check_cuda(name, t, (b, heads, n, d), q.dtype, contiguous=impl == "wmma")
        mask_ptr = None
        if kv_mask is not None:
            kv_mask = kv_mask.to(torch.float32).contiguous()
            _check_cuda("kv_mask", kv_mask, (b, lk), torch.float32)
            mask_ptr = kv_mask.data_ptr()
        # empty_like keeps q's layout: a token-major view gets a token-major O
        out = torch.empty_like(q)
        lse = torch.empty((b, heads, lq), device=q.device, dtype=torch.float32)
        name = f"flash_{mode}"
        if impl == "sm90":
            _flash_sm90_call(q, k, v, kv_mask, out, lse, mode, scale)
        else:
            suffix, defines = kernel_variant(q.dtype, d)
            fn = _c_entry("flash_forward", f"{name}_{suffix}", 6, 5, bounded_flag=False,
                          defines=defines)
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                lse.data_ptr(), b, heads, lq, lk, d, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
            _raise_on(err, f"{name}_{suffix}")
        launch_counts[name] += 1
        launch_counts[f"{name}_{impl}"] += 1
        return out, lse


def _check_backward_inputs(q, k, v, g, lse, delta, kv_mask):
    b, heads, lq, d = q.shape
    lk = k.shape[2]
    check_kernel_args("flash_attention backward", q.dtype, d, 512)
    for name, t, n in (("q", q, lq), ("k", k, lk), ("v", v, lk), ("g", g, lq)):
        _check_cuda(name, t, (b, heads, n, d), q.dtype)
    for name, t in (("lse", lse), ("delta", delta)):
        _check_cuda(name, t, (b, heads, lq), torch.float32)
    if kv_mask is not None:
        _check_cuda("kv_mask", kv_mask, (b, lk), torch.float32)
    return b, heads, lq, lk, d


def _backward_entry(kernel: str, dtype: torch.dtype, d: int, n_ptrs: int):
    """(route, C entry name, entry) of F's ``kernel`` ("dkv" or "dq") by the
    route :func:`backward_impl` names."""
    impl = backward_impl(dtype, d)
    if impl == "sm90":
        lib, suffix, defines = "flash_backward_sm90", "sm90_bf16", sm90_defines(d)
    else:
        lib = "flash_backward"
        suffix, defines = kernel_variant(dtype, d)
    name = f"flash_bwd_{kernel}_{suffix}"
    return impl, name, _c_entry(lib, name, n_ptrs, 5, bounded_flag=False, defines=defines)


def flash_bwd_dkv(q, k, v, g, lse, delta, kv_mask, scale: float):
    """Kernel F dK/dV (``_bwd_dkv_kernel``): (dk, dv) of head-major
    attention from contiguous q, k, v, the output gradient g, lse and
    delta = rowsum(g * O) [B, H, Lq] f32, with the caller's scale, by the
    route :func:`backward_impl` names. CUDA tensors only."""
    b, heads, lq, lk, d = _check_backward_inputs(q, k, v, g, lse, delta, kv_mask)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    impl, name, fn = _backward_entry("dkv", q.dtype, d, 9)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), None if kv_mask is None else kv_mask.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, heads, lq, lk, d, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    launch_counts["flash_bwd_dkv"] += 1
    launch_counts[f"flash_bwd_dkv_{impl}"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, g, lse, delta, kv_mask, scale: float):
    """Kernel F dQ (``_bwd_dq_kernel``): dq, with the arguments and the
    route of :func:`flash_bwd_dkv`. CUDA tensors only."""
    b, heads, lq, lk, d = _check_backward_inputs(q, k, v, g, lse, delta, kv_mask)
    dq = torch.empty_like(q)
    impl, name, fn = _backward_entry("dq", q.dtype, d, 8)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), None if kv_mask is None else kv_mask.data_ptr(),
             dq.data_ptr(), b, heads, lq, lk, d, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    launch_counts["flash_bwd_dq"] += 1
    launch_counts[f"flash_bwd_dq_{impl}"] += 1
    return dq


@annotated("attn.F")
def _flash_backward(q, k, v, kv_mask, out, lse, g, scale: float):
    """(dq, dk, dv) of :func:`flash_attention` at the caller's q and scale:
    the two backward kernels on the card, their plain version on the CPU.
    delta = rowsum(g * O) in f32 is one PyTorch reduction on either."""
    if _wrapper_device(q) == "cpu":
        return _flash_backward_plain(q, k, v, kv_mask, out, lse, g, scale)
    g = g.contiguous()
    delta = (g.float() * out.float()).sum(-1)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, kv_mask, scale)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, kv_mask, scale)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """Kernels C/D/E with the gradient of ``_flash``'s custom VJP: the
    forward saves q (the caller's, before any scale folding), k, v, the
    mask, O and lse; the backward runs the flash backward. lse is returned
    without a gradient; the mask gets none."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, bounded):
        out, lse = _flash_forward(q, k, v, kv_mask, scale, bounded)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, kv_mask, out, lse, g, ctx.scale)
        return dq, dk, dv, None, None, None


def _check_dense_inputs(q, k, v, bias3, tensors=()):
    """Shapes of the dense-bias kernels' operands; returns (b, heads, lq,
    lk, heads_group, d)."""
    b, heads, lq, d = q.shape
    lk = k.shape[2]
    check_kernel_args("flash_attention(bias=...)", q.dtype, d, 512)
    bb = bias3.shape[0]
    if bb not in (b, b * heads):
        raise ValueError(f"bias slabs {bb}: expected {b} or {b * heads}")
    for name, t, n in (("q", q, lq), ("k", k, lk), ("v", v, lk)) + tuple(tensors):
        _check_cuda(name, t, (b, heads, n, d), q.dtype)
    _check_cuda("bias", bias3, (bb, lq, lk), torch.float32)
    return b, heads, lq, lk, b * heads // bb, d


_DENSE_POINTERS = {"fwd": 6, "bwd_dkv": 9, "bwd_dq": 8, "bwd_db": 8}


def _dense_entry(kernel: str, route: str, dtype: torch.dtype, d: int):
    """(C entry name, entry) of G's ``kernel`` ("fwd", "bwd_dkv", "bwd_dq" or
    "bwd_db") on ``route`` ("sm90" or "wmma", as :func:`dense_impl` names
    it)."""
    if route == "sm90":
        lib, suffix, defines = "flash_dense_sm90", "sm90_bf16", sm90_defines(d)
    else:
        lib = "flash_dense"
        suffix, defines = kernel_variant(dtype, d)
    name = f"flash_dense_{kernel}_{suffix}"
    return name, _c_entry(lib, name, _DENSE_POINTERS[kernel], 6, bounded_flag=False,
                          defines=defines)


@annotated("attn.G")
def _flash_dense_forward(q, k, v, bias3, scale: float):
    """(out, lse) of the dense-bias forward: kernel ``flash_dense_fwd_*`` on
    the card by the route :func:`dense_impl` names, its plain version on the
    CPU."""
    if _wrapper_device(q) == "cpu":
        return _flash_dense_plain(q, k, v, bias3, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, heads, lq, lk, group, d = _check_dense_inputs(q, k, v, bias3)
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, lq), device=q.device, dtype=torch.float32)
    route = dense_impl(q.dtype, d, lk)
    name, fn = _dense_entry("fwd", route, q.dtype, d)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias3.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, heads, lq, lk, group, d, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    launch_counts["flash_dense_forward"] += 1
    launch_counts[f"flash_dense_fwd_{route}"] += 1
    return out, lse


def _dense_backward_call(kernel, q, k, v, g, lse, delta, bias3, outs, scale):
    b, heads, lq, lk, group, d = _check_dense_inputs(q, k, v, bias3,
                                                     (("g", g, q.shape[2]),))
    for label, t in (("lse", lse), ("delta", delta)):
        _check_cuda(label, t, (b, heads, lq), torch.float32)
    route = dense_impl(q.dtype, d, lk)
    name, fn = _dense_entry(kernel, route, q.dtype, d)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), bias3.data_ptr(), *(t.data_ptr() for t in outs),
             b, heads, lq, lk, group, d, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    launch_counts[f"flash_dense_{kernel}"] += 1
    launch_counts[f"flash_dense_{kernel}_{route}"] += 1


def flash_dense_bwd_dkv(q, k, v, g, lse, delta, bias3, scale: float):
    """Kernel ``flash_dense_bwd_dkv_*`` (``_bwd_dkv_kernel_bias``): (dk, dv)
    of head-major attention with the f32 bias slabs ``bias3`` [B or B*H, Lq,
    Lk], from contiguous q, k, v, the output gradient g, lse and delta =
    rowsum(g * O) [B, H, Lq] f32, by the route :func:`dense_impl` names.
    CUDA tensors only."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _dense_backward_call("bwd_dkv", q, k, v, g, lse, delta, bias3, (dk, dv), scale)
    return dk, dv


def flash_dense_bwd_dq(q, k, v, g, lse, delta, bias3, scale: float):
    """Kernel ``flash_dense_bwd_dq_*`` (``_bwd_dq_kernel_bias``): dq, with the
    arguments and the route of :func:`flash_dense_bwd_dkv`. CUDA tensors
    only."""
    dq = torch.empty_like(q)
    _dense_backward_call("bwd_dq", q, k, v, g, lse, delta, bias3, (dq,), scale)
    return dq


def flash_dense_bwd_db(q, k, v, g, lse, delta, bias3, scale: float):
    """Kernel ``flash_dense_bwd_db_*`` (``_bwd_db_kernel``): dBias [B or B*H,
    Lq, Lk] f32, each slab summed over the heads that share it in head
    order, with the arguments and the route of :func:`flash_dense_bwd_dkv`.
    CUDA tensors only."""
    db = torch.empty_like(bias3)
    _dense_backward_call("bwd_db", q, k, v, g, lse, delta, bias3, (db,), scale)
    return db


@annotated("attn.G")
def _flash_dense_backward(q, k, v, bias3, out, lse, g, scale: float, with_db: bool):
    """(dq, dk, dv, dbias3 or None) of the dense-bias attention: the three
    backward kernels on the card (dBias only ``with_db``), their plain
    version on the CPU. delta = rowsum(g * O) in f32 is one PyTorch
    reduction on either."""
    if _wrapper_device(q) == "cpu":
        return _flash_dense_backward_plain(q, k, v, bias3, out, lse, g, scale, with_db)
    g = g.contiguous()
    delta = (g.float() * out.float()).sum(-1)
    dk, dv = flash_dense_bwd_dkv(q, k, v, g, lse, delta, bias3, scale)
    dq = flash_dense_bwd_dq(q, k, v, g, lse, delta, bias3, scale)
    db = flash_dense_bwd_db(q, k, v, g, lse, delta, bias3, scale) if with_db else None
    return dq, dk, dv, db


def _dense_bias3(bias: torch.Tensor) -> torch.Tensor:
    """[B, 1 or H, Lq, Lk] -> contiguous f32 slabs [B or B*H, Lq, Lk]; an
    expanded (stride-0) bias is copied, so the kernels read real memory."""
    return bias.float().reshape(-1, *bias.shape[2:]).contiguous()


class _FlashDenseFn(torch.autograd.Function):
    """Kernel G with the gradient of ``_flash_dense``'s custom VJP: the
    forward saves q, k, v, the f32 bias slabs, O and lse; the backward
    returns dq, dk, dv and, where the bias requires it, dBias in the bias's
    shape and dtype (autograd sums it over any broadcast that made the
    bias). lse is returned without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        bias3 = _dense_bias3(bias)
        out, lse = _flash_dense_forward(q, k, v, bias3, scale)
        ctx.save_for_backward(q, k, v, bias3, out, lse)
        ctx.scale, ctx.bias_shape, ctx.bias_dtype = scale, bias.shape, bias.dtype
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, bias3, out, lse = ctx.saved_tensors
        dq, dk, dv, db = _flash_dense_backward(q, k, v, bias3, out, lse, g, ctx.scale,
                                               with_db=ctx.needs_input_grad[3])
        if db is not None:
            db = db.to(ctx.bias_dtype).reshape(ctx.bias_shape)
        return dq, dk, dv, db, None


def _flash_dense(q, k, v, bias, scale: float):
    """(out, lse) of attention with a dense bias that
    :func:`dense_bias_supported` takes; differentiable in q, k, v and the
    bias (:class:`_FlashDenseFn`)."""
    if _needs_grad(q, k, v, bias):
        return _FlashDenseFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                                   scale)
    return _flash_dense_forward(q, k, v, _dense_bias3(bias), scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    bounded_logits: bool = False,
    with_lse: bool = False,
):
    """Flash attention over head-major [B, H, L, D].

    Takes a [B, Lk] keep-mask (``kv_mask``) or an additive ``bias`` (used
    only without ``kv_mask``, as in the JAX package), routed as the JAX
    package routes it:

    - a per-key bias [B, 1, 1, Lk] becomes a keep-mask (bias >= -1 keeps)
      for the keep-mask kernels;
    - a dense bias that :func:`dense_bias_supported` takes ([B, 1 or H, Lq,
      Lk], any float dtype) goes to the dense-bias kernels: entries at or
      below -5e29 count as masked, a row with none left returns 0 (lse
      1e30), and the bias gets a gradient;
    - any other bias goes to ``xla_attention``, the JAX package's own rule
      for the layouts its kernel does not take (no lse there).

    ``bounded_logits``: the caller guarantees logits far below the f32 exp
    limit (true after qk-norm), so long sequences take the max-free kernel
    (the dense-bias path has one kernel and ignores it). ``with_lse`` also
    returns the row log-sum-exp [B, H, Lq] f32 (1e30 for a row with no kept
    key). Differentiable in q, k and v (:class:`_FlashFn`,
    :class:`_FlashDenseFn`).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None and kv_mask is None:
        if bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
            kv_mask = (bias[:, 0, 0, :] >= -1.0).to(torch.float32)
        elif dense_bias_supported(q, k, bias):
            out, lse = _flash_dense(q, k, v, bias, float(scale))
            return (out, lse) if with_lse else out
        else:
            if with_lse:
                raise ValueError("with_lse: this bias layout takes xla_attention, "
                                 "which returns no lse")
            from avatar_tpu_torch.ops.attention import xla_attention

            return xla_attention(q, k, v, bias, scale)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    args = (float(scale), bool(bounded_logits))
    if _needs_grad(q, k, v):
        # contiguous before the Function, so that it saves what the
        # kernels read and the backward copies nothing again
        out, lse = _FlashFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                  kv_mask, *args)
    else:
        out, lse = _flash_forward(q, k, v, kv_mask, *args)
    return (out, lse) if with_lse else out
