"""The DiT's two attention kernels (port of the token-major kernels of
``avatar_tpu/ops/flash_attention.py``).

- :func:`rope_fused_attention`: self-attention over split-half RoPE-layout
  q/k with the rotation done inside the kernel (``csrc/rope_attention.cu``,
  replacing ``_rope_token_kernel``).
- :func:`fused_token_attention`: attention with an optional [B, Lk]
  keep-mask (``csrc/token_attention.cu``, replacing ``_token_major_kernel``).

Both take token-major [B, L, heads*head_dim] tensors. On a CUDA tensor the
wrapper launches its kernel (bf16, head_dim 64) or raises; on a CPU tensor
it runs the plain PyTorch version beside it, which computes the same
function with the kernel's masking: masked keys get p = 0 and a row with
every key masked returns 0. ``bounded`` (qk-normed logits) drops the
softmax max pass: p = exp(min(s, 80)).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from avatar_tpu_torch.ops.kernel_build import load
from avatar_tpu_torch.ops.rope import apply_rotary_emb_split

BOUNDED_LOGIT_CLAMP = 80.0
NEG_INF = -1e30
KERNEL_HEAD_DIM = 64

# Launches of each CUDA kernel; a wrapper adds one where it launches.
launch_counts: Dict[str, int] = {
    "rope_fused_attention": 0, "fused_token_attention": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


def _split_to_head_major(t, heads):
    # global split-half [x1(C/2) | x2(C/2)] -> per head [x1_h | x2_h]
    b, n, c = t.shape
    t = t.reshape(b, n, 2, heads, c // heads // 2)
    return t.transpose(2, 3).reshape(b, n, c)


def _rope_attention_plain(q, k, v, cos_s, sin_s, heads, scale, bounded):
    qr = _split_to_head_major(apply_rotary_emb_split(q, (cos_s, sin_s)), heads)
    kr = _split_to_head_major(apply_rotary_emb_split(k, (cos_s, sin_s)), heads)
    return _token_attention_plain(qr, kr, v, None, heads, scale, bounded)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, t: torch.Tensor, shape, dtype=torch.bfloat16):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _check_heads(c: int, heads: int):
    if c % heads or c // heads != KERNEL_HEAD_DIM:
        raise ValueError(
            f"CUDA attention kernels take head_dim {KERNEL_HEAD_DIM}; "
            f"got width {c} over {heads} heads"
        )


def _c_entry(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int):
    """The C entry ``fn_name(ptr * n_ptrs, int * n_ints, float scale,
    int bounded, void* stream) -> cudaError_t`` of ``csrc/<lib_name>.cu``."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def _wrapper_device(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


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
    v [B, L, C] token-major, cos_s/sin_s [B, L, C/2]. Returns [B, L, C]."""
    if _wrapper_device(q) == "cpu":
        return _rope_attention_plain(q, k, v, cos_s, sin_s, heads, scale, bounded)
    b, l, c = q.shape
    _check_heads(c, heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, (b, l, c))
    for name, t in (("cos", cos_s), ("sin", sin_s)):
        _check_cuda(name, t, (b, l, c // 2))
    out = torch.empty_like(q)
    fn = _c_entry("rope_attention", "rope_attention_bf16", 6, 3)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_s.data_ptr(),
        sin_s.data_ptr(), out.data_ptr(), b, l, heads, float(scale),
        int(bool(bounded)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "rope_attention_bf16")
    launch_counts["rope_fused_attention"] += 1
    return out


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
    optional [B, Lk] keep-mask (> 0.5 keeps). Returns [B, Lq, C]."""
    if _wrapper_device(q) == "cpu":
        return _token_attention_plain(q, k, v, kv_mask, heads, scale, bounded)
    b, lq, c = q.shape
    lk = k.shape[1]
    _check_heads(c, heads)
    _check_cuda("q", q, (b, lq, c))
    _check_cuda("k", k, (b, lk, c))
    _check_cuda("v", v, (b, lk, c))
    mask_ptr = None
    if kv_mask is not None:
        _check_cuda("kv_mask", kv_mask, (b, lk), dtype=torch.float32)
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty_like(q)
    fn = _c_entry("token_attention", "token_attention_bf16", 5, 4)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        b, lq, lk, heads, float(scale), int(bool(bounded)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "token_attention_bf16")
    launch_counts["fused_token_attention"] += 1
    return out
