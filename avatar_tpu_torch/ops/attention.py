"""Attention dispatch over head-major [B, H, L, D] tensors (port of
``avatar_tpu/ops/attention.py``).

:func:`xla_attention` is the plain einsum path; :func:`flash_attention
<avatar_tpu_torch.ops.flash_attention.flash_attention>` is the kernel path.
:func:`scaled_dot_product_attention` chooses between them by ``impl``.
"""

from __future__ import annotations

from typing import Optional

import torch

from avatar_tpu_torch.ops.flash_attention import flash_attention, supports
from avatar_tpu_torch.utils.profiling import annotated


def mask_to_bias(mask: torch.Tensor, num_dims: int) -> torch.Tensor:
    """[B, Lkv] keep-mask (1 = keep) -> additive f32 bias with -1e4 on
    masked keys, expanded to ``num_dims`` dims."""
    if mask.dtype == torch.bool:
        bias = torch.where(mask, 0.0, -1e4).float()
    else:
        bias = (1.0 - mask.float()) * -1e4
    while bias.ndim < num_dims:
        bias = bias[:, None]
    return bias


@annotated("attn.sdpa")
def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with f32 logits; probabilities are cast to the
    input dtype before the PV product, which accumulates in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Multi-head attention over [B, H, L, D].

    ``mask``: None, a [B, Lk] keep-mask (1/True = attend) or an additive
    bias broadcastable to [B, H, Lq, Lk]. ``impl``:

    - "xla": :func:`xla_attention` with a -1e4 bias on masked keys;
    - "flash": the kernel path (``flash_attention``) at any shape;
    - "auto": the kernel path where ``supports()`` holds, else "xla".

    On the kernel path a 4-D bias [B, 1, 1, Lk] becomes a keep-mask, a
    dense [B, 1 or H, Lq, Lk] bias that ``dense_bias_supported`` takes runs
    the dense-bias kernels (differentiable in the bias too), and any other
    bias runs :func:`xla_attention`, as the JAX package routes them.

    The JAX package's "auto" takes the kernels only on a TPU backend. The
    port has no such test: "auto" means the same path on either device (on
    a CPU tensor the kernels' plain versions), so results do not depend on
    where the tensors lie. The two paths differ for a row whose keys are
    all masked: "xla" returns ordinary unmasked attention (every key gets
    the same -1e4), the kernels return 0.
    """
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"Unknown attention impl: {impl}")
    bias = None
    if mask is not None:
        bias = mask_to_bias(mask, 4) if mask.ndim == 2 else mask
    if impl == "flash" or (impl == "auto" and supports(q, k, v)):
        return flash_attention(q, k, v, bias=bias, scale=scale,
                               bounded_logits=bounded_logits)
    return xla_attention(q, k, v, bias, scale)
