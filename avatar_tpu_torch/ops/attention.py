"""Plain attention (port of ``avatar_tpu/ops/attention.py:xla_attention``).

Used by the plain versions of the attention kernels and by the tests;
nothing on the main path calls it on a card. Inputs are head-major
[B, H, L, D].
"""

from __future__ import annotations

from typing import Optional

import torch


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
