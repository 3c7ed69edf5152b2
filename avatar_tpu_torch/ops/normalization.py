"""Normalization primitives (port of ``avatar_tpu/ops/normalization.py``).

Statistics are taken in f32 and the result cast back to the activation
dtype. ``dim`` selects the normalized axis; an affine weight of shape [C]
broadcasts along it.
"""

from __future__ import annotations

from typing import Optional

import torch


def _along(t: torch.Tensor, x: torch.Tensor, dim: int) -> torch.Tensor:
    """View a [C] parameter so it broadcasts along ``dim`` of ``x``."""
    dim = dim % x.ndim
    shape = [1] * x.ndim
    shape[dim] = -1
    return t.to(x.dtype).reshape(shape)


def rms_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    dim: int = -1,
) -> torch.Tensor:
    """RMS norm with f32 statistics (diffusers RMSNorm semantics)."""
    xf = x.float()
    var = (xf * xf).mean(dim, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * _along(weight, out, dim)
    return out


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    dim: int = -1,
) -> torch.Tensor:
    """LayerNorm with f32 statistics over ``dim``."""
    xf = x.float()
    mean = xf.mean(dim, keepdim=True)
    var = (xf - mean).square().mean(dim, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * _along(weight, out, dim)
    if bias is not None:
        out = out + _along(bias, out, dim)
    return out


def pixel_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2 over dim) + eps). The mean is taken in f32; the
    normalizing multiply runs in the activation dtype, as in the JAX
    package."""
    xf = x.float()
    ms = (xf * xf).mean(dim, keepdim=True)
    return x * torch.rsqrt(ms + eps).to(x.dtype)
