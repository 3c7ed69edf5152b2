"""Temporally-causal 3D convolution (port of
``avatar_tpu/ops/causal_conv3d.py``) in NCDHW, the layout cuDNN takes.

Causal mode repeats the first frame ``kt - 1`` times in front; non-causal
mode repeats the first and last frames ``(kt - 1) // 2`` times each. The
spatial padding is zeros or replicate. Weights are [out, in, kt, kh, kw].
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOr3 = Union[int, Tuple[int, int, int]]


def _triple(v: IntOr3) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def causal_conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOr3 = 1,
    causal: bool = True,
    spatial_padding_mode: str = "zeros",
) -> torch.Tensor:
    """x: [B, C_in, F, H, W] -> [B, C_out, F', H', W']."""
    kt, kh, kw = weight.shape[2:]
    if kt > 1:
        first = x[:, :, :1]
        if causal:
            x = torch.cat([first] * (kt - 1) + [x], dim=2)
        else:
            half = (kt - 1) // 2
            x = torch.cat([first] * half + [x] + [x[:, :, -1:]] * half, dim=2)
    pad_h, pad_w = kh // 2, kw // 2
    if spatial_padding_mode == "replicate":
        if pad_h or pad_w:
            x = F.pad(x, (pad_w, pad_w, pad_h, pad_h, 0, 0), mode="replicate")
        padding = (0, 0, 0)
    elif spatial_padding_mode in ("zeros", "constant"):
        padding = (0, pad_h, pad_w)
    else:
        raise ValueError(f"Unsupported padding mode: {spatial_padding_mode}")
    return F.conv3d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
        stride=_triple(stride), padding=padding,
    )


def conv3d_params(
    params: dict,
    x: torch.Tensor,
    stride: IntOr3 = 1,
    causal: bool = True,
    spatial_padding_mode: str = "zeros",
) -> torch.Tensor:
    """:func:`causal_conv3d` over a ``{"weight", "bias"?}`` dict."""
    return causal_conv3d(
        x, params["weight"], params.get("bias"), stride=stride,
        causal=causal, spatial_padding_mode=spatial_padding_mode,
    )
