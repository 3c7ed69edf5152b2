"""Factored (2+1)D convolution (port of ``avatar_tpu/ops/dual_conv3d.py``):
a spatial conv, then a temporal conv, both through
:func:`~avatar_tpu_torch.ops.causal_conv3d.conv3d_same` (cuDNN), as the
legacy ``dims=(2, 1)`` VideoAutoencoder takes them.

x: [B, C_in, F, H, W]; weights
  spatial  [C_mid, C_in, 1, kh, kw]
  temporal [C_out, C_mid, kt, 1, 1]
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avatar_tpu_torch.ops.causal_conv3d import conv3d_same


def dual_conv3d(
    x: torch.Tensor,
    spatial_weight: torch.Tensor,
    temporal_weight: torch.Tensor,
    spatial_bias: Optional[torch.Tensor] = None,
    temporal_bias: Optional[torch.Tensor] = None,
    stride: Tuple[int, int, int] = (1, 1, 1),
    padding_mode: str = "zeros",
) -> torch.Tensor:
    st, sh, sw = stride
    pad_t = temporal_weight.shape[2] // 2
    x = conv3d_same(x, spatial_weight, spatial_bias, stride=(1, sh, sw),
                    spatial_padding_mode=padding_mode)
    return conv3d_same(x, temporal_weight, temporal_bias, stride=(st, 1, 1),
                       spatial_padding_mode=padding_mode,
                       temporal_padding=(pad_t, pad_t))
