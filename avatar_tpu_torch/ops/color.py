"""RGB -> I420 (port of ``avatar_tpu/ops/color.py``).

Coefficients match OpenCV's ``COLOR_RGB2YUV_I420`` (BT.601 studio swing,
chroma offset 128); chroma takes the top-left sample of each 2x2 block, as
cv2 does.
"""

from __future__ import annotations

import torch


def rgb_to_yuv420(rgb: torch.Tensor) -> torch.Tensor:
    """[..., F, H, W, 3] float (0..1) or uint8 RGB -> [..., F, H*3//2, W]
    uint8 I420 planes (Y, then U and V each reflowed to W-wide rows)."""
    if rgb.dtype == torch.uint8:
        rgbf = rgb.float()
    else:
        rgbf = rgb.float() * 255.0
    *lead, h, w, _ = rgbf.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even height and width, got {h}x{w}")
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    y = 0.256788 * r + 0.504129 * g + 0.097906 * b + 16.0
    u = -0.148223 * r - 0.290993 * g + 0.439216 * b + 128.0
    v = 0.439216 * r - 0.367788 * g - 0.071427 * b + 128.0
    u_rows = u[..., 0::2, 0::2].reshape(*lead, h // 4, w)
    v_rows = v[..., 0::2, 0::2].reshape(*lead, h // 4, w)
    planes = torch.cat([y, u_rows, v_rows], dim=-2)
    return torch.clamp(planes + 0.5, 0.0, 255.0).to(torch.uint8)
