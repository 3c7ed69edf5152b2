"""Pixel (un)shuffle and pixel-space patchify (port of
``avatar_tpu/ops/pixel_shuffle.py``) in the port's internal VAE layout,
NCDHW: x is [B, C, F, H, W].

Channel order is c-major, (c p1 p2 p3), exactly as the JAX package's
channels-last version orders its last axis, so the two agree after a
layout transpose.
"""

from __future__ import annotations

from typing import Tuple

import torch
from einops import rearrange


def pixel_shuffle_3d(x: torch.Tensor, factors: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C*p1*p2*p3, F, H, W] -> [B, C, F*p1, H*p2, W*p3]."""
    p1, p2, p3 = factors
    return rearrange(
        x, "b (c p1 p2 p3) f h w -> b c (f p1) (h p2) (w p3)",
        p1=p1, p2=p2, p3=p3,
    )


def pixel_unshuffle_3d(x: torch.Tensor, factors: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, F*p1, H*p2, W*p3] -> [B, C*p1*p2*p3, F, H, W]."""
    p1, p2, p3 = factors
    return rearrange(
        x, "b c (f p1) (h p2) (w p3) -> b (c p1 p2 p3) f h w",
        p1=p1, p2=p2, p3=p3,
    )


def patchify_pixels(
    x: torch.Tensor, patch_size_hw: int, patch_size_t: int = 1
) -> torch.Tensor:
    """VAE input patchify; channel order (c p r q), with the reference's
    swapped (r q)."""
    if patch_size_hw == 1 and patch_size_t == 1:
        return x
    return rearrange(
        x, "b c (f p) (h q) (w r) -> b (c p r q) f h w",
        p=patch_size_t, q=patch_size_hw, r=patch_size_hw,
    )


def unpatchify_pixels(
    x: torch.Tensor, patch_size_hw: int, patch_size_t: int = 1
) -> torch.Tensor:
    """Inverse of :func:`patchify_pixels`."""
    if patch_size_hw == 1 and patch_size_t == 1:
        return x
    return rearrange(
        x, "b (c p r q) f h w -> b c (f p) (h q) (w r)",
        p=patch_size_t, q=patch_size_hw, r=patch_size_hw,
    )
