"""Token-space patchifier (port of ``avatar_tpu/models/patchifier.py``):
channels-last latents [B, F, H, W, C] <-> tokens [B, N, C*p*p] plus the
per-token (t, y, x) grid used for RoPE."""

from __future__ import annotations

from typing import Tuple

import torch
from einops import rearrange

from avatar_tpu_torch.ops.rope import get_latent_coords


def patchify(
    latents: torch.Tensor, patch_size: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, F, H, W, C] -> ([B, N, C*p*p], [B, 3, N]) with patch (1, p, p)."""
    b, f, h, w, c = latents.shape
    coords = get_latent_coords(f, h // patch_size, w // patch_size, b,
                               device=latents.device)
    if patch_size == 1:
        return latents.reshape(b, f * h * w, c), coords
    coords = coords * torch.tensor(
        [1.0, patch_size, patch_size], device=latents.device
    ).reshape(1, 3, 1)
    tokens = rearrange(
        latents, "b (f p1) (h p2) (w p3) c -> b (f h w) (c p1 p2 p3)",
        p1=1, p2=patch_size, p3=patch_size,
    )
    return tokens, coords


def unpatchify(
    tokens: torch.Tensor,
    output_num_frames: int,
    output_height: int,
    output_width: int,
    patch_size: int = 1,
) -> torch.Tensor:
    """Inverse of :func:`patchify`; output sizes are in latent units."""
    b = tokens.shape[0]
    if patch_size == 1:
        return tokens.reshape(b, output_num_frames, output_height, output_width,
                              tokens.shape[-1])
    return rearrange(
        tokens, "b (f h w) (c p1 p2 p3) -> b (f p1) (h p2) (w p3) c",
        f=output_num_frames, h=output_height // patch_size,
        w=output_width // patch_size, p1=1, p2=patch_size, p3=patch_size,
    )
