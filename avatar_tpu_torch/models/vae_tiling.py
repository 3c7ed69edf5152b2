"""Tiled VAE encode and decode (port of ``avatar_tpu/models/vae_tiling.py``).

Large media split into temporal chunks and / or overlapping spatial tiles;
each tile runs through the encoder or decoder, and the overlaps are
blended linearly to hide the seams. Channels-last [B, F, H, W, C] as in
``models/vae.py``'s public functions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from avatar_tpu_torch.models.vae import VAEConfig, decoder_apply, encoder_apply


def blend_t(a: torch.Tensor, b: torch.Tensor, extent: int, axis: int) -> torch.Tensor:
    """Crossfade b's first ``extent`` slices along ``axis`` with a's last
    ones, weights rising linearly from 0 (all a) by 1 / extent."""
    extent = min(a.shape[axis], b.shape[axis], extent)
    if extent == 0:
        return b
    shape = [1] * b.ndim
    shape[axis] = extent
    ramp = (torch.arange(extent, device=b.device, dtype=b.dtype) / extent).reshape(shape)
    a_tail = a.narrow(axis, a.shape[axis] - extent, extent)
    blended = a_tail * (1 - ramp) + b.narrow(axis, 0, extent) * ramp
    return torch.cat([blended, b.narrow(axis, extent, b.shape[axis] - extent)], dim=axis)


def _stitch(rows, blend_extent: int, row_limit: int) -> torch.Tensor:
    """Blend each tile into its upper and left neighbours, keep its first
    ``row_limit`` rows and columns, and concatenate the grid."""
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_t(rows[i - 1][j], tile, blend_extent, axis=2)
            if j > 0:
                tile = blend_t(row[j - 1], tile, blend_extent, axis=3)
            out_row.append(tile[:, :, :row_limit, :row_limit])
        out_rows.append(torch.cat(out_row, dim=3))
    return torch.cat(out_rows, dim=2)


def hw_tiled_encode(
    params: dict,
    cfg: VAEConfig,
    media: torch.Tensor,  # [B, F, H, W, 3]
    tile_sample_size: int = 512,
    overlap_factor: float = 0.25,
) -> torch.Tensor:
    """Overlapping spatial tiles through the encoder, blended: moments
    [B, F', H', W', 2C]."""
    tile_latent = tile_sample_size // cfg.spatial_downscale_factor
    step = int(tile_sample_size * (1 - overlap_factor))
    blend_extent = int(tile_latent * overlap_factor)
    rows = [[encoder_apply(params["encoder"], cfg,
                           media[:, :, i:i + tile_sample_size, j:j + tile_sample_size])
             for j in range(0, media.shape[3], step)]
            for i in range(0, media.shape[2], step)]
    return _stitch(rows, blend_extent, tile_latent - blend_extent)


def hw_tiled_decode(
    params: dict,
    cfg: VAEConfig,
    latents: torch.Tensor,  # [B, F', H', W', C]
    timestep: Optional[torch.Tensor] = None,
    tile_sample_size: int = 512,
    overlap_factor: float = 0.25,
) -> torch.Tensor:
    """Overlapping latent tiles through the decoder, blended."""
    tile_latent = tile_sample_size // cfg.spatial_downscale_factor
    step = int(tile_latent * (1 - overlap_factor))
    blend_extent = int(tile_sample_size * overlap_factor)
    rows = [[decoder_apply(params["decoder"], cfg,
                           latents[:, :, i:i + tile_latent, j:j + tile_latent],
                           timestep=timestep)
             for j in range(0, latents.shape[3], step)]
            for i in range(0, latents.shape[2], step)]
    return _stitch(rows, blend_extent, tile_sample_size - blend_extent)


def z_tiled_encode(
    params: dict,
    cfg: VAEConfig,
    media: torch.Tensor,
    z_sample_size: int = 8,
    use_hw_tiling: bool = False,
    **hw_kwargs,
) -> torch.Tensor:
    """Frame chunks of ``z_sample_size`` (a multiple of 8, or 1) encoded
    one by one and concatenated; a chunk does not see the frames of the
    chunks before it, as in the reference."""
    if not (z_sample_size % 8 == 0 or z_sample_size == 1):
        raise ValueError(f"z_sample_size must be a multiple of 8 or 1, got {z_sample_size}")

    def encode(x):
        if use_hw_tiling:
            return hw_tiled_encode(params, cfg, x, **hw_kwargs)
        return encoder_apply(params["encoder"], cfg, x)

    f = media.shape[1]
    if f <= z_sample_size or z_sample_size <= 1:
        return encode(media)
    sizes = [z_sample_size] * (f // z_sample_size)
    if f - sum(sizes) > 0:
        sizes.append(f - sum(sizes))
    return torch.cat([encode(chunk) for chunk in torch.split(media, sizes, dim=1)], dim=1)


def z_tiled_decode(
    params: dict,
    cfg: VAEConfig,
    latents: torch.Tensor,
    timestep: Optional[torch.Tensor] = None,
    z_sample_size: int = 8,
    use_hw_tiling: bool = False,
    **hw_kwargs,
) -> torch.Tensor:
    """Latent-frame chunks of ``z_sample_size / temporal factor`` decoded
    one by one and concatenated."""

    def decode(z):
        if use_hw_tiling:
            return hw_tiled_decode(params, cfg, z, timestep, **hw_kwargs)
        return decoder_apply(params["decoder"], cfg, z, timestep=timestep)

    f_l = latents.shape[1]
    split_size = max(1, z_sample_size // cfg.temporal_downscale_factor)
    if f_l <= split_size or z_sample_size <= 1:
        return decode(latents)
    num_splits = math.ceil(f_l / split_size)
    return torch.cat([decode(latents[:, i * split_size:(i + 1) * split_size])
                      for i in range(num_splits)], dim=1)
