"""3D rotary positional embeddings (port of ``avatar_tpu/ops/rope.py``).

Frequencies are computed in f32. By default the DiT uses the split-half
layout: q/k projection columns are permuted once at load
(:func:`rope_channel_permutation`), so the rotation is contiguous-slice
math on ``[x1 | x2]``. :func:`apply_rotary_emb` is the reference layout
(interleaved pairs) for unpermuted params.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def precompute_freqs_cis(
    indices_grid: torch.Tensor,
    dim: int,
    theta: float = 10000.0,
    max_pos: Sequence[int] = (20, 2048, 2048),
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [B, N, dim], for a [B, 3, N] (t, y, x) coordinate
    grid ('exp' spacing). ``dim % 6`` leading channels get cos 1, sin 0."""
    fractional = torch.stack(
        [indices_grid[:, i] / max_pos[i] for i in range(3)], dim=-1
    ).float()  # [B, N, 3]
    n_freqs = dim // 6
    exps = torch.linspace(
        math.log(1.0, theta), math.log(theta, theta), n_freqs,
        dtype=torch.float32, device=indices_grid.device,
    )
    indices = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    indices = indices * (math.pi / 2)
    freqs = indices[None, None, None, :] * (fractional[..., None] * 2 - 1)
    # [B, N, 3, F] -> [B, N, F, 3] -> [B, N, 3F]
    freqs = freqs.transpose(-1, -2).reshape(*freqs.shape[:2], -1)
    cos_f = torch.repeat_interleave(torch.cos(freqs), 2, dim=-1)
    sin_f = torch.repeat_interleave(torch.sin(freqs), 2, dim=-1)
    pad = dim % 6
    if pad:
        cos_f = torch.cat([torch.ones_like(cos_f[:, :, :pad]), cos_f], dim=-1)
        sin_f = torch.cat([torch.zeros_like(sin_f[:, :, :pad]), sin_f], dim=-1)
    return cos_f.to(out_dtype), sin_f.to(out_dtype)


def apply_rotary_emb(
    x: torch.Tensor, freqs_cis: Tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """Rotate adjacent feature pairs: x*cos + rot(x)*sin, where rot turns
    each pair (x1, x2) into (-x2, x1). Computed in ``x.dtype``, as the JAX
    package does."""
    cos_f, sin_f = freqs_cis
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos_f + rot * sin_f


def split_freqs(
    freqs_cis: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interleaved [.., dim] (cos, sin) -> split-half [.., dim/2]."""
    cos_f, sin_f = freqs_cis
    return cos_f[..., 0::2].contiguous(), sin_f[..., 1::2].contiguous()


def rope_channel_permutation(dim: int) -> np.ndarray:
    """new[i] = old[2i], new[dim/2 + i] = old[2i + 1]."""
    half = dim // 2
    perm = np.empty((dim,), dtype=np.int64)
    perm[:half] = np.arange(half) * 2
    perm[half:] = np.arange(half) * 2 + 1
    return perm


def apply_rotary_emb_split(
    x: torch.Tensor, freqs_split: Tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """[x1 | x2] -> [x1*cos - x2*sin | x2*cos + x1*sin], computed in f32
    and rounded once to ``x.dtype`` (as the attention kernel does)."""
    cos_s, sin_s = freqs_split[0].float(), freqs_split[1].float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos_s - x2 * sin_s, x2 * cos_s + x1 * sin_s], dim=-1)
    return out.to(x.dtype)


def get_latent_coords(
    latent_num_frames: int,
    latent_height: int,
    latent_width: int,
    batch_size: int,
    device="cuda",
) -> torch.Tensor:
    """(t, y, x) coordinates of each latent token, [B, 3, N] f32."""
    grid = torch.stack(
        torch.meshgrid(
            torch.arange(latent_num_frames, device=device),
            torch.arange(latent_height, device=device),
            torch.arange(latent_width, device=device),
            indexing="ij",
        ),
        dim=0,
    )
    coords = grid.reshape(3, -1)[None].float()
    return coords.expand(batch_size, -1, -1).contiguous()


def latent_to_pixel_coords(
    latent_coords: torch.Tensor, scale_factors: Tuple[int, int, int]
) -> torch.Tensor:
    """Scale [B, 3, N] latent coords to pixel space (the main path's
    ``causal_fix=False``)."""
    scale = torch.tensor(
        scale_factors, dtype=latent_coords.dtype, device=latent_coords.device
    ).reshape(1, 3, 1)
    return latent_coords * scale
