"""Shared layer primitives (port of ``avatar_tpu/models/layers.py``).

Linear params are ``{"weight": [out, in], "bias": [out]?}``; conv params
``{"weight": [out, in, kt, kh, kw], "bias"?}``. Initializers draw at the JAX
package's scales (uniform +-sqrt(3)/sqrt(fan_in) weights, uniform
+-1/sqrt(fan_in) biases) from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _uniform(shape, bound, gen, device, dtype):
    t = torch.empty(shape, device=device, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=gen)
    return t.to(dtype)


def init_linear(in_dim, out_dim, gen, bias=True, device="cuda",
                dtype=torch.float32) -> dict:
    bound = 1.0 / math.sqrt(in_dim)
    p = {"weight": _uniform((out_dim, in_dim), math.sqrt(3) * bound, gen,
                            device, dtype)}
    if bias:
        p["bias"] = _uniform((out_dim,), bound, gen, device, dtype)
    return p


def init_conv3d(in_ch, out_ch, gen, kernel_size=3, bias=True, device="cuda",
                dtype=torch.float32) -> dict:
    bound = 1.0 / math.sqrt(in_ch * kernel_size**3)
    k = kernel_size
    p = {"weight": _uniform((out_ch, in_ch, k, k, k), math.sqrt(3) * bound,
                            gen, device, dtype)}
    if bias:
        p["bias"] = _uniform((out_ch,), bound, gen, device, dtype)
    return p


def init_normal(shape, std, gen, device="cuda", dtype=torch.float32):
    t = torch.empty(shape, device=device, dtype=torch.float32)
    t.normal_(0.0, std, generator=gen)
    return t.to(dtype)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-precision linear over the last axis, in ``x``'s dtype."""
    if "weight" not in params:
        raise NotImplementedError("quantized linear params are not ported yet")
    bias = params.get("bias")
    return F.linear(
        x, params["weight"].to(x.dtype), None if bias is None else bias.to(x.dtype)
    )


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """DDPM sinusoidal embedding of a [N] timestep vector -> [N, dim] f32."""
    if timesteps.ndim != 1:
        raise ValueError("timesteps must be 1-D")
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def init_timestep_embedder(dim, gen, freq_dim=256, device="cuda",
                           dtype=torch.float32) -> dict:
    return {
        "linear_1": init_linear(freq_dim, dim, gen, device=device, dtype=dtype),
        "linear_2": init_linear(dim, dim, gen, device=device, dtype=dtype),
    }


def timestep_embedder(
    params: dict,
    timesteps: torch.Tensor,
    freq_dim: int = 256,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """timestep [N] -> [N, dim]: sinusoidal embedding, linear, silu, linear."""
    emb = sinusoidal_timestep_embedding(timesteps, freq_dim)
    if dtype is not None:
        emb = emb.to(dtype)
    h = F.silu(linear(params["linear_1"], emb))
    return linear(params["linear_2"], h)
