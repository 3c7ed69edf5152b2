"""Shared layer primitives (port of ``avatar_tpu/models/layers.py``).

Linear params are ``{"weight": [out, in], "bias": [out]?}``, or quantized
``{"kernel_q" | "kernel_q8": int8 [out, in], "scale": [out], "bias"?}``
(``utils/quantize.py``); conv params
``{"weight": [out, in, kt, kh, kw], "bias"?}``. Initializers draw at the JAX
package's scales (uniform +-sqrt(3)/sqrt(fan_in) weights, uniform
+-1/sqrt(fan_in) biases) from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from avatar_tpu_torch.ops import int8_matmul
from avatar_tpu_torch.utils.profiling import annotate


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


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b^T`` of int8 a [M, K] and b [N, K] through the library
    int8 product. On the card ``torch._int_mm`` wants more than 16 rows, K
    and N multiples of 8, and takes the second operand column-major (``b``
    transposed): zero padding (exact) brings a short or narrow product
    there."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a, b.t())
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp, np_) != (m, k, n):
        a = F.pad(a, (0, kp - k, 0, mp - m))
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), b.contiguous().t())[:m, :n]


def linear(params: dict, x) -> torch.Tensor:
    """Linear over the last axis, in ``x``'s dtype, following the JAX
    package branch by branch:

    - ``x`` a :class:`PrequantRows` (rows quantized by a fused producer):
      straight to the W8A8 kernel :func:`w8a8_matmul`;
    - ``kernel_q8`` (W8A8) with a per-sample sequence ``x.shape[-2]`` of at
      least ``W8A8_PALLAS_MIN_TOKENS``: the row-quant kernel, then
      :func:`w8a8_matmul` (bias added in f32 before the cast);
    - ``kernel_q8`` below it (the reference's XLA branch): row scale from
      ``max|x|`` in x's dtype, quantize by the reciprocal, library int8
      product, dequant, cast, then the bias in x's dtype;
    - ``kernel_q`` (weight-only): dequantize in x's dtype, then a plain
      product;
    - ``weight``: a plain product.
    """
    if isinstance(x, int8_matmul.PrequantRows):
        if "kernel_q8" not in params:
            raise ValueError("prequantized rows need w8a8 params")
        out2d = int8_matmul.w8a8_matmul(x.q, x.s, params["kernel_q8"], params["scale"],
                                        bias=params.get("bias"), out_dtype=x.dtype)
        return out2d.reshape(*x.shape[:-1], out2d.shape[-1])
    bias = params.get("bias")
    if "kernel_q8" in params:
        w_q, k = params["kernel_q8"], x.shape[-1]
        m = x.numel() // k
        seq = x.shape[-2] if x.ndim >= 2 else m
        if seq >= int8_matmul.W8A8_PALLAS_MIN_TOKENS:
            x_q, x_s = int8_matmul.quantize_rows_pallas(x.reshape(m, k).contiguous())
            out2d = int8_matmul.w8a8_matmul(x_q, x_s, w_q, params["scale"], bias=bias,
                                            out_dtype=x.dtype)
            return out2d.reshape(*x.shape[:-1], out2d.shape[-1])
        with annotate("int8.xla"):
            x_s = torch.clamp_min(
                int8_matmul.div127(x.abs().amax(dim=-1, keepdim=True).float()), 1e-30)
            x_q = torch.clamp(torch.round(x.float() * (1.0 / x_s)), -127, 127).to(torch.int8)
            acc = _int8_mm(x_q.reshape(m, k), w_q).reshape(*x.shape[:-1], w_q.shape[0])
            out = (acc.float() * x_s * params["scale"].float()).to(x.dtype)
            return out if bias is None else out + bias.to(out.dtype)
    with annotate("gemm.bf16"):
        if "kernel_q" in params:
            weight = params["kernel_q"].to(x.dtype) * params["scale"].to(x.dtype)[:, None]
        else:
            weight = params["weight"].to(x.dtype)
        return F.linear(x, weight, None if bias is None else bias.to(x.dtype))


def group_norm(params: dict, x: torch.Tensor, num_groups: int, eps: float = 1e-6,
               dim: int = -1) -> torch.Tensor:
    """GroupNorm over channel axis ``dim`` with f32 statistics: group g
    holds channels [g*C/G, (g+1)*C/G), normalized over them and every
    non-batch position; then the optional ``scale`` / ``bias`` of
    ``params``."""
    dim = dim % x.ndim
    xf = x.float().movedim(dim, -1)
    c = xf.shape[-1]
    grouped = xf.reshape(xf.shape[0], -1, num_groups, c // num_groups)
    mean = grouped.mean(dim=(1, 3), keepdim=True)
    var = (grouped - mean).square().mean(dim=(1, 3), keepdim=True)
    out = ((grouped - mean) * (var + eps) ** -0.5).reshape(xf.shape)
    out = out.movedim(-1, dim).to(x.dtype)
    shape = [1] * x.ndim
    shape[dim] = c
    if "scale" in params:
        out = out * params["scale"].to(x.dtype).reshape(shape)
    if "bias" in params:
        out = out + params["bias"].to(x.dtype).reshape(shape)
    return out


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
