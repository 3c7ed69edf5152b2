"""Temporally-causal 3D convolution (port of
``avatar_tpu/ops/causal_conv3d.py``) in NCDHW, the layout cuDNN takes.

Causal mode repeats the first frame ``kt - 1`` times in front; non-causal
mode repeats the first and last frames ``(kt - 1) // 2`` times each. The
spatial padding is zeros or replicate. Weights are [out, in, kt, kh, kw].

W8A8 convolutions (``{"kernel_q8", "scale", "bias"?}``, made by
``utils/quantize.py:quantize_vae_params``) quantize the activation per
tensor, ``s = max(max|x|, 1e-8) / 127`` and ``q = clip(round(x / s),
-127, 127)`` rounding half to even (a NaN anywhere makes ``s`` NaN, as in
the reference), sum int8 x int8 products in int32, and dequantize in the
reference's order: ``act_s * kernel_s`` first, then ``(f32(acc) * that)``
rounded to the activation's dtype, then ``+ bias`` in that dtype. The
padding acts on the levels: a replicated or zero pad gives the same levels
before or after the quantization. On the card :func:`int8_conv3d` runs
kernel L of ``csrc/int8_conv3d.cu`` (no TPU kernel: the reference runs
XLA's int8 convolution, and PyTorch has no int8 conv3d on CUDA):

- L1 (``int8_conv3d_quant``) writes the levels channels-last, the channels
  padded with zeros to a multiple of 32;
- L2 (``int8_conv3d``) is an implicit GEMM over them (M output positions,
  N output channels, K = kt * kh * kw * padded channels) on ``mma.sync``
  int8 tensor cores, with the padding done by index arithmetic and the
  output written in NCDHW.

A W8A8 conv's ``kernel_q8`` is stored in L2's layout on every device, int8
[out, kt, kh, kw, padded in] (:func:`int8_conv_layout`, applied once when
the tree is quantized or imported). On a CPU tensor the plain version runs
over its [out, in, kt, kh, kw] view (:func:`int8_kernel_view`): the same
levels, an exact float64 convolution of them, and the same epilogue.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from avatar_tpu_torch.ops.int8_matmul import _FLOATS, _I, _P, _check, _device, _stream, div127
from avatar_tpu_torch.ops.kernel_build import load

IntOr3 = Union[int, Tuple[int, int, int]]

# L1 and L2 take the input channels in groups of 32 (zeros past C_in)
CHANNEL_GROUP = 32

# Launches of kernel L's two halves; the wrapper adds one where it launches.
launch_counts: Dict[str, int] = {"int8_conv3d_quant": 0, "int8_conv3d": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _triple(v: IntOr3) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _time_pad(x: torch.Tensor, kt: int, causal: bool) -> torch.Tensor:
    if kt > 1:
        first = x[:, :, :1]
        if causal:
            return torch.cat([first] * (kt - 1) + [x], dim=2)
        half = (kt - 1) // 2
        return torch.cat([first] * half + [x] + [x[:, :, -1:]] * half, dim=2)
    return x


def _replicate(spatial_padding_mode: str) -> bool:
    """True for replicate padding, False for zeros; raises for any other."""
    if spatial_padding_mode not in ("zeros", "constant", "replicate"):
        raise ValueError(f"Unsupported padding mode: {spatial_padding_mode}")
    return spatial_padding_mode == "replicate"


def _spatial_pad(x: torch.Tensor, kh: int, kw: int, spatial_padding_mode: str):
    """(``x``, replicate-padded where asked, and the conv's own padding)."""
    pad_h, pad_w = kh // 2, kw // 2
    if not _replicate(spatial_padding_mode):
        return x, (0, pad_h, pad_w)
    if pad_h or pad_w:
        x = F.pad(x, (pad_w, pad_w, pad_h, pad_h, 0, 0), mode="replicate")
    return x, (0, 0, 0)


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
    x, padding = _spatial_pad(_time_pad(x, kt, causal), kh, kw, spatial_padding_mode)
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
    """:func:`causal_conv3d` over a ``{"weight", "bias"?}`` dict, or
    :func:`int8_conv3d` over a W8A8 one."""
    if "kernel_q8" in params:
        return int8_conv3d(x, params, stride=stride, causal=causal,
                           spatial_padding_mode=spatial_padding_mode)
    return causal_conv3d(
        x, params["weight"], params.get("bias"), stride=stride,
        causal=causal, spatial_padding_mode=spatial_padding_mode,
    )


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale, a 0-d f32 tensor on ``x``'s device:
    ``max(max|x|, 1e-8) / 127`` (NaN if ``x`` holds one)."""
    return div127(torch.clamp_min(x.abs().amax().float(), 1e-8))


def _out_size(x_shape, taps, stride, causal) -> Tuple[int, int, int]:
    """(F', H', W') of a conv with ``taps`` (kt, kh, kw) over ``x_shape``."""
    f, h, w = x_shape[2:]
    kt, kh, kw = taps
    st, sh, sw = _triple(stride)
    f_pad = f + (kt - 1 if causal else 2 * ((kt - 1) // 2))
    return ((f_pad - kt) // st + 1, (h + 2 * (kh // 2) - kh) // sh + 1,
            (w + 2 * (kw // 2) - kw) // sw + 1)


def _dequant(acc: torch.Tensor, s: torch.Tensor, kernel_scale: torch.Tensor,
             bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The reference's epilogue over int32 sums [B, N, F', H', W']."""
    scale = (s * kernel_scale.float())[None, :, None, None, None]
    out = (acc.float() * scale).to(dtype)
    if bias is not None:
        out = out + bias.to(dtype)[None, :, None, None, None]
    return out


def _levels(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """L1's plain version in x's layout, as f32: ``clip(round(x / s), -127,
    127)``, and 0 for a NaN, as the kernel's rounding conversion gives (the
    scale is NaN then, and so is every output)."""
    levels = torch.clamp(torch.round(x.float() / s), -127, 127)
    return torch.where(torch.isnan(levels), 0.0, levels)


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_GROUP) * CHANNEL_GROUP


def int8_conv_layout(kernel: torch.Tensor) -> torch.Tensor:
    """int8 [out, in, kt, kh, kw] -> the stored W8A8 kernel, int8 [out, kt,
    kh, kw, padded in]: L2's weight, taps in (t, h, w) order, channels
    innermost, zeros past ``in``."""
    c = kernel.shape[1]
    w = kernel.permute(0, 2, 3, 4, 1)
    return F.pad(w, (0, padded_channels(c) - c)).contiguous()


def int8_kernel_view(kernel_q8: torch.Tensor, c: int) -> torch.Tensor:
    """The stored W8A8 kernel as [out, c, kt, kh, kw] (a view)."""
    return kernel_q8[..., :c].permute(0, 4, 1, 2, 3)


def _int8_conv3d_plain(x, kernel_q8, kernel_scale, bias, stride, causal,
                       spatial_padding_mode):
    """Kernel L's plain version: the levels convolved exactly in float64
    (|sum| <= 127^2 * K, far below 2^53), then int32 and the epilogue."""
    s = act_scale(x)
    levels = _levels(x, s).double()
    kt, kh, kw = kernel_q8.shape[1:4]
    levels, padding = _spatial_pad(_time_pad(levels, kt, causal), kh, kw,
                                   spatial_padding_mode)
    acc = F.conv3d(levels, int8_kernel_view(kernel_q8, x.shape[1]).double(),
                   stride=_triple(stride), padding=padding)
    return _dequant(acc.to(torch.int32), s, kernel_scale, bias, x.dtype)


def _entry(fn_name: str, argtypes):
    fn = getattr(load("int8_conv3d"), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launched(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    launch_counts[name] += 1


def quantize_levels(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """L1: ``x`` [B, C, F, H, W] (bf16 or f32, CUDA) and its scale ``s``
    (0-d f32) -> levels int8 [B, F, H, W, padded C], zeros past C."""
    b, c = x.shape[:2]
    p = x[0, 0].numel()
    cp = padded_channels(c)
    if x.device.type != "cuda" or x.dtype not in _FLOATS or not x.is_contiguous():
        raise ValueError(f"int8_conv3d: x must be a contiguous bf16 or f32 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    _check("act_scale", s, (), (torch.float32,))
    xq = torch.empty((b, *x.shape[2:], cp), device=x.device, dtype=torch.int8)
    fn = _entry("int8_conv3d_quant", [_P] * 3 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), s.data_ptr(), xq.data_ptr(), b, c, p, cp,
             int(x.dtype == torch.float32), _stream(x))
    _launched(err, "int8_conv3d_quant")
    return xq


def conv_levels(xq: torch.Tensor, s: torch.Tensor, kernel_q8: torch.Tensor,
                kernel_scale: torch.Tensor, bias: Optional[torch.Tensor],
                out_dtype: torch.dtype, stride: IntOr3, causal: bool,
                spatial_padding_mode: str) -> torch.Tensor:
    """L2: the levels of :func:`quantize_levels` convolved with the stored
    W8A8 kernel [out, kt, kh, kw, padded in] -> [B, out, F', H', W'] in
    ``out_dtype``, the epilogue included."""
    b, f, h, w, cp = xq.shape
    n, kt, kh, kw = kernel_q8.shape[:4]
    replicate = _replicate(spatial_padding_mode)
    fo, ho, wo = _out_size((b, cp, f, h, w), (kt, kh, kw), stride, causal)
    if min(fo, ho, wo) < 1 or b * fo * ho * wo >= 2**31:
        raise ValueError(f"int8_conv3d: output {(b, n, fo, ho, wo)} out of range")
    st, sh, sw = _triple(stride)
    kernel_scale = kernel_scale.float().contiguous()
    _check("levels", xq, xq.shape, (torch.int8,))
    _check("kernel_q8", kernel_q8, (n, kt, kh, kw, cp), (torch.int8,))
    _check("scale", kernel_scale, (n,), (torch.float32,))
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
        _check("bias", bias, (n,), (out_dtype,))
    out = torch.empty((b, n, fo, ho, wo), device=xq.device, dtype=out_dtype)
    dims = (b, f, h, w, cp, n, fo, ho, wo, kt, kh, kw, st, sh, sw,
            kt - 1 if causal else (kt - 1) // 2, kh // 2, kw // 2, int(replicate))
    fn = _entry("int8_conv3d", [_P] * 7 + [_I, _P])
    err = fn(xq.data_ptr(), s.data_ptr(), kernel_q8.data_ptr(), kernel_scale.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             (ctypes.c_int * len(dims))(*dims), int(out_dtype == torch.float32),
             _stream(xq))
    _launched(err, "int8_conv3d")
    return out


def int8_conv3d(
    x: torch.Tensor,
    params: dict,
    stride: IntOr3 = 1,
    causal: bool = True,
    spatial_padding_mode: str = "zeros",
) -> torch.Tensor:
    """The W8A8 conv of ``params`` (``{"kernel_q8", "scale", "bias"?}``)
    over x [B, C_in, F, H, W] (bf16 or f32) -> [B, C_out, F', H', W'] in
    x's dtype: L1, then L2 on a CUDA tensor, the plain version on a CPU
    one."""
    kernel_q8, kernel_scale, bias = params["kernel_q8"], params["scale"], params.get("bias")
    if (x.ndim != 5 or kernel_q8.ndim != 5
            or kernel_q8.shape[4] != padded_channels(x.shape[1])):
        raise ValueError(f"int8_conv3d: x {tuple(x.shape)}, kernel {tuple(kernel_q8.shape)}")
    if _device(x) == "cpu":
        return _int8_conv3d_plain(x, kernel_q8, kernel_scale, bias, stride, causal,
                                  spatial_padding_mode)
    x = x.contiguous()
    s = act_scale(x)
    return conv_levels(quantize_levels(x, s), s, kernel_q8, kernel_scale, bias, x.dtype,
                       stride, causal, spatial_padding_mode)
