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
kernel L (no TPU kernel: the reference runs XLA's int8 convolution, and
PyTorch has no int8 conv3d on CUDA):

- the scale is one PyTorch reduction (``aminmax``: x read once);
- L1 (``int8_conv3d_quant``, ``csrc/int8_conv3d_sm90.cu``) writes the
  levels channels-last, the channels padded with zeros to a multiple of 32;
- L2 is an implicit GEMM over them (M output positions, N output channels,
  K = kt * kh * kw * padded channels) with the epilogue, written in NCDHW,
  on the route :func:`conv_plan` names from the shape alone: ``sm90``
  (``int8_conv3d_sm90.cu``: wgmma s8, both operands through TMA, the zero
  pad TMA's zero fill, K split across CTAs where the output tiles are fewer
  than the SMs) for stride 1, zero padding, whole rows of 64-position boxes
  and channels in multiples of 64; ``gather`` (``int8_conv3d.cu``: the
  first design, ``mma.sync`` with A gathered by index arithmetic) for every
  other shape (replicate padding, strides, odd widths).

A W8A8 conv's ``kernel_q8`` is stored in L2's layout on every device, int8
[out, kt, kh, kw, padded in] (:func:`int8_conv_layout`, applied once when
the tree is quantized or imported). On a CPU tensor the plain version runs
over its [out, in, kt, kh, kw] view (:func:`int8_kernel_view`): the same
levels, an exact float64 convolution of them, and the same epilogue.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from avatar_tpu_torch.ops.int8_matmul import _FLOATS, _I, _P, _check, _device, _stream, div127
from avatar_tpu_torch.ops.kernel_build import load
from avatar_tpu_torch.utils.profiling import annotate, annotated

IntOr3 = Union[int, Tuple[int, int, int]]

# L1 and L2 take the input channels in groups of 32 (zeros past C_in)
CHANNEL_GROUP = 32

# Launches of kernel L; the wrapper adds one where it launches: L1, and L2
# by route (int8_conv3d the gather kernel, int8_conv3d_sm90 the wgmma one).
launch_counts: Dict[str, int] = {"int8_conv3d_quant": 0, "int8_conv3d": 0,
                                 "int8_conv3d_sm90": 0}

# conv_plan's constants. The plan is a function of the shape alone, the same
# on every machine: SMS is an H100 SXM's count. A K slice is at least
# MIN_SLICE_STEPS stages. The cost of a plan counts stages of a 128 x 128
# tile with 128 bytes of K: TILE_256 for a stage of a 256-position tile (A
# and B shared by twice the work), ITEM_STAGES for each work item's fill
# and epilogue, and SPLIT_STAGES more where K is split (the partial sums'
# atomics and the workspace's memset). The three were fitted to L2's device
# times under every tile and split of 24 shapes of the 2B VAE on an H100
# (tools/conv_plan_sweep.py): the plans they pick are within 9% of each
# shape's fastest, 1.4% on average.
SMS = 132
MIN_SLICE_STEPS = 3
ITEM_STAGES, SPLIT_STAGES, TILE_256 = 2.0, 20.0, 1.5
TILE_N = 128
BOX = 64  # output positions of one TMA box: whole rows of one frame


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


@annotated("conv.cudnn")
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


@annotated("conv.cudnn")
def conv3d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOr3 = 1,
    spatial_padding_mode: str = "zeros",
    temporal_padding: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """The reference's ``conv3d_same`` (full precision; its W8A8 form is
    :func:`int8_conv3d`): x [B, C_in, F, H, W], weight [out, in, kt, kh,
    kw], spatial SAME padding (zeros, or replicate where the kernel has a
    spatial pad: the reference raises on replicate at kh = kw = 1), an
    explicit (lo, hi) zero pad on the frame axis, cuDNN's conv, then the
    bias in the activation dtype."""
    kh, kw = weight.shape[3:]
    if spatial_padding_mode == "replicate" and not (kh // 2 or kw // 2):
        raise ValueError(f"Unsupported padding mode: {spatial_padding_mode}")
    x, (_, pad_h, pad_w) = _spatial_pad(x, kh, kw, spatial_padding_mode)
    lo, hi = temporal_padding
    if lo != hi:
        x = F.pad(x, (0, 0, 0, 0, lo, hi))
        lo = 0
    out = F.conv3d(x, weight.to(x.dtype), None, stride=_triple(stride),
                   padding=(lo, pad_h, pad_w))
    return add_channel_bias(out, bias)


def add_channel_bias(out: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``out`` [B, C, ...] + a per-channel ``bias`` [C] in out's dtype."""
    if bias is None:
        return out
    return out + bias.to(out.dtype).reshape((-1,) + (1,) * (out.ndim - 2))


@annotated("conv.cudnn")
def linear_nd(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 1x1x1 conv, the reference's ``linear_nd``: x [B, C_in, F, H, W],
    weight [out, in]; the product (f32 accumulation) rounded to x's dtype,
    then the bias in that dtype."""
    return add_channel_bias(F.conv3d(x, weight.to(x.dtype)[:, :, None, None, None]), bias)


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale, a 0-d f32 tensor on ``x``'s device:
    ``max(max|x|, 1e-8) / 127`` (NaN if ``x`` holds one). max|x| is
    max(-min x, max x), exact, from one reduction that reads x once
    (``aminmax`` and ``maximum`` carry a NaN)."""
    lo, hi = torch.aminmax(x)
    return div127(torch.clamp_min(torch.maximum(-lo, hi).float(), 1e-8))


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


def _int8_sums(levels: torch.Tensor, kernel_q8: torch.Tensor, stride: IntOr3,
               causal: bool, spatial_padding_mode: str,
               k_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Exact int32 sums of the levels [B, C, F, H, W] (as floats) with the
    stored W8A8 kernel, over all of K or over its ``k_range`` [k0, k1) (K =
    kt * kh * kw * padded C in L2's order): a float64 conv of the levels with
    the kernel zeroed outside the range (|sum| <= 127^2 * K, far below
    2^53)."""
    kt, kh, kw = kernel_q8.shape[1:4]
    if k_range is not None:
        keep = torch.zeros(kernel_q8[0].numel(), dtype=torch.bool, device=kernel_q8.device)
        keep[k_range[0]:k_range[1]] = True
        kernel_q8 = torch.where(keep.view(kernel_q8.shape[1:]), kernel_q8, 0)
    levels, padding = _spatial_pad(_time_pad(levels.double(), kt, causal), kh, kw,
                                   spatial_padding_mode)
    acc = F.conv3d(levels, int8_kernel_view(kernel_q8, levels.shape[1]).double(),
                   stride=_triple(stride), padding=padding)
    return acc.to(torch.int32)


def _int8_conv3d_plain(x, kernel_q8, kernel_scale, bias, stride, causal,
                       spatial_padding_mode):
    """Kernel L's plain version: the levels' exact sums, then the
    epilogue."""
    with annotate("conv.L1"):
        s = act_scale(x)
        levels = _levels(x, s)
    with annotate("conv.L2"):
        acc = _int8_sums(levels, kernel_q8, stride, causal, spatial_padding_mode)
        return _dequant(acc, s, kernel_scale, bias, x.dtype)


@dataclass(frozen=True)
class ConvPlan:
    """How L2 runs one conv shape: the route (``"sm90"`` or ``"gather"``),
    its output tile (positions x channels), and on ``sm90`` the bytes of K
    a stage takes (one tap's channel chunk, 128 or 64) and the K slices per
    output tile."""

    route: str
    tile_m: int
    tile_n: int
    k: int  # kt * kh * kw * padded C_in
    tiles: int
    chunk: int = 0
    split: int = 1

    @property
    def steps(self) -> int:
        """K stages of one output tile (sm90)."""
        return self.k // self.chunk if self.chunk else 0

    @property
    def items(self) -> int:
        """Work items: output tiles x K slices."""
        return self.tiles * self.split

    def k_ranges(self) -> List[Tuple[int, int]]:
        """Each K slice's [start, end) over K, as the kernel takes them:
        slice j of S is the stages [j T / S, (j + 1) T / S) of the tile's
        T, so it starts and ends on a tap x chunk boundary."""
        if self.route != "sm90":
            return [(0, self.k)]
        t, n = self.steps, self.split
        return [(j * t // n * self.chunk, (j + 1) * t // n * self.chunk) for j in range(n)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan_cost(tiles: int, steps: int, split: int, tile_m: int, chunk: int,
               tile_256: float = TILE_256, item_stages: float = ITEM_STAGES,
               split_stages: float = SPLIT_STAGES) -> float:
    """The time of a plan in stages of a 128 x 128 tile with 128 bytes of
    K: rounds of items over SMS, each round its slice's stages and an
    item's overhead (see the constants, which tools/conv_plan_sweep.py
    fits)."""
    stage = (tile_256 if tile_m == 256 else 1.0) * chunk / 128
    over = tile_m / 128 * (item_stages + (split_stages if split > 1 else 0.0))
    return _cdiv(tiles * split, SMS) * (_cdiv(steps, split) * stage + over)


def sm90_takes(x_shape, taps, stride, causal, spatial_padding_mode) -> bool:
    """Whether the wgmma kernel takes the shape: stride 1, zero padding, the
    input's F, H and W out (odd kh and kw), boxes of 64 positions that are
    whole rows of a frame (W divides 64, 64 / W divides H), and channels
    padded to a multiple of 64 (a stage's 64- or 128-byte rows)."""
    _, c, f, h, w = x_shape
    _, kh, kw = taps
    return (_triple(stride) == (1, 1, 1) and not _replicate(spatial_padding_mode)
            and kh % 2 == 1 and kw % 2 == 1
            and _out_size(x_shape, taps, stride, causal) == (f, h, w)
            and w <= BOX and BOX % w == 0 and h % (BOX // w) == 0
            and padded_channels(c) % 64 == 0)


@functools.lru_cache(maxsize=None)
def conv_plan(x_shape, n: int, taps, stride: IntOr3 = 1, causal: bool = True,
              spatial_padding_mode: str = "zeros",
              dtype: torch.dtype = torch.bfloat16) -> ConvPlan:
    """L2's plan for a conv of the input shape [B, C_in, F, H, W] to ``n``
    channels with ``taps`` (kt, kh, kw), a function of the shape alone (the
    same on every machine): the ``sm90`` route where :func:`sm90_takes`,
    with the tile (256 positions in bf16 only) and K split (slices of at
    least MIN_SLICE_STEPS stages) of least :func:`_plan_cost`, ties to
    fewer slices; the ``gather`` route otherwise. Raises where int32 sums could overflow (127^2 * K >=
    2^31)."""
    b, c = x_shape[:2]
    kt, kh, kw = taps
    k = kt * kh * kw * padded_channels(c)
    if 127 * 127 * k >= 2**31:
        raise ValueError(f"int8_conv3d: K = {k} could overflow int32 sums")
    fo, ho, wo = _out_size(x_shape, taps, stride, causal)
    m = b * fo * ho * wo
    if not sm90_takes(x_shape, taps, stride, causal, spatial_padding_mode):
        return ConvPlan("gather", 128, TILE_N, k, _cdiv(m, 128) * _cdiv(n, TILE_N))
    chunk = 128 if padded_channels(c) % 128 == 0 else 64
    best = None
    for tile_m in ((128, 256) if dtype == torch.bfloat16 else (128,)):
        tiles = _cdiv(m, tile_m) * _cdiv(n, TILE_N)
        for split in range(1, max(1, k // chunk // MIN_SLICE_STEPS) + 1):
            key = (_plan_cost(tiles, k // chunk, split, tile_m, chunk), split, tile_m)
            if best is None or key < best[0]:
                best = (key, ConvPlan("sm90", tile_m, TILE_N, k, tiles, chunk, split))
    return best[1]


def _entry(source: str, fn_name: str, argtypes):
    fn = getattr(load(source), fn_name)
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
    fn = _entry("int8_conv3d_sm90", "int8_conv3d_quant_sm90", [_P] * 3 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), s.data_ptr(), xq.data_ptr(), b, c, p, cp,
             int(x.dtype == torch.float32), _stream(x))
    _launched(err, "int8_conv3d_quant")
    return xq


def _conv_args(xq: torch.Tensor, s: torch.Tensor, kernel_q8: torch.Tensor,
               kernel_scale: torch.Tensor, bias: Optional[torch.Tensor],
               out_dtype: torch.dtype, stride: IntOr3, causal: bool,
               spatial_padding_mode: str):
    """L2's operands checked: (:func:`conv_plan` of the shape, the output
    tensor, the arguments both C entries take first)."""
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
    plan = conv_plan((b, cp, f, h, w), n, (kt, kh, kw), (st, sh, sw), causal,
                     spatial_padding_mode, out_dtype)
    out = torch.empty((b, n, fo, ho, wo), device=xq.device, dtype=out_dtype)
    dims = (b, f, h, w, cp, n, fo, ho, wo, kt, kh, kw, st, sh, sw,
            kt - 1 if causal else (kt - 1) // 2, kh // 2, kw // 2, int(replicate))
    args = (xq.data_ptr(), s.data_ptr(), kernel_q8.data_ptr(), kernel_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            (ctypes.c_int * len(dims))(*dims), int(out_dtype == torch.float32))
    # the tensors the arguments point into stay alive with them
    return plan, out, (args, (kernel_scale, bias))


def gather_entry():
    """L2's gather kernel (``csrc/int8_conv3d.cu``) through its C entry: it
    takes every shape, and the wrapper launches it where :func:`conv_plan`
    names the gather route."""
    return _entry("int8_conv3d", "int8_conv3d", [_P] * 7 + [_I, _P])


def conv_levels(xq: torch.Tensor, s: torch.Tensor, kernel_q8: torch.Tensor,
                kernel_scale: torch.Tensor, bias: Optional[torch.Tensor],
                out_dtype: torch.dtype, stride: IntOr3, causal: bool,
                spatial_padding_mode: str) -> torch.Tensor:
    """L2: the levels of :func:`quantize_levels` convolved with the stored
    W8A8 kernel [out, kt, kh, kw, padded in] -> [B, out, F', H', W'] in
    ``out_dtype``, the epilogue included, on the route of
    :func:`conv_plan`."""
    plan, out, (args, _keep) = _conv_args(xq, s, kernel_q8, kernel_scale, bias, out_dtype,
                                          stride, causal, spatial_padding_mode)
    if plan.route == "sm90":
        # the split's int32 partial sums and per-tile counters, zeroed by the
        # C entry before its launch
        workspace = None if plan.split == 1 else torch.empty(
            plan.tiles * (plan.tile_m * plan.tile_n + 1), device=xq.device,
            dtype=torch.int32)
        fn = _entry("int8_conv3d_sm90", "int8_conv3d_sm90", [_P] * 7 + [_I] * 4 + [_P, _P])
        err = fn(*args, plan.tile_m, plan.chunk, plan.split,
                 None if workspace is None else workspace.data_ptr(), _stream(xq))
        _launched(err, "int8_conv3d_sm90")
    else:
        _launched(gather_entry()(*args, _stream(xq)), "int8_conv3d")
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
    with annotate("conv.L1"):
        x = x.contiguous()
        s = act_scale(x)
        levels = quantize_levels(x, s)
    with annotate("conv.L2"):
        return conv_levels(levels, s, kernel_q8, kernel_scale, bias, x.dtype, stride, causal,
                           spatial_padding_mode)
