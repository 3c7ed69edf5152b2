"""W8A8 int8 kernels (port of ``avatar_tpu/ops/int8_matmul.py``).

- :func:`w8a8_matmul` (``csrc/int8_matmul_sm90.cu``: wgmma on s8 operands,
  TMA, persistent; replacing ``_kernel`` and ``_kernel_ksplit``): int8 x
  int8 -> int32 with the dequant epilogue ``(acc * x_s) * w_s (+ bias)`` in
  f32, cast to the output dtype. It takes every shape the wrapper admits;
  the ``mma.sync`` kernel of ``csrc/int8_matmul.cu`` it replaced stays
  only as a comparison, reached through its C entry;
- :func:`quantize_rows_pallas` (``csrc/row_quant.cu``, replacing
  ``_quant_rows_kernel``): per-row int8 quantization in one pass;
- :func:`fused_rms_mod_quant` (replacing ``_rms_mod_quant_kernel``):
  rms-norm, AdaLN modulate and the row quantization in one pass; bf16 rows
  whose width is a multiple of 8 (the DiT's) take the register kernel
  (``rms_mod_quant_sm90``: a warp a row up to 2,048 values, cvec and shift
  staged once per CTA, no barrier a row), every other width and f32 the
  row-block kernel (``rms_mod_quant``), by :func:`rms_mod_quant_impl`;
- :func:`fused_act_quant` (replacing ``_act_quant_kernel``): the FF
  activation (gelu-tanh, gelu-erf or geglu) and the row quantization; bf16
  rows whose output width is a multiple of 8 (the DiT's) take the
  register-resident kernel (``act_quant_sm90``: 16-byte loads, no
  shared-memory round trip), every other width and f32 the row-block
  kernel (``act_quant``), by :func:`act_quant_impl`.

The row quantization is ``s = max(max|y|, 1e-30) / 127`` and
``q = clip(round(y * (1 / s)), -127, 127)``, rounding half to even; a row
with a NaN or an inf gets scale NaN or inf and level 0 everywhere, as the
reference's does. The weight operand is ``[N, K]`` int8, the port's
``[out, in]`` layout (see ``utils/quantize.py``).

On a CUDA tensor a wrapper checks dtype, shape and alignment, then
launches its kernel or raises; on a CPU tensor it runs the plain PyTorch
version beside it. Each launch adds one to :data:`launch_counts`.

Routing: :data:`W8A8_PALLAS_MIN_TOKENS` is the JAX package's threshold on
the per-sample sequence length above which ``linear`` and the DiT block
take these kernels. It was measured on a TPU and is kept as a routing
rule, so that each path of the port is held against the same path of the
reference; callers read it at call time so that tests can lower it. The
reference takes the kernels only on a TPU backend; the port routes by the
token count alone, on the card and on the CPU (there through the plain
versions).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from avatar_tpu_torch.ops.kernel_build import load
from avatar_tpu_torch.utils.profiling import annotated

W8A8_PALLAS_MIN_TOKENS = 4096
ACTIVATIONS = {"gelu-approximate": 0, "gelu": 1, "geglu": 2}
# shared-memory row of the row-quant kernels: width * 4 bytes
MAX_ROW_WIDTH = 16384

# Launches of each CUDA kernel; a wrapper adds one where it launches.
# w8a8_matmul and w8a8_matmul_sm90 both count the Hopper kernel's launches:
# the first names the function, the second the kernel, as the attention
# kernels' _sm90 counters do; rms_mod_quant and act_quant count every
# launch of J and K, and rms_mod_quant_sm90 / _rowblock and act_quant_sm90
# / _rowblock split them by route.
launch_counts: Dict[str, int] = {
    "w8a8_matmul": 0, "w8a8_matmul_sm90": 0,
    "quantize_rows": 0, "rms_mod_quant": 0,
    "rms_mod_quant_sm90": 0, "rms_mod_quant_rowblock": 0, "act_quant": 0,
    "act_quant_sm90": 0, "act_quant_rowblock": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@dataclass
class PrequantRows:
    """Activation rows already quantized for :func:`w8a8_matmul`:
    ``q`` [M, K] int8, ``s`` [M, 1] f32, and the logical ``shape``
    (..., K) and ``dtype`` of the activation they stand for, which
    ``linear`` uses to shape and type its output."""

    q: torch.Tensor
    s: torch.Tensor
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` by IEEE division on any device. PyTorch on CUDA turns a
    division by a Python scalar into a product with its reciprocal, which
    can land an ulp away and move a rounding tie; a tensor divisor does
    not."""
    return t / torch.full_like(t, 127.0)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization by division, as the reference's plain
    ``quantize_rows``: x [M, K] -> (q int8 [M, K], s f32 [M, 1])."""
    xf = x.float()
    s = torch.clamp_min(div127(xf.abs().amax(dim=-1, keepdim=True)), 1e-30)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _row_quant_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' epilogue over f32 rows y [M, K]."""
    s = div127(torch.clamp_min(y.abs().amax(dim=-1, keepdim=True), 1e-30))
    q = torch.clamp(torch.round(y * (1.0 / s)), -127, 127).to(torch.int8)
    return q, s


def _gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x * 2.0**-0.5))


def _gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _rms_mod_plain(x, cvec, shift, eps):
    """f32 rows of ``rms_norm(x) * cvec (+ shift)``, x [B, N, C]."""
    xf = x.float()
    y = xf * (1.0 / torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps))
    y = y * cvec.float()
    if shift is not None:
        y = y + shift.float()
    return y.reshape(-1, x.shape[-1])


def _act_plain(h, act):
    """f32 rows of the FF activation of h [..., C2]."""
    hf = h.float().reshape(-1, h.shape[-1])
    if act == "geglu":
        width = hf.shape[-1] // 2
        return hf[:, :width] * _gelu_erf(hf[:, width:])
    return _gelu_erf(hf) if act == "gelu" else _gelu_tanh(hf)


def _w8a8_matmul_plain(x_q, x_s, w_q, w_s, bias, out_dtype):
    # int8 products summed in f64 are exact (|acc| < 2^53), so this is the
    # int32 accumulator on any device
    acc = (x_q.double() @ w_q.double().t()).float()
    out = acc * x_s.float() * w_s.float()[None, :]
    if bias is not None:
        out = out + bias.float()[None, :]
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _device(t: torch.Tensor, *inputs: Optional[torch.Tensor]) -> str:
    """``t``'s device type. Raises where ``t`` or one of ``inputs`` requires
    a gradient: the int8 kernels have no VJP (nor do the JAX package's), and
    a tensor cut off from the graph would silently drop one."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (t, *inputs)):
        raise RuntimeError("the int8 kernels have no gradient: an input requires grad")
    return t.device.type


def _check(name: str, t: torch.Tensor, shape, dtypes):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def act_quant_impl(width: int, dtype: torch.dtype) -> str:
    """Which kernel runs K on the card for an output row of ``width``
    (geglu's halved width) in ``dtype``: "sm90" (``act_quant_sm90``,
    registers and 16-byte loads) for bf16 with ``width % 8 == 0``, which
    keeps every row and both of geglu's halves 16-byte aligned; else
    "rowblock" (``act_quant``, the row through shared memory)."""
    return "sm90" if dtype == torch.bfloat16 and width % 8 == 0 else "rowblock"


def rms_mod_quant_impl(width: int, dtype: torch.dtype) -> str:
    """Which kernel runs J on the card for rows of ``width`` in ``dtype``:
    "sm90" (``rms_mod_quant_sm90``, the row in registers, a warp a row up
    to 2,048 values) for bf16 with ``width % 8 == 0``, which keeps every
    row 16-byte aligned; else "rowblock" (``rms_mod_quant``, the row
    through shared memory)."""
    return "sm90" if dtype == torch.bfloat16 and width % 8 == 0 else "rowblock"


def _check_width(width: int):
    if not 0 < width <= MAX_ROW_WIDTH:
        raise ValueError(f"row width {width} outside 1..{MAX_ROW_WIDTH}")


def matmul_tile_n(m: int, n: int, sms: int = 132) -> int:
    """Output columns per tile of the Hopper kernel (tiles of 128 rows, one
    persistent CTA per SM of ``sms``): 256, unless tiles of 128 columns
    finish the product in under 90% of the rounds of tile time (a round of
    128-column tiles counts half): they fill the SMs of a short or ragged
    M that leaves the last round of 256-column tiles mostly idle (832 and
    5000 rows of 2048 columns on an H100)."""
    m_tiles = -(-m // 128)

    def rounds(tile_n):
        return -(-m_tiles * -(-n // tile_n) // sms) * tile_n / 256

    return 128 if rounds(128) < 0.9 * rounds(256) else 256


_LIBRARIES = {"w8a8_matmul": "int8_matmul", "w8a8_matmul_sm90": "int8_matmul_sm90"}


def _entry(fn_name: str, argtypes):
    fn = getattr(load(_LIBRARIES.get(fn_name, "row_quant")), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launched(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    launch_counts[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_SM_COUNTS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLOATS = (torch.bfloat16, torch.float32)


@annotated("int8.H")
def w8a8_matmul(
    x_q: torch.Tensor,  # [M, K] int8
    x_s: torch.Tensor,  # [M, 1] f32 per-row activation scale
    w_q: torch.Tensor,  # [N, K] int8 ([out, in])
    w_s: torch.Tensor,  # [N] per-output-channel weight scale
    bias: Optional[torch.Tensor] = None,  # [N]
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``((x_q @ w_q^T as int32) * x_s) * w_s (+ bias)`` in f32, cast to
    ``out_dtype`` (bf16 or f32 on the card). The scales and the bias are
    cast to f32 first, as the reference does. The card takes any M, ``K %
    16 == 0`` and even N: TMA reads a row stride of K bytes and zero-fills
    the ragged tiles."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if w_q.shape[1] != k:
        raise ValueError(f"w8a8_matmul: x_q {tuple(x_q.shape)} and w_q {tuple(w_q.shape)}")
    if _device(x_q, x_s, w_s, bias) == "cpu":
        return _w8a8_matmul_plain(x_q, x_s, w_q, w_s, bias, out_dtype)
    if m < 1 or k < 16 or k % 16 or n < 2 or n % 2:
        raise ValueError(f"w8a8_matmul takes K % 16 == 0 and even N; got M={m}, K={k}, N={n}")
    if out_dtype not in _FLOATS:
        raise ValueError(f"w8a8_matmul: out_dtype {out_dtype} is not bf16 or f32")
    w_s = w_s.float().contiguous()
    bias = None if bias is None else bias.float().contiguous()
    _check("x_q", x_q, (m, k), (torch.int8,))
    _check("x_s", x_s, (m, 1), (torch.float32,))
    _check("w_q", w_q, (n, k), (torch.int8,))
    _check("w_s", w_s, (n,), (torch.float32,))
    if bias is not None:
        _check("bias", bias, (n,), (torch.float32,))
    out = torch.empty((m, n), device=x_q.device, dtype=out_dtype)
    fn = _entry("w8a8_matmul_sm90", [_P] * 6 + [_I] * 5 + [_P])
    err = fn(x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
             int(out_dtype == torch.float32), matmul_tile_n(m, n, _sm_count(x_q.device)),
             _stream(x_q))
    _launched(err, "w8a8_matmul")
    launch_counts["w8a8_matmul_sm90"] += 1
    return out


@annotated("int8.I")
def quantize_rows_pallas(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass per-row quantization: x [M, K] (bf16 or f32) ->
    (q int8 [M, K], s f32 [M, 1]), multiplying by the reciprocal scale."""
    if _device(x) == "cpu":
        return _row_quant_plain(x.float())
    m, k = x.shape
    _check_width(k)
    _check("x", x, (m, k), _FLOATS)
    q = torch.empty((m, k), device=x.device, dtype=torch.int8)
    s = torch.empty((m, 1), device=x.device, dtype=torch.float32)
    fn = _entry("quantize_rows", [_P] * 3 + [_I] * 3 + [_P])
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
             int(x.dtype == torch.float32), _stream(x))
    _launched(err, "quantize_rows")
    return q, s


@annotated("int8.J")
def fused_rms_mod_quant(
    x: torch.Tensor,  # [B, N, C]
    cvec: torch.Tensor,  # [B, 1, C] folded norm scale * (1 + ada scale)
    shift: Optional[torch.Tensor],  # [B, 1, C] ada shift, or None
    eps: float = 1e-6,
) -> PrequantRows:
    """rms-norm -> AdaLN modulate -> per-row int8, all in f32 from ``x``:
    ``(x * (1 / sqrt(mean(x^2) + eps))) * cvec (+ shift)``."""
    b, n, c = x.shape
    if _device(x, cvec, shift) == "cpu":
        q, s = _row_quant_plain(_rms_mod_plain(x, cvec, shift, eps))
        return PrequantRows(q, s, tuple(x.shape), x.dtype)
    _check_width(c)
    cvec = cvec.float().reshape(b, c).contiguous()
    _check("x", x, (b, n, c), _FLOATS)
    _check("cvec", cvec, (b, c), (torch.float32,))
    if shift is not None:
        shift = shift.float().reshape(b, c).contiguous()
        _check("shift", shift, (b, c), (torch.float32,))
    q = torch.empty((b * n, c), device=x.device, dtype=torch.int8)
    s = torch.empty((b * n, 1), device=x.device, dtype=torch.float32)
    args = (x.data_ptr(), cvec.data_ptr(), None if shift is None else shift.data_ptr(),
            q.data_ptr(), s.data_ptr(), b, n, c, float(eps))
    impl = rms_mod_quant_impl(c, x.dtype)
    if impl == "sm90":
        fn = _entry("rms_mod_quant_sm90", [_P] * 5 + [_I] * 3 + [_F, _P])
        err = fn(*args, _stream(x))
    else:
        fn = _entry("rms_mod_quant", [_P] * 5 + [_I] * 3 + [_F, _I, _P])
        err = fn(*args, int(x.dtype == torch.float32), _stream(x))
    _launched(err, "rms_mod_quant")
    launch_counts[f"rms_mod_quant_{impl}"] += 1
    return PrequantRows(q, s, tuple(x.shape), x.dtype)


@annotated("int8.K")
def fused_act_quant(h: torch.Tensor, act: str = "gelu-approximate") -> PrequantRows:
    """h [B, N, C2] FF projection -> activation in f32 -> int8 rows:
    "gelu-approximate" (tanh), "gelu" (erf) or "geglu"
    (``h[..., :C2/2] * gelu_erf(h[..., C2/2:])``, half the width)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    b, n, c2 = h.shape
    if act == "geglu" and c2 % 2:
        raise ValueError(f"geglu needs an even width, got {c2}")
    width = c2 // 2 if act == "geglu" else c2
    if _device(h) == "cpu":
        q, s = _row_quant_plain(_act_plain(h, act))
        return PrequantRows(q, s, (b, n, width), h.dtype)
    _check_width(width)
    _check("h", h, (b, n, c2), _FLOATS)
    q = torch.empty((b * n, width), device=h.device, dtype=torch.int8)
    s = torch.empty((b * n, 1), device=h.device, dtype=torch.float32)
    impl = act_quant_impl(width, h.dtype)
    if impl == "sm90":
        fn = _entry("act_quant_sm90", [_P] * 3 + [_I] * 3 + [_P])
        err = fn(h.data_ptr(), q.data_ptr(), s.data_ptr(), b * n, c2, ACTIVATIONS[act],
                 _stream(h))
    else:
        fn = _entry("act_quant", [_P] * 3 + [_I] * 4 + [_P])
        err = fn(h.data_ptr(), q.data_ptr(), s.data_ptr(), b * n, c2, ACTIVATIONS[act],
                 int(h.dtype == torch.float32), _stream(h))
    _launched(err, "act_quant")
    launch_counts[f"act_quant_{impl}"] += 1
    return PrequantRows(q, s, (b, n, width), h.dtype)
