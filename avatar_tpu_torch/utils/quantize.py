"""int8 quantization of the DiT's and the T5 encoder's linears and of the
VAE's 3D convolutions (port of ``avatar_tpu/utils/quantize.py``:
``quantize_linear``, ``quantize_dit_params``, ``quantize_t5_params``,
``quantize_conv3d`` and ``quantize_vae_params``). Applied once, when a
pipeline or an encoder is built.

- **"w8"** (weight-only): every linear with at least ``min_size`` weight
  elements becomes ``{"kernel_q": int8 [out, in], "scale": bf16 [out]}``;
  ``models/layers.py:linear`` dequantizes it in the activation dtype.
- **"w8a8"**: only the eight per-token block linears (attn1 q/k/v/out,
  attn2 q/out, FF in/out) become ``{"kernel_q8": int8 [out, in],
  "scale": f32 [out]}``; ``linear`` quantizes the activation rows on the
  fly and runs an int8 x int8 product. The cross-attention k/v, computed
  once per run, and the boundary layers stay full precision.

Weights are stored ``[out, in]`` like the port's ``"weight"``, so both
int8 operands of the product are contiguous along the reduction axis.
Scales are per output channel, ``max|w| / 127`` (1 for a zero channel);
``round(w / scale)`` rounds half to even (``torch.round``, as
``jnp.round``) and is clipped to +-127, with IEEE divisions on any device
(``div127``), so the int8 equals the JAX package's bit for bit from the
same f32 weights.

The VAE's W8A8 convolutions (``quantize_vae_params``): every 5-D conv
weight of at least ``min_size`` elements becomes ``{"kernel_q8": int8
[out, kt, kh, kw, in padded to 32], "scale": f32 [out]}``, scaled per
output channel over every other axis and stored in the layout kernel L
reads (``ops/causal_conv3d.py:int8_conv_layout``);
``ops/causal_conv3d.py`` quantizes the activation per tensor at conv
time. Linears, norms and ``per_channel_statistics``
stay full precision.
"""

from __future__ import annotations

import torch

from avatar_tpu_torch.ops.causal_conv3d import int8_conv_layout
from avatar_tpu_torch.ops.int8_matmul import div127

W8A8_BLOCK_LINEARS = frozenset({
    ("attn1", "to_q"), ("attn1", "to_k"), ("attn1", "to_v"), ("attn1", "to_out"),
    ("attn2", "to_q"), ("attn2", "to_out"),
    ("ff", "proj_in"), ("ff", "proj_out"),
})


def quantize_linear(params: dict, act: bool = False) -> dict:
    """``{"weight": [out, in], "bias"?}`` -> ``{"kernel_q" or "kernel_q8",
    "scale", "bias"?}``; ``act`` picks w8a8 (f32 scale) over w8 (bf16)."""
    w = params["weight"].float()
    scale = div127(w.abs().amax(dim=1))
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    out = {"kernel_q8" if act else "kernel_q": w_q,
           "scale": scale.to(torch.float32 if act else torch.bfloat16)}
    if "bias" in params:
        out["bias"] = params["bias"]
    return out


def _is_linear(node) -> bool:
    return (isinstance(node, dict) and "weight" in node
            and getattr(node["weight"], "ndim", 0) == 2)


def quantize_dit_params(params: dict, min_size: int = 2**18,
                        mode: str = "w8") -> dict:
    """Quantize the DiT tree (list-of-blocks layout, unpermuted): "w8"
    every linear of at least ``min_size`` elements, "w8a8" the eight
    per-token block linears. Unquantized leaves are shared with
    ``params``."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"unknown quantization mode {mode!r}")

    def walk(node):
        if _is_linear(node):
            if node["weight"].numel() >= min_size:
                return quantize_linear(node)
            return node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    if mode == "w8":
        return walk(params)
    blocks = []
    for block in params["blocks"]:
        nb = {}
        for mod_name, mod in block.items():
            if isinstance(mod, dict):
                mod = {name: quantize_linear(lin, act=True)
                       if (mod_name, name) in W8A8_BLOCK_LINEARS and _is_linear(lin)
                       else lin for name, lin in mod.items()}
            nb[mod_name] = mod
        blocks.append(nb)
    return dict(params, blocks=blocks)


def quantize_conv3d(params: dict) -> dict:
    """``{"weight": [out, in, kt, kh, kw], "bias"?}`` -> ``{"kernel_q8"
    (int8 [out, kt, kh, kw, padded in]), "scale" (f32 [out]), "bias"?}``:
    per-output-channel symmetric int8."""
    w = params["weight"].float()
    scale = div127(w.abs().amax(dim=(1, 2, 3, 4)))
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    w_q = torch.clamp(torch.round(w / scale[:, None, None, None, None]), -127, 127)
    out = {"kernel_q8": int8_conv_layout(w_q.to(torch.int8)), "scale": scale}
    if "bias" in params:
        out["bias"] = params["bias"]
    return out


def quantize_vae_params(params: dict, min_size: int = 2**16) -> dict:
    """W8A8-quantize the VAE's 3D convolutions: every conv dict whose 5-D
    weight has at least ``min_size`` elements. Everything else is shared
    with ``params``."""

    def walk(node):
        if isinstance(node, dict) and getattr(node.get("weight"), "ndim", 0) == 5:
            return quantize_conv3d(node) if node["weight"].numel() >= min_size else node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def quantize_t5_params(params: dict, mode: str = "w8") -> dict:
    """int8 T5 encoder (``models/t5.py``): every block linear (attention q,
    k, v, o and the feed-forward) becomes "w8" (weight-only) or "w8a8"
    (int8 activations too; at T5's 256 tokens ``linear`` takes the short
    route, the library int8 product). The embedding, the norms and the
    relative-bias table stay full precision; they are shared with
    ``params``."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    act = mode == "w8a8"
    blocks = [
        dict(block, **{part: {name: quantize_linear(lin, act=act)
                              for name, lin in block[part].items()}
                       for part in ("attn", "ff")})
        for block in params["blocks"]
    ]
    return dict(params, blocks=blocks)
