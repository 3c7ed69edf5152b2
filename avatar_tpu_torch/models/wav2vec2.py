"""Wav2Vec2 audio encoder with FaceFormer's resampling (port of
``avatar_tpu/models/wav2vec2.py``).

The conv feature extractor's 50 Hz output is linearly interpolated to the
video frame rate (30 fps for vocaset, or an explicit frame count) before
the feature projection and the transformer encoder, as FaceFormer's fork
of ``Wav2Vec2Model`` does. The facebook/wav2vec2-base architecture: a
group-norm feature extractor, post-LN encoder layers, a grouped positional
conv with weight norm. Attention is the plain path (``impl="xla"``, as in
the JAX package): no kernel.

Params: linears ``{"weight": [out, in], "bias"}``, convs ``{"weight":
[out, in / groups, K], "bias"?}`` (torch's conv1d layout), norms
``{"scale", "bias"}``. :func:`import_wav2vec2_state` reads a Hugging Face
``Wav2Vec2Model`` state dict (no ``transformers`` needed);
``utils/weight_import.py:wav2vec2_params_from_numpy`` takes the JAX tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import linear
from avatar_tpu_torch.ops.attention import scaled_dot_product_attention
from avatar_tpu_torch.ops.normalization import layer_norm


@dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "Wav2Vec2Config":
        return cls(
            hidden_size=d["hidden_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            intermediate_size=d["intermediate_size"],
            conv_dim=tuple(d["conv_dim"]),
            conv_stride=tuple(d["conv_stride"]),
            conv_kernel=tuple(d["conv_kernel"]),
            conv_bias=d.get("conv_bias", False),
            feat_extract_norm=d.get("feat_extract_norm", "group"),
            num_conv_pos_embeddings=d.get("num_conv_pos_embeddings", 128),
            num_conv_pos_embedding_groups=d.get("num_conv_pos_embedding_groups", 16),
            do_stable_layer_norm=d.get("do_stable_layer_norm", False),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        )


def _conv1d(x: torch.Tensor, weight: torch.Tensor, bias, stride: int, padding: int = 0,
            groups: int = 1) -> torch.Tensor:
    """x [B, T, C_in], weight [C_out, C_in / groups, K] -> [B, T', C_out]."""
    out = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), None, stride, padding,
                   groups=groups).transpose(1, 2)
    return out if bias is None else out + bias.to(out.dtype)


def _group_norm_channels(x: torch.Tensor, scale, bias, num_groups: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """torch GroupNorm over [B, T, C]: statistics per (group of channels,
    all of T)."""
    b, t, c = x.shape
    xf = x.float().reshape(b, t, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xf = (xf - mean) * (var + eps) ** -0.5
    return xf.reshape(b, t, c).to(x.dtype) * scale + bias


def linear_interpolation(features: torch.Tensor, input_fps: float, output_fps: float,
                         output_len: Optional[int] = None) -> torch.Tensor:
    """``F.interpolate(mode="linear", align_corners=True)`` over the time
    axis of [B, T, C]; ``output_len`` defaults to T / input_fps *
    output_fps."""
    b, t, c = features.shape
    if output_len is None:
        output_len = int(t / float(input_fps) * output_fps)
    if output_len == t:
        return features
    if output_len == 1:
        return features[:, :1]
    # the positions bit for bit as XLA computes jnp.linspace(0, t - 1, n) in
    # f32: i * ((t - 1) * (1 / (n - 1))), the last one t - 1
    f32 = torch.float32
    step = torch.tensor(t - 1, dtype=f32) * (torch.tensor(1.0, dtype=f32)
                                             / torch.tensor(output_len - 1, dtype=f32))
    pos = torch.arange(output_len, dtype=f32) * step
    pos[-1] = t - 1
    pos = pos.to(features.device)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    w = (pos - lo)[None, :, None].to(features.dtype)
    return features[:, lo] * (1 - w) + features[:, hi] * w


def feature_extractor(params: dict, cfg: Wav2Vec2Config,
                      input_values: torch.Tensor) -> torch.Tensor:
    """Raw waveform [B, S] -> conv features [B, T, conv_dim[-1]]."""
    x = input_values[..., None]
    for i, s in enumerate(cfg.conv_stride):
        conv = params["conv_layers"][i]
        x = _conv1d(x, conv["weight"], conv.get("bias"), stride=s)
        if cfg.feat_extract_norm == "group" and i == 0:
            x = _group_norm_channels(x, conv["norm_scale"], conv["norm_bias"],
                                     num_groups=cfg.conv_dim[0])
        elif cfg.feat_extract_norm == "layer":
            x = layer_norm(x, conv["norm_scale"], conv["norm_bias"], eps=cfg.layer_norm_eps)
        x = F.gelu(x)
    return x


def _encoder_layer(params: dict, cfg: Wav2Vec2Config, x: torch.Tensor) -> torch.Tensor:
    """A post-LN ``Wav2Vec2EncoderLayer`` (do_stable_layer_norm False)."""
    b, n, _ = x.shape
    heads = cfg.num_attention_heads
    head_dim = cfg.hidden_size // heads
    a = params["attention"]
    q = linear(a["q"], x) * head_dim**-0.5
    k = linear(a["k"], x)
    v = linear(a["v"], x)

    def split(t):
        return t.reshape(b, n, heads, head_dim).transpose(1, 2)

    attn = scaled_dot_product_attention(split(q), split(k), split(v), scale=1.0, impl="xla")
    x = x + linear(a["out"], attn.transpose(1, 2).reshape(b, n, -1))
    x = layer_norm(x, params["layer_norm"]["scale"], params["layer_norm"]["bias"],
                   eps=cfg.layer_norm_eps)
    h = F.gelu(linear(params["ff"]["intermediate"], x))
    x = x + linear(params["ff"]["output"], h)
    return layer_norm(x, params["final_layer_norm"]["scale"],
                      params["final_layer_norm"]["bias"], eps=cfg.layer_norm_eps)


def wav2vec2_encode(
    params: dict,
    cfg: Wav2Vec2Config,
    input_values: torch.Tensor,  # [B, S] raw 16 kHz waveform
    output_len: Optional[int] = None,
    output_fps: float = 30.0,
    input_fps: float = 50.0,
) -> torch.Tensor:
    """FaceFormer's forward: conv features, 50 Hz -> fps (or
    ``output_len`` frames) linear interpolation, projection, encoder.
    [B, S] -> [B, frames, hidden_size]."""
    feats = feature_extractor(params["feature_extractor"], cfg, input_values)
    feats = linear_interpolation(feats, input_fps, output_fps, output_len)

    fp = params["feature_projection"]
    x = layer_norm(feats, fp["layer_norm"]["scale"], fp["layer_norm"]["bias"],
                   eps=cfg.layer_norm_eps)
    x = linear(fp["projection"], x)

    # positional grouped conv, same padding, one position trimmed for an
    # even kernel
    enc = params["encoder"]
    pos = _conv1d(x, enc["pos_conv"]["weight"], enc["pos_conv"].get("bias"), stride=1,
                  padding=cfg.num_conv_pos_embeddings // 2,
                  groups=cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :-1]
    x = x + F.gelu(pos)
    x = layer_norm(x, enc["layer_norm"]["scale"], enc["layer_norm"]["bias"],
                   eps=cfg.layer_norm_eps)
    for layer in enc["layers"]:
        x = _encoder_layer(layer, cfg, x)
    return x


# ---------------------------------------------------------------------------
# Weight import (a Hugging Face Wav2Vec2Model state dict)
# ---------------------------------------------------------------------------


def _as_tensor(v, device, dtype) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.detach().to(device=device, dtype=dtype or t.dtype)


def import_wav2vec2_state(state: Dict[str, object], cfg: Wav2Vec2Config, device="cuda",
                          dtype: Optional[torch.dtype] = None) -> dict:
    """A ``Wav2Vec2Model`` state dict (torch tensors or numpy arrays) ->
    the port's tree on ``device`` (in ``dtype`` where given). The
    positional conv's weight norm (``weight_g`` / ``weight_v``, or the
    newer ``parametrizations.weight.original0`` / ``original1``) is folded
    into one weight: g * v / ||v||, the norm over all but the kernel
    axis."""
    def t(key):
        return _as_tensor(state[key], device, dtype)

    def lin(key):
        p = {"weight": t(f"{key}.weight")}
        if f"{key}.bias" in state:
            p["bias"] = t(f"{key}.bias")
        return p

    def norm(key):
        return {"scale": t(f"{key}.weight"), "bias": t(f"{key}.bias")}

    conv_layers = []
    for i in range(len(cfg.conv_kernel)):
        pre = f"feature_extractor.conv_layers.{i}"
        layer = {"weight": t(f"{pre}.conv.weight")}
        if f"{pre}.conv.bias" in state:
            layer["bias"] = t(f"{pre}.conv.bias")
        if f"{pre}.layer_norm.weight" in state:
            layer["norm_scale"] = t(f"{pre}.layer_norm.weight")
            layer["norm_bias"] = t(f"{pre}.layer_norm.bias")
        conv_layers.append(layer)

    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight_g" in state:
        g, v = t(f"{base}.weight_g"), t(f"{base}.weight_v")
    elif f"{base}.parametrizations.weight.original0" in state:
        g = t(f"{base}.parametrizations.weight.original0")
        v = t(f"{base}.parametrizations.weight.original1")
    else:
        g, v = None, t(f"{base}.weight")
    if g is not None:
        n = torch.linalg.vector_norm(v.float().reshape(-1, v.shape[2]), dim=0)
        v = (g.float() * v.float() / (n[None, None, :] + 1e-12)).to(v.dtype)

    layers = [{
        "attention": {name: lin(f"encoder.layers.{i}.attention.{name}_proj")
                      for name in ("q", "k", "v", "out")},
        "layer_norm": norm(f"encoder.layers.{i}.layer_norm"),
        "ff": {"intermediate": lin(f"encoder.layers.{i}.feed_forward.intermediate_dense"),
               "output": lin(f"encoder.layers.{i}.feed_forward.output_dense")},
        "final_layer_norm": norm(f"encoder.layers.{i}.final_layer_norm"),
    } for i in range(cfg.num_hidden_layers)]

    return {
        "feature_extractor": {"conv_layers": conv_layers},
        "feature_projection": {"layer_norm": norm("feature_projection.layer_norm"),
                               "projection": lin("feature_projection.projection")},
        "encoder": {"pos_conv": {"weight": v, "bias": t(f"{base}.bias")},
                    "layer_norm": norm("encoder.layer_norm"),
                    "layers": layers},
    }

