"""Latent upsampler of the multi-scale pipeline (port of
``avatar_tpu/models/latent_upsampler.py``).

conv -> GroupNorm -> SiLU -> N ResBlocks -> conv and pixel shuffle (2x in
space and / or time) -> N ResBlocks -> conv. The public function keeps the
channels-last [B, F, H, W, C] layout; inside, activations are NCDHW for
cuDNN's conv3d. ``dims == 2`` convs are 3-D convs with a 1-frame kernel.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import group_norm
from avatar_tpu_torch.ops.pixel_shuffle import pixel_shuffle_3d


@dataclass(frozen=True)
class LatentUpsamplerConfig:
    in_channels: int = 128
    mid_channels: int = 512
    num_blocks_per_stage: int = 4
    dims: int = 3
    spatial_upsample: bool = True
    temporal_upsample: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "LatentUpsamplerConfig":
        """Reads the reference config; its defaults differ from this
        class's, as in the JAX package."""
        return cls(
            in_channels=d.get("in_channels", 4),
            mid_channels=d.get("mid_channels", 128),
            num_blocks_per_stage=d.get("num_blocks_per_stage", 4),
            dims=d.get("dims", 2),
            spatial_upsample=d.get("spatial_upsample", True),
            temporal_upsample=d.get("temporal_upsample", False),
        )

    def to_dict(self) -> dict:
        return {"_class_name": "LatentUpsampler", **dataclasses.asdict(self)}


def _init_conv(in_ch, out_ch, dims, gen, kw) -> dict:
    kt = 1 if dims == 2 else 3
    bound = 1.0 / math.sqrt(in_ch * kt * 9)
    w = torch.empty((out_ch, in_ch, kt, 3, 3), device=kw["device"], dtype=torch.float32)
    b = torch.empty((out_ch,), device=kw["device"], dtype=torch.float32)
    w.uniform_(-math.sqrt(3) * bound, math.sqrt(3) * bound, generator=gen)
    b.uniform_(-bound, bound, generator=gen)
    return {"weight": w.to(kw["dtype"]), "bias": b.to(kw["dtype"])}


def _init_norm(ch, kw) -> dict:
    return {"scale": torch.ones(ch, **kw), "bias": torch.zeros(ch, **kw)}


def _init_resblock(ch, dims, gen, kw) -> dict:
    return {"conv1": _init_conv(ch, ch, dims, gen, kw), "norm1": _init_norm(ch, kw),
            "conv2": _init_conv(ch, ch, dims, gen, kw), "norm2": _init_norm(ch, kw)}


def init_latent_upsampler(cfg: LatentUpsamplerConfig, seed: int = 0, device="cuda",
                          dtype: torch.dtype = torch.float32) -> dict:
    """Seeded random params at the JAX init's scales, drawn on ``device``.
    The upsampling conv is per frame unless the upsampler is temporal."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    mid, n = cfg.mid_channels, cfg.num_blocks_per_stage
    factor = (8 if cfg.temporal_upsample else 4) if cfg.spatial_upsample else 2
    return {
        "initial_conv": _init_conv(cfg.in_channels, mid, cfg.dims, gen, kw),
        "initial_norm": _init_norm(mid, kw),
        "res_blocks": [_init_resblock(mid, cfg.dims, gen, kw) for _ in range(n)],
        "upsampler_conv": _init_conv(mid, factor * mid,
                                     cfg.dims if cfg.temporal_upsample else 2, gen, kw),
        "post_res_blocks": [_init_resblock(mid, cfg.dims, gen, kw) for _ in range(n)],
        "final_conv": _init_conv(mid, cfg.in_channels, cfg.dims, gen, kw),
    }


def _conv(p, x):
    """A conv with zero 'same' padding on every axis."""
    w = p["weight"].to(x.dtype)
    pad = tuple(k // 2 for k in w.shape[2:])
    return F.conv3d(x, w, p["bias"].to(x.dtype), padding=pad)


def _resblock(p, x):
    h = F.silu(group_norm(p["norm1"], _conv(p["conv1"], x), 32, dim=1))
    h = group_norm(p["norm2"], _conv(p["conv2"], h), 32, dim=1)
    return F.silu(h + x)


def latent_upsampler_apply(params: dict, cfg: LatentUpsamplerConfig,
                           latent: torch.Tensor) -> torch.Tensor:
    """latent [B, F, H, W, C] -> the upsampled latent, channels-last."""
    x = latent.permute(0, 4, 1, 2, 3)
    x = F.silu(group_norm(params["initial_norm"], _conv(params["initial_conv"], x), 32,
                          dim=1))
    for block in params["res_blocks"]:
        x = _resblock(block, x)
    x = _conv(params["upsampler_conv"], x)
    if cfg.spatial_upsample and cfg.temporal_upsample:
        x = pixel_shuffle_3d(x, (2, 2, 2))[:, :, 1:]
    elif cfg.spatial_upsample:
        x = pixel_shuffle_3d(x, (1, 2, 2))
    else:
        x = pixel_shuffle_3d(x, (2, 1, 1))[:, :, 1:]
    for block in params["post_res_blocks"]:
        x = _resblock(block, x)
    return _conv(params["final_conv"], x).permute(0, 2, 3, 4, 1).contiguous()


def import_latent_upsampler_state(state: Dict[str, torch.Tensor],
                                  cfg: LatentUpsamplerConfig, device="cuda",
                                  dtype=None) -> dict:
    """A reference-named state dict -> the port's tree; a 2-D conv weight
    [out, in, kh, kw] becomes [out, in, 1, kh, kw]."""

    def conv(key):
        w = state[f"{key}.weight"]
        if w.ndim == 4:
            w = w[:, :, None]
        return {"weight": w.to(device, dtype), "bias": state[f"{key}.bias"].to(device, dtype)}

    def norm(key):
        return {"scale": state[f"{key}.weight"].to(device, dtype),
                "bias": state[f"{key}.bias"].to(device, dtype)}

    def res(prefix):
        return {"conv1": conv(f"{prefix}.conv1"), "norm1": norm(f"{prefix}.norm1"),
                "conv2": conv(f"{prefix}.conv2"), "norm2": norm(f"{prefix}.norm2")}

    n = cfg.num_blocks_per_stage
    return {
        "initial_conv": conv("initial_conv"),
        "initial_norm": norm("initial_norm"),
        "res_blocks": [res(f"res_blocks.{i}") for i in range(n)],
        "upsampler_conv": conv("upsampler.0"),
        "post_res_blocks": [res(f"post_upsample_res_blocks.{i}") for i in range(n)],
        "final_conv": conv("final_conv"),
    }


def export_latent_upsampler_state(params: dict) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`import_latent_upsampler_state` (3-D weights
    stay 3-D): reference names, CPU tensors."""
    s = {}

    def put(key, p, names=("weight", "bias")):
        for ours, theirs in zip(names, ("weight", "bias")):
            s[f"{key}.{theirs}"] = p[ours]

    def res(prefix, p):
        put(f"{prefix}.conv1", p["conv1"])
        put(f"{prefix}.norm1", p["norm1"], ("scale", "bias"))
        put(f"{prefix}.conv2", p["conv2"])
        put(f"{prefix}.norm2", p["norm2"], ("scale", "bias"))

    put("initial_conv", params["initial_conv"])
    put("initial_norm", params["initial_norm"], ("scale", "bias"))
    for i, p in enumerate(params["res_blocks"]):
        res(f"res_blocks.{i}", p)
    put("upsampler.0", params["upsampler_conv"])
    for i, p in enumerate(params["post_res_blocks"]):
        res(f"post_upsample_res_blocks.{i}", p)
    put("final_conv", params["final_conv"])
    return {k: v.detach().cpu().contiguous() for k, v in s.items()}


def load_latent_upsampler(path: str, device="cuda", dtype=None):
    """(config, params) of a single-file safetensors whose ``config``
    metadata holds the upsampler's config."""
    from avatar_tpu_torch.utils.safetensors_io import load_safetensors

    tensors, metadata = load_safetensors(path)
    cfg = LatentUpsamplerConfig.from_dict(json.loads(metadata["config"]))
    return cfg, import_latent_upsampler_state(tensors, cfg, device, dtype)
