"""Wan2.1's causal video VAE (``WanVAE_`` of github.com/Wan-Video/Wan2.1,
``wan/modules/vae.py``): 16 latent channels at a stride of 4 x 8 x 8.

Channels first, [B, C, F, H, W]. Causal 3D convs pad the frame axis with
zeros in front; the channel RMS norm is normalize x sqrt(C) x gamma; the
residual blocks are RMS, SiLU, conv, RMS, SiLU, conv with a 1x1x1
shortcut; a single-head spatial attention block sits in the middle; the
down- and upsamplers have their time convs. The encoder takes the video in
chunks of 1, 4, 4, ... frames and the decoder one latent frame at a time,
each causal conv carrying the last two frames of its input from one chunk
to the next (:class:`_Chunks`), as the published model does.

Parameters are the published state dict as a nested tree with its shapes
(``encoder.downsamples.3.residual.2.weight`` at
``["encoder"]["downsamples"][3]["residual"]["2"]["weight"]``). The latents
are the posterior mean normalised by the config's per-channel
``latents_mean`` and ``latents_std`` ((mu - mean) / std; decode takes z std
+ mean), as the published ``WanVAE`` does with its statistics
(:data:`PUBLISHED_LATENTS_MEAN`, :data:`PUBLISHED_LATENTS_STD`); without
them (the default, for weights other than the published ones) the mean as
it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import linear
from avatar_tpu_torch.ops.attention import scaled_dot_product_attention
from avatar_tpu_torch.ops.causal_conv3d import conv3d_same
from avatar_tpu_torch.ops.normalization import rms_norm
from avatar_tpu_torch.utils.profiling import annotate, annotated

CACHE_T = 2  # frames a causal conv carries to the next chunk

# The published VAE's per-channel latent statistics: the constants ``mean``
# and ``std`` of ``WanVAE.__init__`` in wan/modules/vae.py
# (github.com/Wan-Video/Wan2.1), for its checkpoint Wan2.1_VAE.pth.
PUBLISHED_LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
PUBLISHED_LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


@dataclass(frozen=True)
class WanVAEConfig:
    """Static config; defaults = the published Wan2.1 VAE."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    # per-channel latent statistics (z_dim each), or None for none
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if (self.latents_mean is None) != (self.latents_std is None):
            raise ValueError("latents_mean and latents_std come together")
        for stats in (self.latents_mean, self.latents_std):
            if stats is not None and len(stats) != self.z_dim:
                raise ValueError(f"{len(stats)} latent statistics for z_dim {self.z_dim}")

    @property
    def temporal_stride(self) -> int:
        return 2 ** sum(self.temperal_downsample)

    @property
    def spatial_stride(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @classmethod
    def from_dict(cls, config: dict) -> "WanVAEConfig":
        def stats(key):
            return tuple(config[key]) if config.get(key) is not None else None

        return cls(dim=config["dim"], z_dim=config["z_dim"],
                   dim_mult=tuple(config["dim_mult"]),
                   num_res_blocks=config["num_res_blocks"],
                   temperal_downsample=tuple(config["temperal_downsample"]),
                   latents_mean=stats("latents_mean"), latents_std=stats("latents_std"))

    def published_stats(self) -> "WanVAEConfig":
        """This config with the published VAE's latent statistics where it
        has none (16 latent channels)."""
        if self.latents_mean is not None:
            return self
        return replace(self, latents_mean=PUBLISHED_LATENTS_MEAN,
                       latents_std=PUBLISHED_LATENTS_STD)


def _stats(cfg: WanVAEConfig, like: torch.Tensor):
    """(mean, std) [1, z, 1, 1, 1] f32 on ``like``'s device."""
    def t(v):
        return torch.tensor(v, device=like.device, dtype=torch.float32).view(1, -1, 1, 1, 1)

    return t(cfg.latents_mean), t(cfg.latents_std)


# ---------------------------------------------------------------------------
# Layout and init
# ---------------------------------------------------------------------------


def encoder_layout(cfg: WanVAEConfig) -> List[tuple]:
    """The encoder's ``downsamples`` in order: ("res", in, out),
    ("down2d", c) or ("down3d", c)."""
    dims = [cfg.dim * u for u in (1,) + cfg.dim_mult]
    out = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            out.append(("res", cin, cout))
            cin = cout
        if i != len(cfg.dim_mult) - 1:
            out.append(("down3d" if cfg.temperal_downsample[i] else "down2d", cout))
    return out


def decoder_layout(cfg: WanVAEConfig) -> List[tuple]:
    """The decoder's ``upsamples`` in order: ("res", in, out), ("up2d", c)
    or ("up3d", c); each upsampler halves the width that follows it."""
    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + cfg.dim_mult[::-1]]
    up = cfg.temperal_downsample[::-1]
    out = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2
        for _ in range(cfg.num_res_blocks + 1):
            out.append(("res", cin, cout))
            cin = cout
        if i != len(cfg.dim_mult) - 1:
            out.append(("up3d" if up[i] else "up2d", cout))
    return out


def _conv_init(cout, cin, kernel, gen, device, dtype):
    """PyTorch's default conv init: weight and bias uniform
    +-1/sqrt(fan_in)."""
    fan_in = cin * math.prod(kernel)
    bound = fan_in**-0.5
    w = torch.empty((cout, cin, *kernel), device=device, dtype=torch.float32)
    b = torch.empty((cout,), device=device, dtype=torch.float32)
    return {"weight": w.uniform_(-bound, bound, generator=gen).to(dtype),
            "bias": b.uniform_(-bound, bound, generator=gen).to(dtype)}


def init_wan_vae(cfg: WanVAEConfig, seed: int = 0, device="cuda",
                 dtype=torch.bfloat16) -> dict:
    """Seeded random params in the published tree at PyTorch's default conv
    init (the published model's), norms at one; the attention block's
    output conv is drawn like the others where the published init zeroes
    it, so that the block counts."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def conv(cout, cin, kernel):
        return _conv_init(cout, cin, kernel, gen, device, dtype)

    def gamma(c, images=False):
        return {"gamma": torch.ones((c, 1, 1) if images else (c, 1, 1, 1), device=device,
                                    dtype=dtype)}

    def res(cin, cout):
        p = {"residual": {"0": gamma(cin), "2": conv(cout, cin, (3, 3, 3)),
                          "3": gamma(cout), "6": conv(cout, cout, (3, 3, 3))}}
        if cin != cout:
            p["shortcut"] = conv(cout, cin, (1, 1, 1))
        return p

    def attn(c):
        return {"norm": gamma(c, images=True), "to_qkv": conv(3 * c, c, (1, 1)),
                "proj": conv(c, c, (1, 1))}

    def resample(kind, c):
        if kind == "down2d":
            return {"resample": {"1": conv(c, c, (3, 3))}}
        if kind == "down3d":
            return {"resample": {"1": conv(c, c, (3, 3))}, "time_conv": conv(c, c, (3, 1, 1))}
        if kind == "up2d":
            return {"resample": {"1": conv(c // 2, c, (3, 3))}}
        return {"resample": {"1": conv(c // 2, c, (3, 3))}, "time_conv": conv(2 * c, c, (3, 1, 1))}

    def walk(layout):
        return [res(a[1], a[2]) if a[0] == "res" else resample(*a) for a in layout]

    top = cfg.dim * cfg.dim_mult[-1]
    z2 = 2 * cfg.z_dim
    enc = {"conv1": conv(cfg.dim, 3, (3, 3, 3)), "downsamples": walk(encoder_layout(cfg)),
           "middle": [res(top, top), attn(top), res(top, top)],
           "head": {"0": gamma(top), "2": conv(z2, top, (3, 3, 3))}}
    dec_layout = decoder_layout(cfg)
    last = dec_layout[-1][2]
    dec = {"conv1": conv(top, cfg.z_dim, (3, 3, 3)),
           "middle": [res(top, top), attn(top), res(top, top)],
           "upsamples": walk(dec_layout),
           "head": {"0": gamma(last), "2": conv(3, last, (3, 3, 3))}}
    return {"encoder": enc, "conv1": conv(z2, z2, (1, 1, 1)),
            "conv2": conv(cfg.z_dim, cfg.z_dim, (1, 1, 1)), "decoder": dec}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class _Chunks:
    """The causal caches of one encode or decode. Slot i belongs to the
    i-th cached conv of the walk, which is the same for every chunk:
    :meth:`start` rewinds to the first before each chunk."""

    def __init__(self):
        self.slots: List = []
        self.i = 0

    def start(self) -> None:
        self.i = 0

    def take(self) -> int:
        if self.i == len(self.slots):
            self.slots.append(None)
        self.i += 1
        return self.i - 1


def _rms(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The published RMS_norm over the channels, x / |x| sqrt(C) gamma, which
    is x / rms(x) gamma (``F.normalize``'s floor of 1e-12 on |x| as an eps
    of 1e-24 / C)."""
    c = x.shape[1]
    return rms_norm(x, p["gamma"].reshape(c), eps=1e-24 / c, dim=1)


def causal_conv(p: dict, x: torch.Tensor, cache: Optional[_Chunks] = None,
                stride=1) -> torch.Tensor:
    """``CausalConv3d``: zero pad of 2 (kt - 1) / 2 frames in front, SAME
    spatial zeros. With ``cache``, a conv of more than one frame prepends
    the frames its slot kept from the last chunk (and pads the rest) and
    keeps the last two frames of this input."""
    w, b = p["weight"], p.get("bias")
    kt = w.shape[2]
    if kt == 1 or cache is None:
        return conv3d_same(x, w, b, stride=stride, temporal_padding=(kt - 1, 0))
    i = cache.take()
    prev = cache.slots[i]
    keep = x[:, :, -CACHE_T:]
    if keep.shape[2] < CACHE_T and prev is not None:
        keep = torch.cat([prev[:, :, -1:], keep], dim=2)
    pad = kt - 1
    if prev is not None:
        x = torch.cat([prev, x], dim=2)
        pad -= prev.shape[2]
    cache.slots[i] = keep.clone()
    return conv3d_same(x, w, b, stride=stride, temporal_padding=(pad, 0))


@annotated("conv.cudnn")
def _conv2d_down(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The downsampler's per-frame Conv2d 3x3, stride 2, after a zero pad of
    one column at the right and one row at the bottom."""
    w = p["weight"][:, :, None].to(x.dtype)
    out = F.conv3d(F.pad(x, (0, 1, 0, 1)), w, None, stride=(1, 2, 2))
    return out + p["bias"].to(out.dtype).reshape(1, -1, 1, 1, 1)


def _conv2d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A per-frame Conv2d with SAME zero padding, as a (1, kh, kw) conv."""
    return conv3d_same(x, p["weight"][:, :, None], p.get("bias"))


def residual_block(p: dict, x: torch.Tensor, cache: Optional[_Chunks]) -> torch.Tensor:
    with annotate("vae.block"):
        r = p["residual"]
        h = causal_conv(p["shortcut"], x) if "shortcut" in p else x
        y = causal_conv(r["2"], F.silu(_rms(r["0"], x)), cache)
        y = causal_conv(r["6"], F.silu(_rms(r["3"], y)), cache)
        return y + h


def attention_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Single-head self-attention over each frame's positions."""
    with annotate("vae.block"):
        b, c, t, h, w = x.shape
        xn = _rms(p["norm"], x)
        tokens = xn.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        qkv = linear({"weight": p["to_qkv"]["weight"].reshape(3 * c, c),
                      "bias": p["to_qkv"]["bias"]}, tokens)
        q, k, v = (s[:, None] for s in qkv.chunk(3, dim=-1))
        o = scaled_dot_product_attention(q, k, v, impl="auto")[:, 0]
        o = linear({"weight": p["proj"]["weight"].reshape(c, c), "bias": p["proj"]["bias"]}, o)
        return o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3) + x


def _down(p: dict, kind: str, x: torch.Tensor, cache: _Chunks) -> torch.Tensor:
    """The encoder's Resample: the per-frame strided conv, then (3d) the
    time conv of stride 2 over the last frame kept from the chunk before and
    this chunk's frames; the first chunk passes its frame unchanged."""
    with annotate("vae.block"):
        x = _conv2d_down(p["resample"]["1"], x)
        if kind != "down3d":
            return x
        i = cache.take()
        prev = cache.slots[i]
        cache.slots[i] = x[:, :, -1:].clone()
        if prev is None:
            return x
        return conv3d_same(torch.cat([prev[:, :, -1:], x], dim=2), p["time_conv"]["weight"],
                           p["time_conv"]["bias"], stride=(2, 1, 1))


def _up(p: dict, kind: str, x: torch.Tensor, cache: _Chunks) -> torch.Tensor:
    """The decoder's Resample: (3d) the time conv to twice the channels,
    interleaved into twice the frames (the first chunk skips it), then a
    nearest x2 upsample of each frame and its conv to half the channels."""
    with annotate("vae.block"):
        if kind == "up3d":
            i = cache.take()
            prev = cache.slots[i]
            if prev is None:
                cache.slots[i] = "first"
            else:
                keep = x[:, :, -CACHE_T:]
                if keep.shape[2] < CACHE_T:
                    keep = torch.cat([torch.zeros_like(keep) if isinstance(prev, str)
                                      else prev[:, :, -1:], keep], dim=2)
                tc = p["time_conv"]
                if isinstance(prev, str):
                    y = conv3d_same(x, tc["weight"], tc["bias"], temporal_padding=(2, 0))
                else:
                    y = conv3d_same(torch.cat([prev, x], dim=2), tc["weight"], tc["bias"],
                                    temporal_padding=(2 - prev.shape[2], 0))
                cache.slots[i] = keep.clone()
                b, c2, t, h, w = y.shape
                x = y.reshape(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(
                    b, c2 // 2, 2 * t, h, w)
        x = F.interpolate(x, scale_factor=(1.0, 2.0, 2.0), mode="nearest")
        return _conv2d(p["resample"]["1"], x)


def _middle(p: list, x: torch.Tensor, cache: _Chunks) -> torch.Tensor:
    x = residual_block(p[0], x, cache)
    x = attention_block(p[1], x)
    return residual_block(p[2], x, cache)


def _head(p: dict, x: torch.Tensor, cache: _Chunks) -> torch.Tensor:
    return causal_conv(p["2"], F.silu(_rms(p["0"], x)), cache)


def _encoder_chunk(p: dict, cfg: WanVAEConfig, x: torch.Tensor, cache: _Chunks):
    cache.start()
    x = causal_conv(p["conv1"], x, cache)
    for layer, kind in zip(p["downsamples"], encoder_layout(cfg), strict=True):
        x = residual_block(layer, x, cache) if kind[0] == "res" else _down(layer, kind[0], x,
                                                                           cache)
    return _head(p["head"], _middle(p["middle"], x, cache), cache)


def _decoder_chunk(p: dict, cfg: WanVAEConfig, x: torch.Tensor, cache: _Chunks):
    cache.start()
    x = _middle(p["middle"], causal_conv(p["conv1"], x, cache), cache)
    for layer, kind in zip(p["upsamples"], decoder_layout(cfg), strict=True):
        x = residual_block(layer, x, cache) if kind[0] == "res" else _up(layer, kind[0], x,
                                                                         cache)
    return _head(p["head"], x, cache)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------


def encode(params: dict, cfg: WanVAEConfig, video: torch.Tensor) -> torch.Tensor:
    """Pixels [B, 3, F, H, W] in [-1, 1] (F = 1 + 4k) -> the posterior mean
    [B, z, 1 + k, H/8, W/8], normalised where the config has latent
    statistics, in the input's dtype."""
    with annotate("vae.encode"):
        cache = _Chunks()
        frames = video.shape[2]
        outs = []
        for i in range(1 + (frames - 1) // 4):
            with annotate("vae.chunk"):
                part = video[:, :, :1] if i == 0 else video[:, :, 1 + 4 * (i - 1):1 + 4 * i]
                outs.append(_encoder_chunk(params["encoder"], cfg, part, cache))
        mu = causal_conv(params["conv1"], torch.cat(outs, dim=2))[:, :cfg.z_dim]
        if cfg.latents_mean is None:
            return mu
        mean, std = _stats(cfg, mu)
        return ((mu.float() - mean) / std).to(mu.dtype)


def decode(params: dict, cfg: WanVAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, z, F', h, w] (normalised where the config has latent
    statistics) -> pixels [B, 3, 1 + 4 (F' - 1), 8h, 8w] clamped to [-1, 1],
    one latent frame a chunk."""
    with annotate("vae.decode"):
        if cfg.latents_mean is not None:
            mean, std = _stats(cfg, z)
            z = (z.float() * std + mean).to(z.dtype)
        x = causal_conv(params["conv2"], z)
        cache = _Chunks()
        outs = []
        for i in range(x.shape[2]):
            with annotate("vae.chunk"):
                outs.append(_decoder_chunk(params["decoder"], cfg, x[:, :, i:i + 1], cache))
        return torch.cat(outs, dim=2).clamp_(-1.0, 1.0)
