"""Causal video VAE (port of ``avatar_tpu/models/vae.py``).

The public functions (:func:`vae_encode`, :func:`vae_decode`,
:func:`encoder_apply`, :func:`decoder_apply`) keep the JAX package's
channels-last [B, F, H, W, C] layout; inside, activations are NCDHW,
the layout cuDNN's 3D convolutions take.

Block kinds: ``res_x`` (mid block, with timestep conditioning in the
decoder), ``attn_res_x`` (a decoder mid block with a self-attention block
after each resnet when it names ``attention_head_dim``), ``res_x_y``,
``compress_{time,space,all}`` (strided conv in the encoder, depth-to-space
in the decoder) and ``compress_{time,space,all}_res`` (space-to-depth in
the encoder); the JAX package's encoder takes no ``attn_res_x`` and
neither does this one. Norms: pixel, group or layer norm. Decoder blocks
with ``inject_noise`` add per-channel scaled spatial noise after each conv
when the decode is given a generator or the noise itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from avatar_tpu_torch.models.layers import (
    group_norm,
    init_conv3d,
    init_linear,
    init_normal,
    init_timestep_embedder,
    linear,
    timestep_embedder,
)
from avatar_tpu_torch.ops.attention import scaled_dot_product_attention
from avatar_tpu_torch.ops.causal_conv3d import conv3d_params
from avatar_tpu_torch.ops.normalization import layer_norm, pixel_norm, rms_norm
from avatar_tpu_torch.ops.pixel_shuffle import (
    patchify_pixels,
    pixel_shuffle_3d,
    pixel_unshuffle_3d,
    unpatchify_pixels,
)

BlockSpec = Tuple[str, Dict[str, Any]]

_COMPRESS_SPATIAL = ("compress_space", "compress_all", "compress_all_res",
                     "compress_space_res", "compress_all_x_y")
_COMPRESS_TEMPORAL = ("compress_time", "compress_all", "compress_all_res",
                      "compress_time_res", "compress_all_x_y")
_DOWN_STRIDE = {"compress_time": (2, 1, 1), "compress_space": (1, 2, 2),
                "compress_all": (2, 2, 2), "compress_all_x_y": (2, 2, 2)}
_RES_DOWN_STRIDE = {"compress_all_res": (2, 2, 2),
                    "compress_space_res": (1, 2, 2),
                    "compress_time_res": (2, 1, 1)}
_UP_STRIDE = {"compress_all": (2, 2, 2), "compress_space": (1, 2, 2),
              "compress_time": (2, 1, 1)}


def _normalize_blocks(blocks: Sequence) -> Tuple[BlockSpec, ...]:
    out = []
    for name, params in blocks:
        if isinstance(params, int):
            params = {"num_layers": params}
        out.append((name, dict(params)))
    return tuple(out)


@dataclass(frozen=True)
class VAEConfig:
    """Static VAE architecture config."""

    latent_channels: int
    encoder_blocks: Tuple[BlockSpec, ...]
    decoder_blocks: Tuple[BlockSpec, ...]
    in_channels: int = 3
    out_channels: int = 3
    base_channels: int = 128
    decoder_base_channels: Optional[int] = None
    patch_size: int = 4
    norm_layer: str = "pixel_norm"
    norm_num_groups: int = 32
    latent_log_var: str = "uniform"
    use_quant_conv: bool = False
    causal_decoder: bool = False
    timestep_conditioning: bool = False
    spatial_padding_mode: str = "zeros"
    scaling_factor: float = 1.0
    normalize_latent_channels: bool = False

    @classmethod
    def from_dict(cls, config: dict) -> "VAEConfig":
        """Reads the reference config schema."""
        blocks = config.get("blocks")
        return cls(
            latent_channels=config["latent_channels"],
            encoder_blocks=_normalize_blocks(config.get("encoder_blocks", blocks)),
            decoder_blocks=_normalize_blocks(config.get("decoder_blocks", blocks)),
            in_channels=config.get("in_channels", 3),
            out_channels=config.get("out_channels", 3),
            base_channels=config.get("encoder_base_channels", 128),
            decoder_base_channels=config.get("decoder_base_channels"),
            patch_size=config.get("patch_size", 1),
            norm_layer=config.get("norm_layer", "group_norm"),
            latent_log_var=config.get(
                "latent_log_var",
                "per_channel" if config.get("double_z", True) else "none",
            ),
            use_quant_conv=config.get("use_quant_conv", True),
            causal_decoder=config.get("causal_decoder", False),
            timestep_conditioning=config.get("timestep_conditioning", False),
            spatial_padding_mode=config.get("spatial_padding_mode", "zeros"),
            scaling_factor=config.get("scaling_factor", 1.0),
            normalize_latent_channels=config.get("normalize_latent_channels", False),
        )

    def to_dict(self) -> dict:
        """The reference config schema, as the JAX package writes it."""
        return {
            "_class_name": "CausalVideoAutoencoder",
            "dims": 3,
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "latent_channels": self.latent_channels,
            "encoder_blocks": [list(b) for b in self.encoder_blocks],
            "decoder_blocks": [list(b) for b in self.decoder_blocks],
            "scaling_factor": self.scaling_factor,
            "norm_layer": self.norm_layer,
            "patch_size": self.patch_size,
            "latent_log_var": self.latent_log_var,
            "use_quant_conv": self.use_quant_conv,
            "causal_decoder": self.causal_decoder,
            "timestep_conditioning": self.timestep_conditioning,
            "normalize_latent_channels": self.normalize_latent_channels,
        }

    @property
    def spatial_downscale_factor(self) -> int:
        n = sum(1 for name, _ in self.encoder_blocks if name in _COMPRESS_SPATIAL)
        return 2**n * self.patch_size

    @property
    def temporal_downscale_factor(self) -> int:
        n = sum(1 for name, _ in self.encoder_blocks if name in _COMPRESS_TEMPORAL)
        return 2**n


def demo_config(latent_channels: int = 64) -> VAEConfig:
    """Tiny test config with every residual block kind and timestep
    conditioning (the JAX package's ``demo_config``)."""
    return VAEConfig.from_dict({
        "encoder_blocks": [
            ("res_x", {"num_layers": 2}),
            ("compress_space_res", {"multiplier": 2}),
            ("compress_time_res", {"multiplier": 2}),
            ("compress_all_res", {"multiplier": 2}),
            ("compress_all_res", {"multiplier": 2}),
            ("res_x", {"num_layers": 1}),
        ],
        "decoder_blocks": [
            ("res_x", {"num_layers": 2, "inject_noise": False}),
            ("compress_all", {"residual": True, "multiplier": 2}),
            ("compress_all", {"residual": True, "multiplier": 2}),
            ("compress_all", {"residual": True, "multiplier": 2}),
            ("res_x", {"num_layers": 2, "inject_noise": False}),
        ],
        "latent_channels": latent_channels,
        "norm_layer": "pixel_norm",
        "patch_size": 4,
        "latent_log_var": "uniform",
        "use_quant_conv": False,
        "causal_decoder": False,
        "timestep_conditioning": True,
        "spatial_padding_mode": "replicate",
    })


# The shipped 2B LTX-Video VAE.
LTX_VAE_CONFIG = {
    "_class_name": "CausalVideoAutoencoder",
    "dims": 3,
    "in_channels": 3,
    "out_channels": 3,
    "latent_channels": 128,
    "blocks": [
        ["res_x", 4],
        ["compress_all", 1],
        ["res_x_y", 1],
        ["res_x", 3],
        ["compress_all", 1],
        ["res_x_y", 1],
        ["res_x", 3],
        ["compress_all", 1],
        ["res_x", 3],
        ["res_x", 4],
    ],
    "scaling_factor": 1.0,
    "norm_layer": "pixel_norm",
    "patch_size": 4,
    "latent_log_var": "uniform",
    "use_quant_conv": False,
    "causal_decoder": False,
}


# ---------------------------------------------------------------------------
# Channel bookkeeping
# ---------------------------------------------------------------------------


def _encoder_channel_walk(cfg: VAEConfig) -> List[Tuple[str, dict, int, int]]:
    out, ch = [], cfg.base_channels
    for name, p in cfg.encoder_blocks:
        in_ch = ch
        if name in ("res_x_y", "compress_all_x_y", "compress_all_res",
                    "compress_space_res", "compress_time_res"):
            ch = p.get("multiplier", 2) * ch
        out.append((name, p, in_ch, ch))
    return out


def _decoder_initial_channels(cfg: VAEConfig) -> int:
    ch = cfg.decoder_base_channels or cfg.base_channels
    for name, p in reversed(cfg.decoder_blocks):
        if name == "res_x_y":
            ch = ch * p.get("multiplier", 2)
        if name.startswith("compress"):
            ch = ch * p.get("multiplier", 1)
    return ch


def _decoder_channel_walk(cfg: VAEConfig) -> List[Tuple[str, dict, int, int]]:
    out, ch = [], _decoder_initial_channels(cfg)
    for name, p in reversed(cfg.decoder_blocks):
        in_ch = ch
        if name == "res_x_y":
            ch = ch // p.get("multiplier", 2)
        elif name == "compress_all":
            ch = ch // p.get("multiplier", 1)
        out.append((name, p, in_ch, ch))
    return out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_norm(ch, cfg: VAEConfig, kw) -> dict:
    if cfg.norm_layer == "pixel_norm":
        return {}
    return {"scale": torch.ones(ch, **kw), "bias": torch.zeros(ch, **kw)}


def _init_resnet(in_ch, out_ch, cfg, gen, kw, inject_noise=False,
                 timestep_conditioning=False) -> dict:
    p = {
        "norm1": _init_norm(in_ch, cfg, kw),
        "conv1": init_conv3d(in_ch, out_ch, gen, **kw),
        "norm2": _init_norm(out_ch, cfg, kw),
        "conv2": init_conv3d(out_ch, out_ch, gen, **kw),
    }
    if in_ch != out_ch:
        p["conv_shortcut"] = init_linear(in_ch, out_ch, gen, **kw)
        p["norm3"] = {"scale": torch.ones(in_ch, **kw),
                      "bias": torch.zeros(in_ch, **kw)}
    if inject_noise:
        p["per_channel_scale1"] = torch.zeros(out_ch, 1, 1, **kw)
        p["per_channel_scale2"] = torch.zeros(out_ch, 1, 1, **kw)
    if timestep_conditioning:
        p["scale_shift_table"] = init_normal((4, in_ch), in_ch**-0.5, gen, **kw)
    return p


def _init_vae_attention(ch, gen, kw) -> dict:
    p = {name: init_linear(ch, ch, gen, **kw)
         for name in ("to_q", "to_k", "to_v", "to_out")}
    p["q_norm"] = {"scale": torch.ones(ch, **kw)}
    p["k_norm"] = {"scale": torch.ones(ch, **kw)}
    return p


def _init_mid_block(ch, num_layers, cfg, gen, kw, inject_noise=False,
                    timestep_conditioning=False, attention_head_dim=-1) -> dict:
    p = {"res_blocks": [
        _init_resnet(ch, ch, cfg, gen, kw, inject_noise, timestep_conditioning)
        for _ in range(num_layers)
    ]}
    if timestep_conditioning:
        p["time_embedder"] = init_timestep_embedder(ch * 4, gen, **kw)
    if attention_head_dim > 0:
        p["attention_blocks"] = [_init_vae_attention(ch, gen, kw)
                                 for _ in range(num_layers)]
    return p


def _conv_out_channels(cfg: VAEConfig) -> int:
    if cfg.latent_log_var == "per_channel":
        return cfg.latent_channels * 2
    if cfg.latent_log_var in ("uniform", "constant"):
        return cfg.latent_channels + 1
    return cfg.latent_channels


def init_vae(
    cfg: VAEConfig,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Seeded random params at the JAX init's scales, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(device=device, dtype=dtype)

    enc_blocks = []
    for name, p, bin_ch, bout_ch in _encoder_channel_walk(cfg):
        if name == "res_x":
            enc_blocks.append(_init_mid_block(bin_ch, p["num_layers"], cfg, gen, kw))
        elif name == "res_x_y":
            enc_blocks.append(_init_resnet(bin_ch, bout_ch, cfg, gen, kw))
        elif name in _DOWN_STRIDE:
            enc_blocks.append(init_conv3d(bin_ch, bout_ch, gen, **kw))
        elif name in _RES_DOWN_STRIDE:
            stride = _RES_DOWN_STRIDE[name]
            enc_blocks.append({"conv": init_conv3d(
                bin_ch, bout_ch // int(np.prod(stride)), gen, **kw)})
        else:
            raise ValueError(f"unknown encoder block: {name}")
    enc_walk = _encoder_channel_walk(cfg)
    enc_out = enc_walk[-1][3] if enc_walk else cfg.base_channels
    encoder = {
        "conv_in": init_conv3d(cfg.in_channels * cfg.patch_size**2,
                               cfg.base_channels, gen, **kw),
        "blocks": enc_blocks,
        "conv_norm_out": _init_norm(enc_out, cfg, kw),
        "conv_out": init_conv3d(enc_out, _conv_out_channels(cfg), gen, **kw),
    }

    dec_blocks = []
    walk = _decoder_channel_walk(cfg)
    for name, p, bin_ch, bout_ch in walk:
        if name in ("res_x", "attn_res_x"):
            dec_blocks.append(_init_mid_block(
                bin_ch, p["num_layers"], cfg, gen, kw, p.get("inject_noise", False),
                cfg.timestep_conditioning, p.get("attention_head_dim", -1)))
        elif name == "res_x_y":
            dec_blocks.append(_init_resnet(bin_ch, bout_ch, cfg, gen, kw,
                                           p.get("inject_noise", False)))
        elif name in _UP_STRIDE:
            out_ch = int(np.prod(_UP_STRIDE[name])) * bin_ch // p.get("multiplier", 1)
            dec_blocks.append({"conv": init_conv3d(bin_ch, out_ch, gen, **kw)})
        else:
            raise ValueError(f"unknown decoder block: {name}")
    final_ch = walk[-1][3] if walk else _decoder_initial_channels(cfg)
    decoder = {
        "conv_in": init_conv3d(cfg.latent_channels, _decoder_initial_channels(cfg),
                               gen, **kw),
        "blocks": dec_blocks,
        "conv_norm_out": _init_norm(final_ch, cfg, kw),
        "conv_out": init_conv3d(final_ch, cfg.out_channels * cfg.patch_size**2,
                                gen, **kw),
    }
    if cfg.timestep_conditioning:
        decoder["timestep_scale_multiplier"] = torch.tensor(
            1000.0, device=device, dtype=torch.float32)
        decoder["last_time_embedder"] = init_timestep_embedder(final_ch * 2, gen, **kw)
        decoder["last_scale_shift_table"] = init_normal(
            (2, final_ch), final_ch**-0.5, gen, **kw)
    params = {
        "encoder": encoder,
        "decoder": decoder,
        "per_channel_statistics": {
            "std_of_means": torch.ones(cfg.latent_channels, **kw),
            "mean_of_means": torch.zeros(cfg.latent_channels, **kw),
        },
    }
    if cfg.normalize_latent_channels:
        # BatchNorm running statistics of the latent means
        params["latent_norm"] = {
            "running_mean": torch.zeros(cfg.latent_channels, **kw),
            "running_var": torch.ones(cfg.latent_channels, **kw),
        }
    return params


# ---------------------------------------------------------------------------
# Apply (NCDHW inside)
# ---------------------------------------------------------------------------


def _chan(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, C] -> [B, C, 1, 1, 1] in x's dtype."""
    return t.to(x.dtype).reshape(t.shape[0], t.shape[1], 1, 1, 1)


def _apply_norm(params: dict, x: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    if cfg.norm_layer == "pixel_norm":
        return pixel_norm(x, dim=1)
    if cfg.norm_layer == "group_norm":
        return group_norm(params, x, cfg.norm_num_groups, dim=1)
    if cfg.norm_layer == "layer_norm":
        return layer_norm(x, params.get("scale"), params.get("bias"), eps=1e-6, dim=1)
    raise ValueError(cfg.norm_layer)


class _SpatialNoise:
    """The decoder's injected noise: called with the activation h [B, C,
    F, H, W], the next [H, W] draw, taken from ``given`` in the order the
    decoder consumes it (block by block, resnet by resnet, conv1 before
    conv2) or else drawn from ``generator``."""

    def __init__(self, generator: Optional[torch.Generator],
                 given: Optional[Sequence[torch.Tensor]]):
        self.generator = generator
        self.given = None if given is None else iter(given)

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        shape = tuple(h.shape[3:])
        if self.given is None:
            noise = torch.randn(shape, generator=self.generator, device=h.device,
                                dtype=torch.float32)
        else:
            noise = next(self.given, None)
            if noise is None or tuple(noise.shape) != shape:
                raise ValueError(f"spatial noise: expected a {shape} draw, got "
                                 f"{None if noise is None else tuple(noise.shape)}")
        return noise.to(h.device, h.dtype)

    def check_used_up(self):
        if self.given is not None and next(self.given, None) is not None:
            raise ValueError("spatial noise: more draws given than the decoder takes")


def _feed_spatial_noise(h, per_channel_scale, noise):
    """h + noise [H, W] scaled per channel ([C, 1, 1], the torch layout)."""
    return h + noise[None, None, None] * per_channel_scale.to(h.dtype).reshape(
        1, -1, 1, 1, 1)


def _apply_resnet(params, x, cfg, causal, timestep_embed=None, draw=None):
    """ResnetBlock3D: norm, [AdaLN], silu, conv, [noise], norm, [AdaLN],
    silu, conv, [noise], plus a (layer-normed, projected) shortcut."""
    conv_kw = dict(causal=causal, spatial_padding_mode=cfg.spatial_padding_mode)
    h = _apply_norm(params["norm1"], x, cfg)
    ada = None
    if "scale_shift_table" in params and timestep_embed is not None:
        c = params["scale_shift_table"].shape[-1]
        ada = params["scale_shift_table"].to(x.dtype)[None] + timestep_embed.reshape(
            x.shape[0], 4, c)
        shift1, scale1, shift2, scale2 = (ada[:, i] for i in range(4))
        h = h * (1 + _chan(scale1, h)) + _chan(shift1, h)
    h = conv3d_params(params["conv1"], F.silu(h), **conv_kw)
    if "per_channel_scale1" in params and draw is not None:
        h = _feed_spatial_noise(h, params["per_channel_scale1"], draw(h))
    h = _apply_norm(params["norm2"], h, cfg)
    if ada is not None:
        h = h * (1 + _chan(scale2, h)) + _chan(shift2, h)
    h = conv3d_params(params["conv2"], F.silu(h), **conv_kw)
    if "per_channel_scale2" in params and draw is not None:
        h = _feed_spatial_noise(h, params["per_channel_scale2"], draw(h))

    shortcut = x
    if "norm3" in params:
        shortcut = layer_norm(shortcut, params["norm3"]["scale"],
                              params["norm3"]["bias"], eps=1e-6, dim=1)
    if "conv_shortcut" in params:
        w = params["conv_shortcut"]["weight"].to(x.dtype)
        b = params["conv_shortcut"].get("bias")
        shortcut = F.conv3d(shortcut, w[:, :, None, None, None],
                            None if b is None else b.to(x.dtype))
    return shortcut + h


def _apply_vae_attention(params, x):
    """Self-attention over the flattened video tokens with q/k rms-norm,
    ``C // 64`` heads of 64 (one head of C below), and a residual. On the
    card the head-major forward kernels run it where "auto" routes it."""
    b, c = x.shape[:2]
    tokens = x.permute(0, 2, 3, 4, 1).reshape(b, -1, c)
    q = rms_norm(linear(params["to_q"], tokens), params["q_norm"]["scale"], eps=1e-5)
    k = rms_norm(linear(params["to_k"], tokens), params["k_norm"]["scale"], eps=1e-5)
    v = linear(params["to_v"], tokens)
    heads = c // 64 if c % 64 == 0 and c >= 64 else 1

    def split(t):
        return t.reshape(b, -1, heads, c // heads).transpose(1, 2)

    out = scaled_dot_product_attention(split(q), split(k), split(v))
    out = linear(params["to_out"], out.transpose(1, 2).reshape(b, -1, c)) + tokens
    return out.reshape(b, *x.shape[2:], c).permute(0, 4, 1, 2, 3)


def _apply_mid_block(params, x, cfg, causal, timestep=None, draw=None):
    timestep_embed = None
    if "time_embedder" in params and timestep is not None:
        timestep_embed = timestep_embedder(
            params["time_embedder"], timestep.flatten(), dtype=x.dtype)  # [B, 4C]
    attn_blocks = params.get("attention_blocks")
    for i, res in enumerate(params["res_blocks"]):
        x = _apply_resnet(res, x, cfg, causal, timestep_embed, draw)
        if attn_blocks is not None:
            x = _apply_vae_attention(attn_blocks[i], x)
    return x


def _apply_space_to_depth_down(params, x, stride, cfg, causal):
    if stride[0] == 2:
        x = torch.cat([x[:, :, :1], x], dim=2)  # duplicate the first frame
    conv = params["conv"]
    out_ch_conv = conv.get("weight", conv.get("kernel_q8")).shape[0]
    group_size = x.shape[1] // out_ch_conv
    x_in = pixel_unshuffle_3d(x, stride)
    b, c, f, hh, ww = x_in.shape
    x_in = x_in.reshape(b, c // group_size, group_size, f, hh, ww).mean(2)
    h = conv3d_params(params["conv"], x, causal=causal,
                      spatial_padding_mode=cfg.spatial_padding_mode)
    return pixel_unshuffle_3d(h, stride) + x_in


def _apply_depth_to_space_up(params, x, stride, cfg, causal, residual=False,
                             out_channels_reduction_factor=1):
    x_in = None
    if residual:
        x_in = pixel_shuffle_3d(x, stride)
        num_repeat = int(np.prod(stride)) // out_channels_reduction_factor
        x_in = x_in.repeat(1, num_repeat, 1, 1, 1)
        if stride[0] == 2:
            x_in = x_in[:, :, 1:]
    h = conv3d_params(params["conv"], x, causal=causal,
                      spatial_padding_mode=cfg.spatial_padding_mode)
    h = pixel_shuffle_3d(h, stride)
    if stride[0] == 2:
        h = h[:, :, 1:]
    return h if x_in is None else h + x_in


def _encode_ncdhw(params, cfg, x):
    conv_kw = dict(causal=True, spatial_padding_mode=cfg.spatial_padding_mode)
    x = patchify_pixels(x, patch_size_hw=cfg.patch_size, patch_size_t=1)
    x = conv3d_params(params["conv_in"], x, **conv_kw)
    for block, (name, _) in zip(params["blocks"], cfg.encoder_blocks, strict=True):
        if name == "res_x":
            x = _apply_mid_block(block, x, cfg, causal=True)
        elif name == "res_x_y":
            x = _apply_resnet(block, x, cfg, causal=True)
        elif name in _DOWN_STRIDE:
            x = conv3d_params(block, x, stride=_DOWN_STRIDE[name], **conv_kw)
        elif name in _RES_DOWN_STRIDE:
            x = _apply_space_to_depth_down(block, x, _RES_DOWN_STRIDE[name], cfg,
                                           causal=True)
        else:
            raise ValueError(name)
    x = F.silu(_apply_norm(params["conv_norm_out"], x, cfg))
    x = conv3d_params(params["conv_out"], x, **conv_kw)
    if cfg.latent_log_var == "uniform":
        x = torch.cat([x, x[:, -1:].expand(-1, x.shape[1] - 2, -1, -1, -1)], dim=1)
    elif cfg.latent_log_var == "constant":
        x = x[:, :-1]
        x = torch.cat([x, torch.full_like(x, -30.0)], dim=1)
    return x


class _Replay:
    """One decoder block's noise draws under remat: drawn on the block's
    first run and given again, in the same order, when the backward
    recomputes it."""

    def __init__(self, draw):
        self.draw, self.made, self.i = draw, [], 0

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if self.i == len(self.made):
            self.made.append(self.draw(h))
        self.i += 1
        return self.made[self.i - 1]

    def rewind(self) -> None:
        self.i = 0


def _decoder_block(block, name, bparams, x, cfg, scaled_t, draw):
    causal = cfg.causal_decoder
    if name in ("res_x", "attn_res_x"):
        return _apply_mid_block(block, x, cfg, causal, timestep=scaled_t, draw=draw)
    if name == "res_x_y":
        return _apply_resnet(block, x, cfg, causal, draw=draw)
    if name in _UP_STRIDE:
        return _apply_depth_to_space_up(
            block, x, _UP_STRIDE[name], cfg, causal,
            residual=bparams.get("residual", False),
            out_channels_reduction_factor=bparams.get("multiplier", 1),
        )
    raise ValueError(name)


def _decode_ncdhw(params, cfg, x, timestep, draw, remat=False):
    causal = cfg.causal_decoder
    conv_kw = dict(causal=causal, spatial_padding_mode=cfg.spatial_padding_mode)
    x = conv3d_params(params["conv_in"], x, **conv_kw)
    scaled_t = None
    if cfg.timestep_conditioning:
        if timestep is None:
            raise ValueError("timestep required (timestep_conditioning)")
        scaled_t = timestep * params["timestep_scale_multiplier"]
    walk = _decoder_channel_walk(cfg)
    for block, (name, bparams, _, _) in zip(params["blocks"], walk, strict=True):
        if not remat:
            x = _decoder_block(block, name, bparams, x, cfg, scaled_t, draw)
            continue
        replay = None if draw is None else _Replay(draw)

        def run(xx, block=block, name=name, bparams=bparams, replay=replay):
            if replay is not None:
                replay.rewind()
            return _decoder_block(block, name, bparams, xx, cfg, scaled_t, replay)

        x = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
    x = _apply_norm(params["conv_norm_out"], x, cfg)
    if cfg.timestep_conditioning:
        embedded = timestep_embedder(params["last_time_embedder"],
                                     scaled_t.flatten(), dtype=x.dtype)
        c = params["last_scale_shift_table"].shape[-1]
        ada = params["last_scale_shift_table"].to(x.dtype)[None] + embedded.reshape(
            x.shape[0], 2, c)
        x = x * (1 + _chan(ada[:, 1], x)) + _chan(ada[:, 0], x)
    x = conv3d_params(params["conv_out"], F.silu(x), **conv_kw)
    return unpatchify_pixels(x, patch_size_hw=cfg.patch_size, patch_size_t=1)


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def encoder_apply(params: dict, cfg: VAEConfig, sample: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, 3] -> moments [B, F', H', W', 2*latent_channels]."""
    return _to_ndhwc(_encode_ncdhw(params, cfg, _to_ncdhw(sample)))


def decoder_apply(
    params: dict,
    cfg: VAEConfig,
    sample: torch.Tensor,
    timestep: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    spatial_noise: Optional[Sequence[torch.Tensor]] = None,
    remat: bool = False,
) -> torch.Tensor:
    """[B, F', H', W', latent_channels] -> [B, F, H, W, 3]. Blocks with
    ``inject_noise`` add noise only when ``generator`` or ``spatial_noise``
    (the [H, W] draws in the order the decoder takes them) is given, as
    the JAX decoder does only when given a key. ``remat``: each up block
    under ``torch.utils.checkpoint`` (its input kept, the block recomputed
    in the backward with the same noise), as the JAX decoder wraps each in
    ``jax.checkpoint``."""
    if generator is None and spatial_noise is None:
        return _to_ndhwc(_decode_ncdhw(params, cfg, _to_ncdhw(sample), timestep, None,
                                       remat))
    draw = _SpatialNoise(generator, spatial_noise)
    out = _decode_ncdhw(params, cfg, _to_ncdhw(sample), timestep, draw, remat)
    draw.check_used_up()
    return _to_ndhwc(out)


def posterior_mode(moments: torch.Tensor) -> torch.Tensor:
    return moments[..., : moments.shape[-1] // 2]


def posterior_sample(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """mean + exp(logvar / 2) * noise, with logvar clipped to [-30, 20]."""
    c = moments.shape[-1] // 2
    mean = moments[..., :c]
    std = torch.exp(0.5 * torch.clamp(moments[..., c:], -30.0, 20.0))
    return mean + std * noise.to(mean.dtype)


def normalize_latents(latents, params, cfg, per_channel=True):
    stats = params["per_channel_statistics"]
    if per_channel:
        return (latents - stats["mean_of_means"].to(latents.dtype)) / stats[
            "std_of_means"].to(latents.dtype)
    return latents * cfg.scaling_factor


def un_normalize_latents(latents, params, cfg, per_channel=True):
    stats = params["per_channel_statistics"]
    if per_channel:
        return latents * stats["std_of_means"].to(latents.dtype) + stats[
            "mean_of_means"].to(latents.dtype)
    return latents / cfg.scaling_factor


def vae_encode(
    params: dict,
    cfg: VAEConfig,
    media: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    sample_posterior: bool = True,
    per_channel_normalize: bool = False,
) -> torch.Tensor:
    """media [B, F, H, W, 3] -> normalized latents [B, F', H', W', C].

    A sampled posterior draws its noise from ``generator`` unless ``noise``
    ([B, F', H', W', C]) is given. With ``normalize_latent_channels`` (and
    its running statistics) the mean half of the moments is batch-normed
    first."""
    moments = encoder_apply(params["encoder"], cfg, media)
    if cfg.normalize_latent_channels and "latent_norm" in params:
        c = moments.shape[-1] // 2
        ln = params["latent_norm"]
        mean_half = (moments[..., :c] - ln["running_mean"].to(moments.dtype)) * (
            ln["running_var"].to(moments.dtype) + 1e-5) ** -0.5
        moments = torch.cat([mean_half, moments[..., c:]], dim=-1)
    if sample_posterior:
        if noise is None:
            shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
            noise = torch.randn(shape, generator=generator, device=moments.device,
                                dtype=torch.float32)
        latents = posterior_sample(moments, noise)
    else:
        latents = posterior_mode(moments)
    return normalize_latents(latents, params, cfg, per_channel_normalize)


def vae_decode(
    params: dict,
    cfg: VAEConfig,
    latents: torch.Tensor,
    timestep: Optional[torch.Tensor] = None,
    per_channel_normalize: bool = False,
    generator: Optional[torch.Generator] = None,
    spatial_noise: Optional[Sequence[torch.Tensor]] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Normalized latents [B, F', H', W', C] -> pixels [B, F, H, W, 3];
    ``generator``, ``spatial_noise`` and ``remat`` as in
    :func:`decoder_apply`."""
    z = un_normalize_latents(latents, params, cfg, per_channel_normalize)
    if cfg.normalize_latent_channels and "latent_norm" in params:
        ln = params["latent_norm"]
        z = z * torch.sqrt(ln["running_var"].to(z.dtype) + 1e-5) + ln[
            "running_mean"].to(z.dtype)
    return decoder_apply(params["decoder"], cfg, z, timestep=timestep,
                         generator=generator, spatial_noise=spatial_noise, remat=remat)
