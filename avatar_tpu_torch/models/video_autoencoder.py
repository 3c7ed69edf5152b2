"""Legacy (non-causal) VideoAutoencoder (port of
``avatar_tpu/models/video_autoencoder.py``), for old checkpoints: the
pre-causal LTX VAE family, a ``block_out_channels`` encoder / decoder with
strided-conv downsampling and nearest upsampling. Nothing in the avatar
flow calls it.

The public functions take and return channels-last tensors, [B, F, H, W,
C], as the port's VAE does; inside, the layout is NCDHW with weights [out,
in, kt, kh, kw] (cuDNN's). Convs are plain zero-padded ones
(:func:`conv3d_same`); ``dims=(2, 1)`` factors each into a spatial and a
temporal conv (:func:`dual_conv3d`), skipping the temporal one where an
image is down- or upsampled, and ``add_channel_padding`` keeps the
reference's front zero channel pad and front truncation around the pixel
patchify.

Params: a conv is ``{"weight", "bias"?}`` or, at ``dims=(2, 1)``,
``{"spatial": {...}, "temporal": {...}}``; ``conv_shortcut``,
``quant_conv`` and ``post_quant_conv`` are linears ``{"weight": [out,
in], "bias"?}``; a norm is ``{"scale", "bias"}`` (group norm) or ``{}``
(pixel norm).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import group_norm, init_conv3d, init_linear
from avatar_tpu_torch.ops.causal_conv3d import add_channel_bias, conv3d_same, linear_nd
from avatar_tpu_torch.ops.dual_conv3d import dual_conv3d
from avatar_tpu_torch.ops.normalization import pixel_norm
from avatar_tpu_torch.ops.pixel_shuffle import patchify_pixels, unpatchify_pixels


@dataclass(frozen=True)
class VideoAutoencoderConfig:
    latent_channels: int
    block_out_channels: Tuple[int, ...]
    in_channels: int = 3
    out_channels: int = 3
    layers_per_block: int = 2
    norm_num_groups: int = 32
    patch_size: int = 1
    patch_size_t: Optional[int] = None
    norm_layer: str = "group_norm"
    latent_log_var: str = "per_channel"
    use_quant_conv: bool = True
    dims: object = 3  # 3 or (2, 1)
    add_channel_padding: bool = False

    @classmethod
    def from_dict(cls, config: dict) -> "VideoAutoencoderConfig":
        if config["_class_name"] != "VideoAutoencoder":
            raise ValueError(f"not a VideoAutoencoder config: {config['_class_name']}")
        dims = config.get("dims", 3)
        if isinstance(dims, list):
            dims = tuple(dims)
        if dims not in (3, (2, 1)):
            raise ValueError(f"dims must be 3 or (2, 1), got {dims}")
        double_z = config.get("double_z", True)
        return cls(
            dims=dims,
            add_channel_padding=config.get("add_channel_padding", False),
            latent_channels=config["latent_channels"],
            block_out_channels=tuple(config["block_out_channels"]),
            in_channels=config.get("in_channels", 3),
            out_channels=config.get("out_channels", 3),
            patch_size=config.get("patch_size", 1),
            patch_size_t=config.get("patch_size_t", config.get("patch_size", 1)),
            norm_layer=config.get("norm_layer", "group_norm"),
            latent_log_var=config.get(
                "latent_log_var", "per_channel" if double_z else "none"),
            use_quant_conv=config.get("use_quant_conv", True),
        )

    @property
    def _pst(self) -> int:
        return self.patch_size_t if self.patch_size_t is not None else self.patch_size

    @property
    def spatial_downscale_factor(self) -> int:
        n = sum(1 for i in range(len(self.block_out_channels))
                if i < len(self.block_out_channels) - 1 and 2**i >= self.patch_size)
        return 2**n * self.patch_size


def _norm(params, x, cfg: VideoAutoencoderConfig):
    if cfg.norm_layer == "pixel_norm":
        return pixel_norm(x, dim=1)
    return group_norm(params, x, cfg.norm_num_groups, dim=1)


def _conv(p, x, stride=(1, 1, 1), skip_time_conv=False):
    """A plain conv or a (2+1)D pair; ``skip_time_conv``: the spatial conv
    alone (the reference's image path)."""
    if "spatial" in p:
        sp, tp = p["spatial"], p["temporal"]
        if skip_time_conv:
            return conv3d_same(x, sp["weight"], sp.get("bias"), stride=(1,) + tuple(stride[1:]))
        return dual_conv3d(x, sp["weight"], tp["weight"], sp.get("bias"), tp.get("bias"),
                           stride=stride)
    kt = p["weight"].shape[2]
    return conv3d_same(x, p["weight"], p.get("bias"), stride=stride,
                       temporal_padding=(kt // 2, kt // 2))


def _linear(p, x):
    return linear_nd(x, p["weight"], p.get("bias"))


def _init_norm(ch, cfg, kw):
    if cfg.norm_layer == "pixel_norm":
        return {}
    return {"scale": torch.ones(ch, **kw), "bias": torch.zeros(ch, **kw)}


def _init_conv(cin, cout, cfg, gen, kw, kernel_size=3):
    """A plain conv, or a (2+1)D pair whose middle width is max(cin, cout)
    (the reference's DualConv3d)."""
    if cfg.dims == 3:
        return init_conv3d(cin, cout, gen, kernel_size, **kw)
    mid = max(cin, cout)
    sp = init_conv3d(cin, mid, gen, kernel_size, **kw)
    tp = init_conv3d(mid, cout, gen, kernel_size, **kw)
    return {"spatial": {"weight": sp["weight"][:, :, :1].contiguous(), "bias": sp["bias"]},
            "temporal": {"weight": tp["weight"][:, :, :, :1, :1].contiguous(),
                         "bias": tp["bias"]}}


def _init_resnet(cin, cout, cfg, gen, kw):
    p = {"norm1": _init_norm(cin, cfg, kw), "conv1": _init_conv(cin, cout, cfg, gen, kw),
         "norm2": _init_norm(cout, cfg, kw), "conv2": _init_conv(cout, cout, cfg, gen, kw)}
    if cin != cout:
        p["conv_shortcut"] = init_linear(cin, cout, gen, **kw)
    return p


def _apply_resnet(p, x, cfg):
    h = _conv(p["conv1"], F.silu(_norm(p["norm1"], x, cfg)))
    h = _conv(p["conv2"], F.silu(_norm(p["norm2"], h, cfg)))
    shortcut = _linear(p["conv_shortcut"], x) if "conv_shortcut" in p else x
    return shortcut + h


def _valid_conv(x, weight, bias, stride):
    return add_channel_bias(F.conv3d(x, weight.to(x.dtype), None, stride=stride), bias)


def _downsample(p, x, in_time: bool):
    """A (0, 1) zero pad at the end of H, W (and F when in time), then a
    stride-2 VALID conv; at ``dims=(2, 1)`` the temporal conv only when
    downsampling in time."""
    x = F.pad(x, (0, 1, 0, 1, 0, 1 if in_time else 0))
    if "spatial" in p:
        sp, tp = p["spatial"], p["temporal"]
        x = _valid_conv(x, sp["weight"], sp.get("bias"), (1, 2, 2))
        if not in_time:
            return x
        return _valid_conv(x, tp["weight"], tp.get("bias"), (2, 1, 1))
    return _valid_conv(x, p["weight"], p.get("bias"), (2 if in_time else 1, 2, 2))


def _upsample(p, x, in_time: bool):
    """Nearest 2x in H, W (and F when in time), then the conv; at
    ``dims=(2, 1)`` without the time step, the spatial conv alone."""
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    if "spatial" in p and not in_time:
        return _conv(p, x, skip_time_conv=True)
    if in_time:
        x = x.repeat_interleave(2, dim=2)
    return _conv(p, x)


def init_video_autoencoder(cfg: VideoAutoencoderConfig, seed: int = 0, device="cuda",
                           dtype: torch.dtype = torch.float32) -> dict:
    """Seeded random params at the JAX init's scales, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    boc, lpb = cfg.block_out_channels, cfg.layers_per_block

    # add_channel_padding: conv_in / conv_out take patch_size**3 channels
    # whatever patch_size_t is
    if cfg.add_channel_padding:
        enc_in_ch = cfg.in_channels * cfg.patch_size**3
        dec_out_ch = cfg.out_channels * cfg.patch_size**3
    else:
        enc_in_ch = cfg.in_channels * cfg._pst * cfg.patch_size**2
        dec_out_ch = cfg.out_channels * cfg._pst * cfg.patch_size**2
    enc = {"conv_in": _init_conv(enc_in_ch, boc[0], cfg, gen, kw), "down_blocks": []}
    ch = boc[0]
    for i, out_ch in enumerate(boc):
        block = {"res_blocks": [_init_resnet(ch if j == 0 else out_ch, out_ch, cfg, gen, kw)
                                for j in range(lpb)]}
        if i < len(boc) - 1 and 2**i >= cfg.patch_size:
            block["downsample"] = _init_conv(out_ch, out_ch, cfg, gen, kw)
        enc["down_blocks"].append(block)
        ch = out_ch
    enc["mid_block"] = [_init_resnet(boc[-1], boc[-1], cfg, gen, kw) for _ in range(lpb)]
    enc["conv_norm_out"] = _init_norm(boc[-1], cfg, kw)
    conv_out_ch = cfg.latent_channels
    if cfg.latent_log_var == "per_channel":
        conv_out_ch *= 2
    elif cfg.latent_log_var == "uniform":
        conv_out_ch += 1
    enc["conv_out"] = _init_conv(boc[-1], conv_out_ch, cfg, gen, kw)

    rev = list(reversed(boc))
    dec = {"conv_in": _init_conv(cfg.latent_channels, rev[0], cfg, gen, kw),
           "mid_block": [_init_resnet(rev[0], rev[0], cfg, gen, kw) for _ in range(lpb)],
           "up_blocks": []}
    prev = rev[0]
    for i, out_ch in enumerate(rev):
        block = {"res_blocks": [_init_resnet(prev if j == 0 else out_ch, out_ch, cfg, gen, kw)
                                for j in range(lpb + 1)]}
        if i < len(boc) - 1 and 2 ** (len(boc) - i - 1) > cfg.patch_size:
            block["upsample"] = _init_conv(out_ch, out_ch, cfg, gen, kw)
        dec["up_blocks"].append(block)
        prev = out_ch
    dec["conv_norm_out"] = _init_norm(boc[0], cfg, kw)
    dec["conv_out"] = _init_conv(boc[0], dec_out_ch, cfg, gen, kw)

    params = {"encoder": enc, "decoder": dec}
    if cfg.use_quant_conv:
        params["quant_conv"] = init_linear(2 * cfg.latent_channels,
                                           2 * cfg.latent_channels, gen, **kw)
        params["post_quant_conv"] = init_linear(cfg.latent_channels,
                                                cfg.latent_channels, gen, **kw)
    params["per_channel_statistics"] = {
        "std_of_means": torch.ones(cfg.latent_channels, **kw),
        "mean_of_means": torch.zeros(cfg.latent_channels, **kw)}
    return params


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def video_encoder_apply(params: dict, cfg: VideoAutoencoderConfig,
                        sample: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, C_in] -> moments [B, F', H', W', C]. A single frame is
    patchified in space only."""
    in_time = sample.shape[1] != 1
    pst = cfg._pst if in_time else 1
    x = patchify_pixels(_to_ncdhw(sample), cfg.patch_size, pst)
    if cfg.patch_size > pst and (pst > 1 or cfg.add_channel_padding):
        # front zero channels up to patch_size**3 * in_channels
        pad_ch = x.shape[1] * (cfg.patch_size // pst) - x.shape[1]
        x = torch.cat([x.new_zeros((x.shape[0], pad_ch) + x.shape[2:]), x], dim=1)
    enc = params["encoder"]
    x = _conv(enc["conv_in"], x)
    for block in enc["down_blocks"]:
        for rb in block["res_blocks"]:
            x = _apply_resnet(rb, x, cfg)
        if "downsample" in block:
            x = _downsample(block["downsample"], x, in_time)
    for rb in enc["mid_block"]:
        x = _apply_resnet(rb, x, cfg)
    x = _conv(enc["conv_out"], F.silu(_norm(enc["conv_norm_out"], x, cfg)))
    if cfg.latent_log_var == "uniform":
        last = x[:, -1:]
        x = torch.cat([x, last.expand(-1, x.shape[1] - 2, -1, -1, -1)], dim=1)
    if "quant_conv" in params:
        x = _linear(params["quant_conv"], x)
    return _to_ndhwc(x)


def video_decoder_apply(params: dict, cfg: VideoAutoencoderConfig, latents: torch.Tensor,
                        upsample_in_time: bool = True) -> torch.Tensor:
    """[B, F', H', W', latent_channels] -> [B, F, H, W, C_out]."""
    dec = params["decoder"]
    x = _to_ncdhw(latents)
    if "post_quant_conv" in params:
        x = _linear(params["post_quant_conv"], x)
    x = _conv(dec["conv_in"], x)
    for rb in dec["mid_block"]:
        x = _apply_resnet(rb, x, cfg)
    for block in dec["up_blocks"]:
        for rb in block["res_blocks"]:
            x = _apply_resnet(rb, x, cfg)
        if "upsample" in block:
            x = _upsample(block["upsample"], x, upsample_in_time)
    x = _conv(dec["conv_out"], F.silu(_norm(dec["conv_norm_out"], x, cfg)))
    pst = cfg._pst if upsample_in_time else 1
    if cfg.patch_size > pst and (pst > 1 or cfg.add_channel_padding):
        # keep the leading channels
        x = x[:, :int(x.shape[1] * (pst / cfg.patch_size))]
    return _to_ndhwc(unpatchify_pixels(x, cfg.patch_size, pst))


def import_video_autoencoder_state(state: Dict[str, torch.Tensor],
                                   cfg: VideoAutoencoderConfig, device="cuda",
                                   dtype: Optional[torch.dtype] = None) -> dict:
    """A torch state dict (plain Conv3d keys, ``weight1`` / ``weight2``
    for a DualConv3d, the ``resnets`` -> ``res_blocks`` and
    ``downsamplers.0`` -> ``downsample`` renames already applied, as the
    reference loader applies them) -> the port's tree on ``device`` (and
    ``dtype`` if given). Raises ``KeyError`` on a missing key."""
    s = {k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in state.items()}

    def conv(key):
        if f"{key}.weight1" in s:  # DualConv3d
            p = {"spatial": {"weight": s[f"{key}.weight1"]},
                 "temporal": {"weight": s[f"{key}.weight2"]}}
            if f"{key}.bias1" in s:
                p["spatial"]["bias"] = s[f"{key}.bias1"]
                p["temporal"]["bias"] = s[f"{key}.bias2"]
            return p
        p = {"weight": s[f"{key}.weight"]}
        if f"{key}.bias" in s:
            p["bias"] = s[f"{key}.bias"]
        return p

    def lin1x1(key):
        p = {"weight": s[f"{key}.weight"][:, :, 0, 0, 0]}
        if f"{key}.bias" in s:
            p["bias"] = s[f"{key}.bias"]
        return p

    def norm(key):
        if cfg.norm_layer == "pixel_norm":
            return {}
        return {"scale": s[f"{key}.weight"], "bias": s[f"{key}.bias"]}

    def resnet(prefix):
        p = {"norm1": norm(f"{prefix}.norm1"), "conv1": conv(f"{prefix}.conv1"),
             "norm2": norm(f"{prefix}.norm2"), "conv2": conv(f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in s:
            p["conv_shortcut"] = lin1x1(f"{prefix}.conv_shortcut")
        return p

    boc, lpb = cfg.block_out_channels, cfg.layers_per_block
    enc = {"conv_in": conv("encoder.conv_in"), "down_blocks": [],
           "conv_norm_out": norm("encoder.conv_norm_out"),
           "conv_out": conv("encoder.conv_out")}
    for i in range(len(boc)):
        block = {"res_blocks": [resnet(f"encoder.down_blocks.{i}.res_blocks.{j}")
                                for j in range(lpb)]}
        for key in (f"encoder.down_blocks.{i}.downsample.conv",
                    f"encoder.down_blocks.{i}.downsample"):
            if f"{key}.weight" in s:
                block["downsample"] = conv(key)
                break
        enc["down_blocks"].append(block)
    enc["mid_block"] = [resnet(f"encoder.mid_block.res_blocks.{j}") for j in range(lpb)]

    dec = {"conv_in": conv("decoder.conv_in"),
           "mid_block": [resnet(f"decoder.mid_block.res_blocks.{j}") for j in range(lpb)],
           "up_blocks": [], "conv_norm_out": norm("decoder.conv_norm_out"),
           "conv_out": conv("decoder.conv_out")}
    for i in range(len(boc)):
        block = {"res_blocks": [resnet(f"decoder.up_blocks.{i}.res_blocks.{j}")
                                for j in range(lpb + 1)]}
        for key in (f"decoder.up_blocks.{i}.upsample.conv", f"decoder.up_blocks.{i}.upsample"):
            if f"{key}.weight" in s:
                block["upsample"] = conv(key)
                break
        dec["up_blocks"].append(block)

    params = {"encoder": enc, "decoder": dec}
    if "quant_conv.weight" in s:
        params["quant_conv"] = lin1x1("quant_conv")
        params["post_quant_conv"] = lin1x1("post_quant_conv")
    std = s.get("per_channel_statistics.std-of-means")
    if std is not None:
        params["per_channel_statistics"] = {
            "std_of_means": std,
            "mean_of_means": s.get("per_channel_statistics.mean-of-means",
                                   torch.zeros_like(std))}
    return params
