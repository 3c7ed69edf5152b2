"""Wan2.1 image-to-video (``WanI2V.generate`` of github.com/Wan-Video/Wan2.1,
``wan/image2video.py``) on the port's Wan DiT and VAE.

One reference image becomes a clip: the image followed by zero frames is
encoded by the VAE (y), a first-frame mask marks the frames the image
fixes, and the DiT walks the noisy latent from sigma 1 to 0 over the
shifted flow schedule s u / (1 + (s - 1) u) with Euler steps (the
published default solver is UniPC), conditioned on the caption's
umT5-XXL embeddings and the image's CLIP ViT-H/14 tokens, which the caller
encodes. Classifier-free guidance runs the conditional and unconditional
branches as one batch of two.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from avatar_tpu_torch.models import wan, wan_vae
from avatar_tpu_torch.ops.color import rgb_to_yuv420
from avatar_tpu_torch.utils.profiling import annotate, recording

OUTPUT_TYPES = ("latent", "np", "uint8", "yuv420")


@dataclass
class WanGenerationParams:
    """The published 480p operating point by default."""

    height: int = 480
    width: int = 832
    num_frames: int = 81
    num_inference_steps: int = 40
    guidance_scale: float = 5.0
    shift: float = 3.0


class WanI2VPipeline:
    """The I2V pipeline over a Wan DiT tree and a Wan VAE tree, both in the
    published layout (``dit_params`` unpermuted: the split-RoPE layout of
    self-attention is made here, once), in ``dtype`` on ``device``."""

    def __init__(self, dit_cfg: wan.WanConfig, dit_params: dict,
                 vae_cfg: wan_vae.WanVAEConfig, vae_params: dict, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device)
        self.dtype = dtype
        self.dit_cfg, self.vae_cfg = dit_cfg, vae_cfg
        self.dit_params = wan.permute_wan_params_for_split_rope(dit_params, dit_cfg)
        self.vae_params = vae_params

    def encode_condition(self, image: torch.Tensor, frames: int) -> torch.Tensor:
        """The model's conditioning y [B, z, F', h, w]: the image [B, 1, H, W,
        3] in [-1, 1] followed by ``frames`` - 1 zero frames, encoded."""
        img = image.to(self.device, self.dtype).permute(0, 4, 1, 2, 3)
        b, c, _, h, w = img.shape
        video = torch.cat([img, img.new_zeros(b, c, frames - 1, h, w)], dim=2)
        return wan_vae.encode(self.vae_params, self.vae_cfg, video)

    def __call__(
        self,
        params: WanGenerationParams,
        generator: Optional[torch.Generator],
        image: torch.Tensor,  # [B, 1, H, W, 3] in [-1, 1]
        text_embeds: torch.Tensor,  # [B, text_len, text_dim], zero rows past the caption
        clip_embeds: torch.Tensor,  # [B, 257, 1280]
        negative_text_embeds: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,  # [B, z, F', h, w]
        output_type: str = "yuv420",
        stage_times: Optional[Dict[str, float]] = None,
        return_latents: bool = False,
    ):
        """Generate one batch. ``output_type``: "latent" ([B, z, F', h, w]),
        "np" (float frames [B, F, H, W, 3] in [0, 1]), "uint8" or "yuv420"
        (I420 planes [B, F, H*3/2, W]); all on the device. The unconditional
        branch of guidance takes ``negative_text_embeds`` (zeros where absent).
        ``init_noise`` replaces the draw from ``generator``. ``stage_times``,
        if given, receives the seconds of the encode, denoise and decode
        stages (``encode_s``, ``denoise_s``, ``decode_s``; each ends in a
        device synchronize) and the call's :meth:`Recording.flat` keys, as
        ``LTXVideoPipeline.__call__`` gives them. ``return_latents``: return
        (output, denoised latents [B, z, F', h, w] f32) instead."""
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type must be one of {OUTPUT_TYPES}")
        p, cfg, vcfg, dev, dt = params, self.dit_cfg, self.vae_cfg, self.device, self.dtype
        ts, ss = vcfg.temporal_stride, vcfg.spatial_stride
        if (p.num_frames - 1) % ts or p.height % (ss * 2) or p.width % (ss * 2):
            raise ValueError(f"{p.num_frames} frames at {p.height}x{p.width} do not fit the "
                             f"VAE's {ts}x{ss}x{ss} stride and the 2x2 patch")
        b = image.shape[0]
        shape = (b, vcfg.z_dim, (p.num_frames - 1) // ts + 1, p.height // ss, p.width // ss)

        def mark(stage, t0):
            if stage_times is None:
                return t0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stage_times[stage] = now - t0
            return now

        t0 = time.perf_counter()
        spans = contextlib.nullcontext() if stage_times is None else recording()
        with spans as rec:
            with annotate("pipe.encode"):
                y = self.encode_condition(image, p.num_frames)
            t0 = mark("encode_s", t0)
            with annotate("pipe.prepare"):
                cfg_on = p.guidance_scale > 1.0
                text = text_embeds.to(dev, dt)
                clip = clip_embeds.to(dev, dt)
                if cfg_on:
                    neg = (torch.zeros_like(text) if negative_text_embeds is None
                           else negative_text_embeds.to(dev, dt))
                    text, clip = torch.cat([text, neg]), torch.cat([clip, clip])
                mask = wan.first_frame_mask(p.num_frames, shape[3], shape[4], b, ts, dev, dt)
                cond = torch.cat([mask, y.to(dt)], dim=1)
                if cfg_on:
                    cond = torch.cat([cond, cond])
                lat = (torch.randn(shape, generator=generator, device=dev)
                       if init_noise is None else init_noise.to(dev, torch.float32))
                sig = wan.flow_sigmas(p.num_inference_steps, p.shift)
                pt, ph, pw = cfg.patch_size
                grid = (shape[2] // pt, shape[3] // ph, shape[4] // pw)
            kv, e, e0, rope = wan.precompute(
                self.dit_params, cfg, text, clip, torch.tensor(sig[:-1], device=dev), grid, dt)
            n = 2 if cfg_on else 1
            for i in range(p.num_inference_steps):
                with annotate("pipe.step"):
                    x_in = torch.cat([lat.to(dt), cond[:b]], dim=1)
                    if cfg_on:
                        x_in = torch.cat([x_in, torch.cat([lat.to(dt), cond[b:]], dim=1)])
                    v = wan.wan_apply(self.dit_params, cfg, x_in, e[i:i + 1].expand(n * b, -1),
                                      e0[i:i + 1].expand(n * b, -1, -1), kv, rope, dt)
                    with annotate("pipe.rf_step"):
                        if cfg_on:
                            v = v[b:] + p.guidance_scale * (v[:b] - v[b:])
                        lat = lat + (sig[i + 1] - sig[i]) * v
            t0 = mark("denoise_s", t0)
            if output_type == "latent":
                out = lat
            else:
                with annotate("pipe.decode"):
                    video = wan_vae.decode(self.vae_params, vcfg, lat.to(dt))
                with annotate("pipe.output"):
                    frames = torch.clamp(video.permute(0, 2, 3, 4, 1).float() * 0.5 + 0.5,
                                         0.0, 1.0)
                    if output_type == "uint8":
                        out = (frames * 255.0 + 0.5).to(torch.uint8)
                    elif output_type == "yuv420":
                        out = rgb_to_yuv420(frames)
                    else:
                        out = frames
                mark("decode_s", t0)
        if rec is not None:
            stage_times.update(rec.flat())
        return (out, lat) if return_latents else out
