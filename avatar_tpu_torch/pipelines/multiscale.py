"""Two-pass multi-scale generation (port of
``avatar_tpu/pipelines/multiscale.py``): a pass at a downscaled size, the
latents upsampled 2x by the latent upsampler and AdaIN-matched to the
first pass's statistics, a second pass from them at twice the downscaled
size, then a bilinear resize to the requested size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from avatar_tpu_torch.models.latent_upsampler import (
    LatentUpsamplerConfig,
    latent_upsampler_apply,
)
from avatar_tpu_torch.models.vae import normalize_latents, un_normalize_latents
from avatar_tpu_torch.pipelines.pipeline import (
    GenerationParams,
    LTXVideoPipeline,
    adain_filter_latent,
    resize_media,
)


class LTXMultiScalePipeline:
    def __init__(self, video_pipeline: LTXVideoPipeline,
                 upsampler_cfg: LatentUpsamplerConfig, upsampler_params: dict):
        self.video_pipeline = video_pipeline
        self.upsampler_cfg = upsampler_cfg
        self.upsampler_params = upsampler_params

    @property
    def device(self) -> torch.device:
        return self.video_pipeline.device

    def upsample(self, latents: torch.Tensor) -> torch.Tensor:
        """Normalized latents -> the upsampler's output, normalized again
        with the VAE's per-channel statistics."""
        vp = self.video_pipeline
        lat = un_normalize_latents(latents, vp.vae_params, vp.vae_cfg, per_channel=True)
        up = latent_upsampler_apply(self.upsampler_params, self.upsampler_cfg, lat)
        return normalize_latents(up, vp.vae_params, vp.vae_cfg, per_channel=True)

    def __call__(
        self,
        params: GenerationParams,
        generator: torch.Generator,
        *args,
        downscale_factor: float = 2.0 / 3,
        first_pass: Optional[dict] = None,
        second_pass: Optional[dict] = None,
        output_type: str = "np",
        first_pass_noise: Optional[Dict[str, torch.Tensor]] = None,
        second_pass_noise: Optional[Dict[str, torch.Tensor]] = None,
        **kwargs,
    ) -> torch.Tensor:
        """``args`` / ``kwargs`` go to both passes of the video pipeline,
        ``first_pass`` / ``second_pass`` replace fields of ``params`` in
        each, and ``*_pass_noise`` are each pass's noise arguments (else
        drawn from ``generator``). ``ref_image`` and ``pose_frames`` are
        resized to each pass's size. Returns what the video pipeline's
        ``output_type`` names ("latent", "np" or "uint8"), at the requested
        size."""
        vp = self.video_pipeline
        sf = vp.vae_scale_factor
        down_w = int(params.width * downscale_factor)
        down_w -= down_w % sf
        down_h = int(params.height * downscale_factor)
        down_h -= down_h % sf

        def sized(h, w, noise):
            kw = dict(kwargs, **(noise or {}))
            for name in ("ref_image", "pose_frames"):
                media = kw.get(name)
                if media is not None and tuple(media.shape[2:4]) != (h, w):
                    kw[name] = resize_media(media.float(), h, w).to(media.dtype)
            return kw

        p1 = dataclasses.replace(params, width=down_w, height=down_h, **(first_pass or {}))
        latents = vp(p1, generator, *args, output_type="latent",
                     **sized(down_h, down_w, first_pass_noise))
        upsampled = adain_filter_latent(self.upsample(latents), latents)

        p2 = dataclasses.replace(params, width=down_w * 2, height=down_h * 2,
                                 **(second_pass or {}))
        # resize in float; quantize after it when uint8 was asked for
        inner = "np" if output_type == "uint8" else output_type
        result = vp(p2, generator, *args, latents=upsampled, output_type=inner,
                    **sized(down_h * 2, down_w * 2, second_pass_noise))
        if output_type == "latent":
            return result
        if tuple(result.shape[2:4]) != (params.height, params.width):
            result = resize_media(result.float(), params.height, params.width).to(
                result.dtype)
        if output_type == "uint8":
            return (torch.clamp(result, 0, 1) * 255.0 + 0.5).to(torch.uint8)
        return result
