"""Avatar video generation pipeline (port of
``avatar_tpu/pipelines/pipeline.py``).

The ported path is bf16 single-condition inference: VAE-encode the
reference image and pose frames, draw the initial noise, precompute the
RoPE tables, the caption k/v and the AdaLN tables once, run the Euler walk
over ``dit_apply`` with the avatar lerp, then decode with decode-time noise
and timestep conditioning. Settings outside that path (CFG, STG, Heun,
stochastic sampling, conditioning items, skipped steps) raise
``NotImplementedError``.

``torch`` cannot reproduce ``jax.random``: every random draw comes from the
caller's ``torch.Generator`` unless it is handed in as a tensor
(``ref_noise``, ``pose_noise``, ``init_noise``, ``decode_noise``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from avatar_tpu_torch.diffusion.rf import RectifiedFlowSchedule, rf_step
from avatar_tpu_torch.models.dit import (
    DiTConfig,
    avatar_condition_tokens,
    dit_apply,
    permute_dit_params_for_split_rope,
    precompute_cross_attention_kv,
    precompute_timestep_tables,
)
from avatar_tpu_torch.models.patchifier import patchify, unpatchify
from avatar_tpu_torch.models.vae import VAEConfig, vae_decode, vae_encode
from avatar_tpu_torch.ops.color import rgb_to_yuv420
from avatar_tpu_torch.ops.rope import (
    latent_to_pixel_coords,
    precompute_freqs_cis,
    split_freqs,
)

OUTPUT_TYPES = ("latent", "np", "uint8", "yuv420")


@dataclass
class GenerationParams:
    """Knobs of one generation run (same fields as the JAX package)."""

    height: int
    width: int
    num_frames: int
    frame_rate: float = 25.0
    num_inference_steps: int = 20
    skip_initial_inference_steps: int = 0
    skip_final_inference_steps: int = 0
    guidance_scale: Union[float, List[float]] = 4.5
    stg_scale: Union[float, List[float]] = 1.0
    rescaling_scale: Union[float, List[float]] = 0.7
    guidance_timesteps: Optional[List[float]] = None
    cfg_star_rescale: bool = False
    skip_layer_strategy: Optional[object] = None
    skip_block_list: Optional[Union[List[int], List[List[int]]]] = None
    decode_timestep: Union[float, List[float]] = 0.0
    decode_noise_scale: Optional[Union[float, List[float]]] = None
    tone_map_compression_ratio: float = 0.0
    stochastic_sampling: bool = False
    image_cond_noise_scale: float = 0.0
    is_video: bool = True
    vae_per_channel_normalize: bool = True
    solver: str = "euler"


def _max(value) -> float:
    return max(value) if isinstance(value, (list, tuple)) else float(value)


def _check_ported(p: GenerationParams) -> None:
    unported = []
    if _max(p.guidance_scale) > 1.0:
        unported.append("classifier-free guidance (guidance_scale > 1)")
    if _max(p.stg_scale) > 0.0:
        unported.append("STG (stg_scale > 0)")
    if p.solver != "euler":
        unported.append(f"solver={p.solver!r}")
    if p.stochastic_sampling:
        unported.append("stochastic_sampling")
    if p.skip_initial_inference_steps or p.skip_final_inference_steps:
        unported.append("skipped inference steps")
    if unported:
        raise NotImplementedError("not ported yet: " + ", ".join(unported))


def tone_map_latents(latents: torch.Tensor, compression: float) -> torch.Tensor:
    """Sigmoid dynamic-range compression."""
    if not 0 <= compression <= 1:
        raise ValueError("Compression must be in the range [0, 1]")
    if compression == 0.0:
        return latents
    scale_factor = compression * 0.75
    sigmoid_term = torch.sigmoid(4.0 * scale_factor * (latents.abs() - 1.0))
    return latents * (1.0 - 0.8 * scale_factor * sigmoid_term)


class LTXVideoPipeline:
    """Schedule prep on the host, VAE encodes, the Euler denoising walk and
    the decode, all on ``device``."""

    def __init__(
        self,
        dit_cfg: DiTConfig,
        dit_params: dict,
        vae_cfg: VAEConfig,
        vae_params: dict,
        schedule: Optional[RectifiedFlowSchedule] = None,
        patch_size: int = 1,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.dit_cfg = dit_cfg
        # dit_params is the UNPERMUTED tree; the split-RoPE layout is made
        # here, once. Seeding another pipeline from self.dit_params would
        # permute twice and corrupt attention.
        self.raw_dit_params = dit_params
        self.dit_params = permute_dit_params_for_split_rope(dit_params, dit_cfg)
        self.vae_cfg = vae_cfg
        self.vae_params = vae_params
        self.schedule = schedule or RectifiedFlowSchedule.create(
            sampler="Uniform", shifting="SD3", target_shift_terminal=0.1)
        self.patch_size = patch_size
        self.video_scale_factor = vae_cfg.temporal_downscale_factor
        self.vae_scale_factor = vae_cfg.spatial_downscale_factor

    # -- pieces -------------------------------------------------------------

    def encode_media(self, media, generator, noise=None,
                     per_channel_normalize=True) -> torch.Tensor:
        if noise is not None:
            noise = noise.to(self.device)
        return vae_encode(self.vae_params, self.vae_cfg, media.to(self.device),
                          generator=generator, noise=noise,
                          per_channel_normalize=per_channel_normalize)

    def prepare_latents(self, generator, latent_shape, dtype,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Initial noise [B, F, H, W, C]. Each sample draws from its own
        generator seeded from ``generator``, so sample i's noise does not
        depend on the batch size."""
        if noise is not None:
            if tuple(noise.shape) != tuple(latent_shape):
                raise ValueError(f"init noise {tuple(noise.shape)} != {latent_shape}")
            return noise.to(self.device, dtype)
        seeds = torch.randint(0, 2**62, (latent_shape[0],), generator=generator,
                              device=generator.device).tolist()
        out = []
        for seed in seeds:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            out.append(torch.randn(latent_shape[1:], generator=g,
                                   device=self.device, dtype=torch.float32))
        return torch.stack(out).to(dtype)

    def prepare_conditioning(self, init_latents: torch.Tensor):
        """No-conditioning-items branch: (tokens [B,N,C], pixel coords
        [B,3,N])."""
        tokens, coords = patchify(init_latents, self.patch_size)
        scale_factors = (self.video_scale_factor, self.vae_scale_factor,
                         self.vae_scale_factor)
        return tokens, latent_to_pixel_coords(coords, scale_factors)

    def denoise(self, tokens, fractional_coords, prompt_embeds, prompt_mask,
                sigmas: torch.Tensor, ref_lat, pose_lat) -> torch.Tensor:
        """The Euler walk over ``sigmas`` (f32, on the device)."""
        cfg, params = self.dit_cfg, self.dit_params
        dtype = tokens.dtype
        freqs = split_freqs(precompute_freqs_cis(
            fractional_coords, dim=cfg.inner_dim,
            theta=cfg.positional_embedding_theta,
            max_pos=cfg.positional_embedding_max_pos, out_dtype=dtype,
        ))
        cross_kv, _ = precompute_cross_attention_kv(params, cfg, prompt_embeds,
                                                    dtype=dtype)
        sigmas_ext = torch.cat([sigmas, sigmas.new_zeros(1)])
        ada_table, emb_table = precompute_timestep_tables(
            params, cfg, sigmas_ext, tokens.shape[0], dtype=dtype)
        mask = prompt_mask.to(torch.float32).contiguous()
        latents = tokens
        for i in range(sigmas.shape[0]):
            latent_in = latents
            if ref_lat is not None:
                latent_in = avatar_condition_tokens(latent_in, ref_lat, pose_lat)
            pred = dit_apply(
                params, cfg, latent_in, encoder_attention_mask=mask,
                freqs_cis=freqs, cross_kv=cross_kv,
                timestep_tables=(ada_table[i], emb_table[i]),
            ).to(dtype)
            latents = rf_step(sigmas, pred, sigmas[i], latents)
        return latents

    def decode_latents(self, latents, p: GenerationParams, generator=None,
                       noise: Optional[torch.Tensor] = None,
                       output_type: str = "np") -> torch.Tensor:
        """Decode-time noise and timestep conditioning, tone map, VAE decode
        and the output quantization."""
        b = latents.shape[0]
        dt = p.decode_timestep
        dt = list(dt) if isinstance(dt, (list, tuple)) else [dt] * b
        dns = p.decode_noise_scale
        if dns is None:
            dns = dt
        elif not isinstance(dns, (list, tuple)):
            dns = [dns] * b
        timestep = None
        if self.vae_cfg.timestep_conditioning:
            if noise is None:
                noise = torch.randn(latents.shape, generator=generator,
                                    device=self.device, dtype=torch.float32)
            noise = noise.to(self.device, latents.dtype)
            scale = torch.tensor(dns, dtype=torch.float32, device=self.device)
            scale = scale.reshape(-1, 1, 1, 1, 1).to(latents.dtype)
            latents = latents * (1 - scale) + noise * scale
            timestep = torch.tensor(dt, dtype=torch.float32, device=self.device)
        latents = tone_map_latents(latents, float(p.tone_map_compression_ratio))
        images = vae_decode(self.vae_params, self.vae_cfg, latents,
                            timestep=timestep,
                            per_channel_normalize=p.vae_per_channel_normalize)
        images = torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)
        if output_type == "uint8":
            return (images * 255.0 + 0.5).to(torch.uint8)
        if output_type == "yuv420":
            return rgb_to_yuv420(images)
        return images

    # -- main entry ---------------------------------------------------------

    def __call__(
        self,
        params: GenerationParams,
        generator: torch.Generator,
        prompt_embeds: torch.Tensor,  # [B, L, caption_channels]
        prompt_attention_mask: torch.Tensor,  # [B, L]
        ref_image: Optional[torch.Tensor] = None,  # [B, 1, H, W, 3]
        pose_frames: Optional[torch.Tensor] = None,  # [B, F, H, W, 3]
        ref_latents: Optional[torch.Tensor] = None,  # [B, 1, h, w, C]
        pose_latents: Optional[torch.Tensor] = None,  # [B, f, h, w, C]
        output_type: str = "np",
        dtype: torch.dtype = torch.bfloat16,
        ref_noise: Optional[torch.Tensor] = None,
        pose_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
        decode_noise: Optional[torch.Tensor] = None,
        stage_times: Optional[Dict[str, float]] = None,
    ) -> torch.Tensor:
        """Generate one batch. ``output_type``: "latent" (denoised latents
        [B, F', H', W', C]), "np" (float frames [B, F, H, W, 3] in [0, 1]),
        "uint8" or "yuv420" (I420 planes [B, F, H*3/2, W]); all returned as
        tensors on the device. ``stage_times``, if given, receives the
        seconds of the encode, denoise and decode stages (each ends in a
        device synchronize)."""
        p = params
        _check_ported(p)
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type must be one of {OUTPUT_TYPES}")
        dev = self.device

        def mark(stage, t0):
            if stage_times is None:
                return t0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stage_times[stage] = now - t0
            return now

        t0 = time.perf_counter()
        b = prompt_embeds.shape[0]
        video_scale = self.video_scale_factor if p.is_video else 1
        lat_f = p.num_frames // video_scale + (1 if p.is_video else 0)
        lat_h = p.height // self.vae_scale_factor
        lat_w = p.width // self.vae_scale_factor
        latent_shape = (b, lat_f, lat_h, lat_w, self.dit_cfg.in_channels)

        sched = self.schedule.set_timesteps(
            num_inference_steps=p.num_inference_steps,
            samples_shape=(b, self.dit_cfg.in_channels, lat_f, lat_h, lat_w),
        )
        sigmas = torch.tensor(np.asarray(sched.sigmas), dtype=torch.float32,
                              device=dev)
        prompt_embeds = prompt_embeds.to(dev, dtype)
        prompt_mask = prompt_attention_mask.to(dev)

        ref_lat = None if ref_latents is None else ref_latents.to(dev, dtype)
        pose_lat = None if pose_latents is None else pose_latents.to(dev, dtype)
        pcn = p.vae_per_channel_normalize
        if ref_image is not None:
            ref_lat = self.encode_media(ref_image.to(dtype), generator, ref_noise, pcn)
        if pose_frames is not None:
            pose_lat = self.encode_media(pose_frames.to(dtype), generator,
                                         pose_noise, pcn)
        if (ref_lat is None) != (pose_lat is None):
            raise ValueError("the avatar lerp needs both ref and pose latents")
        t0 = mark("encode_s", t0)

        init = self.prepare_latents(generator, latent_shape, dtype, init_noise)
        tokens, pixel_coords = self.prepare_conditioning(init)
        fractional = pixel_coords.float()
        fractional[:, 0] *= 1.0 / p.frame_rate
        final_tokens = self.denoise(tokens, fractional, prompt_embeds,
                                    prompt_mask, sigmas, ref_lat, pose_lat)
        latents = unpatchify(final_tokens, lat_f, lat_h, lat_w, self.patch_size)
        t0 = mark("denoise_s", t0)
        if output_type == "latent":
            return latents
        out = self.decode_latents(latents, p, generator, decode_noise, output_type)
        mark("decode_s", t0)
        return out
