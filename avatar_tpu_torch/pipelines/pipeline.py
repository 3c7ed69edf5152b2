"""Avatar video generation pipeline (port of
``avatar_tpu/pipelines/pipeline.py``).

VAE-encode the reference image and pose frames, draw the initial noise,
precompute the RoPE tables, the caption k/v and the AdaLN tables once, run
the denoising walk over ``dit_apply`` with the avatar lerp, then decode
with decode-time noise and timestep conditioning. The walk takes
classifier-free guidance (with ``cfg_star_rescale``), STG with the std
rescale, per-step guidance lists, the Euler or Heun solver, stochastic
sampling and skipped final steps. Still missing, and raising
``NotImplementedError``: conditioning items, ``media_items``/``latents``
inputs, ``skip_initial_inference_steps`` and ``image_cond_noise_scale``.

``torch`` cannot reproduce ``jax.random``: every random draw comes from the
caller's ``torch.Generator`` unless it is handed in as a tensor
(``ref_noise``, ``pose_noise``, ``init_noise``, ``step_noise``,
``decode_noise``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from avatar_tpu_torch.diffusion.rf import RectifiedFlowSchedule, rf_step
from avatar_tpu_torch.models.dit import (
    DiTConfig,
    SkipLayerStrategy,
    avatar_condition_tokens,
    create_skip_layer_mask,
    dit_apply,
    permute_dit_params_for_split_rope,
    precompute_cross_attention_kv,
    precompute_timestep_tables,
    stack_block_params,
)
from avatar_tpu_torch.models.patchifier import patchify, unpatchify
from avatar_tpu_torch.models.vae import VAEConfig, vae_decode, vae_encode
from avatar_tpu_torch.ops.color import rgb_to_yuv420
from avatar_tpu_torch.ops.rope import (
    latent_to_pixel_coords,
    precompute_freqs_cis,
    split_freqs,
)
from avatar_tpu_torch.utils.quantize import quantize_dit_params

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
    skip_layer_strategy: Optional[SkipLayerStrategy] = None
    skip_block_list: Optional[Union[List[int], List[List[int]]]] = None
    decode_timestep: Union[float, List[float]] = 0.0
    decode_noise_scale: Optional[Union[float, List[float]]] = None
    tone_map_compression_ratio: float = 0.0
    stochastic_sampling: bool = False
    image_cond_noise_scale: float = 0.0
    is_video: bool = True
    vae_per_channel_normalize: bool = True
    # "euler", or "heun": a predictor-corrector with two velocity
    # evaluations per step and a plain Euler last step (to sigma 0)
    solver: str = "euler"


def _check_ported(p: GenerationParams, **inputs) -> None:
    unported = [f"{name} input" for name, val in inputs.items() if val is not None]
    if p.skip_initial_inference_steps:
        unported.append("skip_initial_inference_steps (needs media_items or latents)")
    if p.image_cond_noise_scale > 0.0:
        unported.append("image_cond_noise_scale > 0 (needs conditioning items)")
    if unported:
        raise NotImplementedError("not ported yet: " + ", ".join(unported))


def _guidance_mapping(timesteps: np.ndarray,
                      guidance_timesteps: Sequence[float]) -> List[int]:
    """Index of the guidance entry that applies at each schedule step: the
    first entry at or below the step's timestep, else the last."""
    mapping = []
    for t in timesteps:
        indices = [i for i, v in enumerate(guidance_timesteps) if v <= t]
        mapping.append(indices[0] if indices else len(guidance_timesteps) - 1)
    return mapping


def _as_step_array(value, timesteps: np.ndarray,
                   guidance_timesteps: Optional[Sequence[float]]) -> np.ndarray:
    """A scalar broadcast over the schedule, or a per-guidance-timestep
    list mapped onto it."""
    if not isinstance(value, (list, tuple)):
        return np.full(len(timesteps), float(value), dtype=np.float32)
    if guidance_timesteps is None:
        raise ValueError("list-valued guidance requires guidance_timesteps")
    mapping = _guidance_mapping(timesteps, guidance_timesteps)
    return np.asarray([value[m] for m in mapping], dtype=np.float32)


def _tile(x: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    return x if x is None or n == 1 else torch.cat([x] * n)


def _flat_f32(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def combine_guidance(parts, do_cfg: bool, do_stg: bool, g, sg,
                     rescale: Optional[float], cfg_star: bool) -> torch.Tensor:
    """The guided velocity from the conds' predictions ``parts`` =
    [uncond if CFG | text | perturbed if STG], each [B, N, C]. ``g`` and
    ``sg`` are this step's CFG and STG scales as 0-d tensors of the latent
    dtype (so the math does not leave it). ``rescale``, a host float or
    None for no rescale, pulls the guided prediction's std toward the text
    prediction's; the stds are taken in f32, unbiased."""
    parts = list(parts)
    uncond = parts.pop(0) if do_cfg else None
    text = parts.pop(0)
    pred = text
    if do_cfg:
        if cfg_star:
            pos, neg = _flat_f32(text), _flat_f32(uncond)
            alpha = (pos * neg).sum(1, keepdim=True) / (
                (neg**2).sum(1, keepdim=True) + 1e-8)
            uncond = alpha.reshape(-1, 1, 1).to(uncond.dtype) * uncond
        pred = uncond + g * (text - uncond)
    if do_stg:
        pred = pred + sg * (text - parts.pop(0))
        if rescale is not None:
            text_std = _flat_f32(text).std(dim=1, keepdim=True, correction=1)
            pred_std = _flat_f32(pred).std(dim=1, keepdim=True, correction=1)
            factor = rescale * (text_std / pred_std) + (1 - rescale)
            pred = pred * factor.reshape(-1, 1, 1).to(pred.dtype)
    return pred


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
    """Schedule prep on the host, VAE encodes, the denoising walk and the
    decode, all on ``device``.

    ``attention_impl`` ("auto", "xla", "flash") and ``rope_split`` choose
    the DiT's attention path (see ``models/dit.py:_attention``);
    ``quantize_weights`` (True or "w8": weight-only int8; "w8a8": int8
    activations and weights in the per-token block linears, see
    ``utils/quantize.py``) quantizes the DiT before the split-RoPE
    permutation and the stacking; ``quantize_vae`` (the int8 conv3d) is
    not ported and raises;
    ``scan_blocks`` keeps the transformer blocks stacked on a leading
    layer axis, the layout the JAX package scans over (here walked by the
    same Python loop, slice by slice)."""

    def __init__(
        self,
        dit_cfg: DiTConfig,
        dit_params: dict,
        vae_cfg: VAEConfig,
        vae_params: dict,
        schedule: Optional[RectifiedFlowSchedule] = None,
        patch_size: int = 1,
        attention_impl: str = "auto",
        quantize_weights: Union[bool, str] = False,
        quantize_vae: Union[bool, str] = False,
        rope_split: bool = True,
        scan_blocks: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.dit_cfg = dit_cfg
        self.attention_impl = attention_impl
        self.rope_split = rope_split
        self.scan_blocks = scan_blocks
        if quantize_vae:
            raise NotImplementedError(
                "quantize_vae needs an int8 conv3d (W8A8 convolutions), which "
                "is not ported yet")
        if quantize_weights:
            mode = "w8" if quantize_weights is True else quantize_weights
            dit_params = quantize_dit_params(dit_params, mode=mode)
        # dit_params is the UNPERMUTED tree (quantized first, as in the JAX
        # package); the split-RoPE layout is made here, once. Seeding
        # another pipeline from self.dit_params would permute twice and
        # corrupt attention.
        self.raw_dit_params = dit_params
        if rope_split:
            dit_params = permute_dit_params_for_split_rope(dit_params, dit_cfg)
        if scan_blocks:
            dit_params = dict(dit_params,
                              blocks=stack_block_params(dit_params["blocks"]))
        self.dit_params = dit_params
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
                sigmas: torch.Tensor, ref_lat, pose_lat, *,
                guidance: Optional[np.ndarray] = None,
                stg: Optional[np.ndarray] = None,
                rescale: Optional[np.ndarray] = None,
                cfg_star: bool = False,
                skip_layer_mask: Optional[torch.Tensor] = None,
                skip_layer_strategy: Optional[SkipLayerStrategy] = None,
                solver: str = "euler", stochastic: bool = False,
                generator: Optional[torch.Generator] = None,
                step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The denoising walk over ``sigmas`` (f32, on the device).

        ``tokens`` [B, N, C]; ``fractional_coords``, ``prompt_embeds`` and
        ``prompt_mask`` carry the conds stacked along the batch,
        [uncond if CFG | text | perturbed if STG], which ``guidance`` and
        ``stg`` (per-step host arrays; defaults 1 and 0) switch on.
        ``skip_layer_mask`` is [layers, B*conds] or, per step,
        [steps, layers, B*conds]. Heun evaluates the model twice per step
        except at the last, which is plain Euler. Stochastic sampling
        takes step i's noise from ``step_noise[i]`` or draws it from
        ``generator``.
        """
        cfg, params = self.dit_cfg, self.dit_params
        dtype = tokens.dtype
        steps = sigmas.shape[0]
        guidance = np.ones(steps, np.float32) if guidance is None else guidance
        stg = np.zeros(steps, np.float32) if stg is None else stg
        rescale = np.ones(steps, np.float32) if rescale is None else rescale
        do_cfg, do_stg = bool((guidance > 1.0).any()), bool((stg > 0).any())
        num_conds = prompt_embeds.shape[0] // tokens.shape[0]
        if num_conds != 1 + do_cfg + do_stg:
            raise ValueError(
                f"{num_conds} stacked conds for CFG={do_cfg}, STG={do_stg}")
        # per-step scales in the latent dtype, as the JAX package casts them
        g_dev = torch.as_tensor(guidance, device=self.device).to(dtype)
        sg_dev = torch.as_tensor(stg, device=self.device).to(dtype)

        freqs = precompute_freqs_cis(
            fractional_coords, dim=cfg.inner_dim,
            theta=cfg.positional_embedding_theta,
            max_pos=cfg.positional_embedding_max_pos, out_dtype=dtype,
        )
        if self.rope_split:
            freqs = split_freqs(freqs)
        cross_kv, _ = precompute_cross_attention_kv(params, cfg, prompt_embeds,
                                                    dtype=dtype)
        sigmas_ext = torch.cat([sigmas, sigmas.new_zeros(1)])
        ada_table, emb_table = precompute_timestep_tables(
            params, cfg, sigmas_ext, prompt_embeds.shape[0], dtype=dtype)
        mask = prompt_mask.to(torch.float32).contiguous()
        ref_b, pose_b = _tile(ref_lat, num_conds), _tile(pose_lat, num_conds)

        def guided_velocity(lat, i, level):
            """The guided velocity at noise level ``sigmas_ext[level]`` with
            step i's guidance scales and skip mask."""
            latent_in = _tile(lat, num_conds)
            if ref_b is not None:
                latent_in = avatar_condition_tokens(latent_in, ref_b, pose_b)
            step_mask = skip_layer_mask
            if step_mask is not None and step_mask.ndim == 3:
                step_mask = step_mask[i]
            pred = dit_apply(
                params, cfg, latent_in, encoder_attention_mask=mask,
                skip_layer_mask=step_mask, skip_layer_strategy=skip_layer_strategy,
                attention_impl=self.attention_impl, freqs_cis=freqs,
                rope_split=self.rope_split, cross_kv=cross_kv,
                timestep_tables=(ada_table[level], emb_table[level]),
            ).to(dtype)
            if num_conds == 1:
                return pred
            # the rescale applies where this step has STG on and a scale != 1
            rs = float(rescale[i]) if stg[i] > 0.0 and rescale[i] != 1.0 else None
            return combine_guidance(pred.chunk(num_conds), do_cfg, do_stg, g_dev[i],
                                    sg_dev[i], rs, cfg_star)

        latents = tokens
        for i in range(steps):
            pred = guided_velocity(latents, i, i)
            if solver == "heun" and i + 1 < steps:
                # Euler predictor to the next level, then the trapezoidal
                # corrector; rf_step is linear in the velocity, so the Heun
                # update is rf_step on the averaged velocity
                predicted = rf_step(sigmas, pred, sigmas[i], latents)
                pred = 0.5 * (pred + guided_velocity(predicted, i, i + 1))
            latents = rf_step(
                sigmas, pred, sigmas[i], latents, stochastic_sampling=stochastic,
                generator=generator,
                noise=None if step_noise is None else step_noise[i])
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
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_attention_mask: Optional[torch.Tensor] = None,
        latents: Optional[torch.Tensor] = None,
        media_items: Optional[torch.Tensor] = None,
        conditioning_items: Optional[list] = None,
        ref_image: Optional[torch.Tensor] = None,  # [B, 1, H, W, 3]
        pose_frames: Optional[torch.Tensor] = None,  # [B, F, H, W, 3]
        ref_latents: Optional[torch.Tensor] = None,  # [B, 1, h, w, C]
        pose_latents: Optional[torch.Tensor] = None,  # [B, f, h, w, C]
        output_type: str = "np",
        dtype: torch.dtype = torch.bfloat16,
        ref_noise: Optional[torch.Tensor] = None,
        pose_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,  # [steps, B, N, C]
        decode_noise: Optional[torch.Tensor] = None,
        stage_times: Optional[Dict[str, float]] = None,
    ) -> torch.Tensor:
        """Generate one batch. ``output_type``: "latent" (denoised latents
        [B, F', H', W', C]), "np" (float frames [B, F, H, W, 3] in [0, 1]),
        "uint8" or "yuv420" (I420 planes [B, F, H*3/2, W]); all returned as
        tensors on the device. Absent negative prompt embeds are zeros with
        an all-zero mask. ``stage_times``, if given, receives the seconds
        of the encode, denoise and decode stages (each ends in a device
        synchronize)."""
        p = params
        _check_ported(p, latents=latents, media_items=media_items,
                      conditioning_items=conditioning_items or None)
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"output_type must be one of {OUTPUT_TYPES}")
        if p.solver not in ("euler", "heun"):
            raise ValueError(f"unknown solver {p.solver!r}")
        if p.solver == "heun" and p.stochastic_sampling:
            raise ValueError("solver='heun' is a deterministic ODE integrator; "
                             "it does not compose with stochastic_sampling")
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
        timesteps = np.asarray(sched.sigmas)
        if p.skip_final_inference_steps:
            timesteps = timesteps[:len(timesteps) - p.skip_final_inference_steps]
        sigmas = torch.tensor(timesteps, dtype=torch.float32, device=dev)

        guidance = _as_step_array(p.guidance_scale, timesteps, p.guidance_timesteps)
        stg = _as_step_array(p.stg_scale, timesteps, p.guidance_timesteps)
        rescale = _as_step_array(p.rescaling_scale, timesteps, p.guidance_timesteps)
        do_cfg, do_stg = bool((guidance > 1.0).any()), bool((stg > 0).any())
        num_conds = 1 + do_cfg + do_stg

        # the conds stacked along the batch: [negative | text | perturbed]
        prompt_embeds = prompt_embeds.to(dev, dtype)
        prompt_mask = prompt_attention_mask.to(dev)
        embed_parts, mask_parts = [prompt_embeds], [prompt_mask]
        if do_cfg:
            neg = (torch.zeros_like(prompt_embeds) if negative_prompt_embeds is None
                   else negative_prompt_embeds.to(dev, dtype))
            neg_mask = (torch.zeros_like(prompt_mask)
                        if negative_prompt_attention_mask is None
                        else negative_prompt_attention_mask.to(dev))
            embed_parts.insert(0, neg)
            mask_parts.insert(0, neg_mask.to(prompt_mask.dtype))
        if do_stg:
            embed_parts.append(prompt_embeds)
            mask_parts.append(prompt_mask)
        prompt_embeds_b = torch.cat(embed_parts)
        prompt_mask_b = torch.cat(mask_parts)

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

        skip_layer_mask = None
        if do_stg and p.skip_block_list:
            def skip_mask(block_list):
                return create_skip_layer_mask(
                    self.dit_cfg.num_layers, b, num_conds, num_conds - 1,
                    block_list, device=dev)

            sbl = p.skip_block_list
            if isinstance(sbl[0], (list, tuple)):
                # per-timestep block lists, mapped like the guidance scales
                if not p.guidance_timesteps:
                    raise ValueError(
                        "per-timestep skip_block_list requires guidance_timesteps")
                ident = torch.ones((self.dit_cfg.num_layers, b * num_conds),
                                   dtype=torch.float32, device=dev)
                masks = [skip_mask(sbl[m])
                         for m in _guidance_mapping(timesteps, p.guidance_timesteps)]
                skip_layer_mask = torch.stack(
                    [ident if m is None else m for m in masks])
            else:
                skip_layer_mask = skip_mask(sbl)

        if step_noise is not None:
            step_noise = step_noise.to(dev, dtype)
        final_tokens = self.denoise(
            tokens, _tile(fractional, num_conds), prompt_embeds_b, prompt_mask_b,
            sigmas, ref_lat, pose_lat, guidance=guidance, stg=stg, rescale=rescale,
            cfg_star=p.cfg_star_rescale, skip_layer_mask=skip_layer_mask,
            skip_layer_strategy=p.skip_layer_strategy, solver=p.solver,
            stochastic=p.stochastic_sampling, generator=generator,
            step_noise=step_noise)
        latents = unpatchify(final_tokens, lat_f, lat_h, lat_w, self.patch_size)
        t0 = mark("denoise_s", t0)
        if output_type == "latent":
            return latents
        out = self.decode_latents(latents, p, generator, decode_noise, output_type)
        mark("decode_s", t0)
        return out
