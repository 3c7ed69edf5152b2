"""Avatar video generation pipeline (port of
``avatar_tpu/pipelines/pipeline.py``).

VAE-encode the reference image and pose frames, draw the initial noise
(or noise ``latents`` / encoded ``media_items`` to the first timestep),
place the conditioning items, precompute the RoPE tables, the caption k/v
and (without conditioning items) the AdaLN tables once, run the denoising
walk over ``dit_apply`` with the avatar lerp, then decode with decode-time
noise and timestep conditioning. The walk takes classifier-free guidance
(with ``cfg_star_rescale``), STG with the std rescale, per-step guidance
lists, the Euler or Heun solver, stochastic sampling, skipped initial and
final steps, and the conditioning items' per-token timesteps
``min(t, 1 - mask)`` with ``image_cond_noise_scale``.

``torch`` cannot reproduce ``jax.random``: every random draw comes from the
caller's ``torch.Generator`` unless it is handed in as a tensor
(``ref_noise``, ``pose_noise``, ``media_noise``, ``init_noise``,
``item_noise`` and ``prefix_noise`` per conditioning item,
``image_cond_noise`` and ``step_noise`` per step, ``decode_noise``).

Over several devices (one process each, ``parallel/``): ``sp_mesh`` shards
the denoiser's tokens (``dit_apply_sp``), ``pp_mesh`` its blocks over
pipeline stages (``dit_apply_pp``), ``dp_mesh`` the batch: each rank
encodes, denoises and decodes its rows and the outputs are all-gathered,
so every rank returns the whole batch. Under ``dp_mesh`` each draw from
the generator is made at the whole batch's shape and each rank takes its
rows, so a sample's draws are those of the one-device run (the VAE
decoder's own noise injection, where a VAE has it, draws per rank).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

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
from avatar_tpu_torch.parallel.collectives import all_gather_plain, chunk_of
from avatar_tpu_torch.parallel.mesh import map_with_path
from avatar_tpu_torch.utils.profiling import annotate, recording
from avatar_tpu_torch.utils.quantize import quantize_dit_params, quantize_vae_params

OUTPUT_TYPES = ("latent", "np", "uint8", "yuv420")
T_EPS = 1e-6


@dataclass
class ConditioningItem:
    """A frame or sequence conditioning item (same fields as the JAX
    package's). ``media_item``: [B, F, H, W, 3] channels-last pixels in
    [-1, 1], F = 8k + 1. At ``media_frame_number`` 0 its latents replace the
    first latent frames (at ``media_x``/``media_y`` in pixels, else
    centred); elsewhere its first two latent frames ride along as extra
    tokens and the rest replace the frames from ``media_frame_number`` on.
    ``conditioning_strength`` 1 pins them; below 1 they are a lerp."""

    media_item: torch.Tensor
    media_frame_number: int = 0
    conditioning_strength: float = 1.0
    media_x: Optional[int] = None
    media_y: Optional[int] = None


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


def adain_filter_latent(latents: torch.Tensor, reference_latents: torch.Tensor,
                        factor: float = 1.0) -> torch.Tensor:
    """Per-(batch, channel) AdaIN of [B, F, H, W, C] latents toward the
    reference's mean and std (unbiased) over (F, H, W), blended by
    ``factor``."""
    dims = (1, 2, 3)
    r_mean = reference_latents.mean(dim=dims, keepdim=True)
    r_std = reference_latents.std(dim=dims, keepdim=True, correction=1)
    i_mean = latents.mean(dim=dims, keepdim=True)
    i_std = latents.std(dim=dims, keepdim=True, correction=1)
    result = (latents - i_mean) / i_std * r_std + r_mean
    return latents + factor * (result - latents)


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


def _per_item(noise, n: int) -> list:
    """A per-item list of optional noise tensors (None: draw each)."""
    if noise is None:
        return [None] * n
    if len(noise) != n:
        raise ValueError(f"{len(noise)} noise tensors for {n} conditioning items")
    return list(noise)


def resize_media(media: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of [B, F, H, W, C] frames to (height, width), with
    the antialiasing filter when shrinking, as ``jax.image.resize(...,
    "bilinear")`` computes it."""
    b, f, h, w, c = media.shape
    x = media.reshape(b * f, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).reshape(b, f, height, width, c)


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
    permutation and the stacking; ``quantize_vae`` (any true value, e.g.
    "w8a8") makes the VAE's large 3D convolutions W8A8
    (``quantize_vae_params``: int8 activation levels per tensor, int8
    weights per output channel in kernel L's layout, kernel L on the
    card);
    ``scan_blocks`` keeps the transformer blocks stacked on a leading
    layer axis, the layout the JAX package scans over (here walked by the
    same Python loop, slice by slice); ``allowed_inference_steps``, if
    given, lists the only timesteps (rounded to 4 decimals) a run may
    visit; ``text_encoder`` is kept as ``self.text_encoder`` and not read
    here (the caller encodes prompts). ``sp_mesh`` / ``sp_axis`` /
    ``sp_impl``, ``dp_mesh`` / ``dp_axis`` and ``pp_mesh`` / ``pp_axis`` /
    ``pp_microbatches``: the multi-device modes (module docstring; every
    rank of the mesh builds the pipeline and makes the same calls); a
    ``pp_mesh`` pipeline keeps only its stage's blocks. The parameters up
    to ``pp_microbatches`` take the JAX pipeline's positional order;
    ``scan_blocks`` and ``device`` are keyword-only."""

    def __init__(
        self,
        dit_cfg: DiTConfig,
        dit_params: dict,
        vae_cfg: VAEConfig,
        vae_params: dict,
        schedule: Optional[RectifiedFlowSchedule] = None,
        text_encoder=None,
        patch_size: int = 1,
        attention_impl: str = "auto",
        allowed_inference_steps: Optional[List[float]] = None,
        quantize_weights: Union[bool, str] = False,
        quantize_vae: Union[bool, str] = False,
        rope_split: bool = True,
        sp_mesh=None,
        sp_axis: str = "sp",
        sp_impl: str = "ulysses",
        dp_mesh=None,
        dp_axis: str = "data",
        pp_mesh=None,
        pp_axis: str = "pp",
        pp_microbatches: Optional[int] = None,
        *,
        scan_blocks: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        if pp_mesh is not None:
            assert sp_mesh is None and dp_mesh is None, (
                "pp_mesh composes with a 'data' axis in the same mesh, not with "
                "sp_mesh/dp_mesh")
        if scan_blocks and pp_mesh is None:
            assert sp_mesh is None, (
                "scan_blocks composes with dp_mesh but not sp_mesh (the "
                "sequence-parallel denoiser manages its own block schedule)")
        self.sp_mesh, self.sp_axis, self.sp_impl = sp_mesh, sp_axis, sp_impl
        self.dp_mesh, self.dp_axis = dp_mesh, dp_axis
        self.pp_mesh, self.pp_axis, self.pp_microbatches = pp_mesh, pp_axis, pp_microbatches
        self._dp = None if dp_mesh is None else dp_mesh.group(dp_axis)
        self.text_encoder = text_encoder
        self.allowed_inference_steps = allowed_inference_steps
        self.dit_cfg = dit_cfg
        self.attention_impl = attention_impl
        self.rope_split = rope_split
        self.scan_blocks = scan_blocks
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
        if scan_blocks or pp_mesh is not None:
            blocks = stack_block_params(dit_params["blocks"])
            if pp_mesh is not None:
                # this stage's L/S blocks only (pp_param_sharding's shard)
                pg = pp_mesh.group(pp_axis)
                blocks = map_with_path(lambda _, t: chunk_of(t, pg, 0).contiguous(), blocks)
            dit_params = dict(dit_params, blocks=blocks)
        self.dit_params = dit_params
        self.vae_cfg = vae_cfg
        if quantize_vae:
            vae_params = quantize_vae_params(vae_params)
        self.vae_params = vae_params
        self.schedule = schedule or RectifiedFlowSchedule.create(
            sampler="Uniform", shifting="SD3", target_shift_terminal=0.1)
        self.patch_size = patch_size
        self.video_scale_factor = vae_cfg.temporal_downscale_factor
        self.vae_scale_factor = vae_cfg.spatial_downscale_factor

    # -- pieces -------------------------------------------------------------

    def _randn(self, shape, generator) -> torch.Tensor:
        """A standard normal f32 draw of ``shape`` from ``generator``; under
        ``dp_mesh`` this rank's rows of the whole batch's draw."""
        if self._dp is None:
            return torch.randn(tuple(shape), generator=generator, device=self.device,
                               dtype=torch.float32)
        full = torch.randn((shape[0] * self._dp.size,) + tuple(shape[1:]),
                           generator=generator, device=self.device, dtype=torch.float32)
        return chunk_of(full, self._dp, 0)

    def encode_media(self, media, generator, noise=None,
                     per_channel_normalize=True) -> torch.Tensor:
        if noise is not None:
            noise = noise.to(self.device)
        return vae_encode(self.vae_params, self.vae_cfg, media.to(self.device),
                          generator=generator, noise=noise,
                          per_channel_normalize=per_channel_normalize)

    def _encode_rows(self, media, generator, noise=None,
                     per_channel_normalize=True) -> torch.Tensor:
        """:meth:`encode_media` inside a generation, whose ``media`` under
        ``dp_mesh`` are this rank's rows: the posterior draw is made at the
        whole batch's shape and this rank's rows taken."""
        if noise is None and self._dp is not None:
            b, f, h, w = media.shape[:4]
            noise = self._randn((b, (f - 1) // self.video_scale_factor + 1,
                                 h // self.vae_scale_factor, w // self.vae_scale_factor,
                                 self.vae_cfg.latent_channels), generator)
        return self.encode_media(media, generator, noise, per_channel_normalize)

    def prepare_latents(self, generator, latent_shape, dtype,
                        noise: Optional[torch.Tensor] = None,
                        latents: Optional[torch.Tensor] = None,
                        media_items: Optional[torch.Tensor] = None,
                        timestep: float = 1.0, per_channel_normalize: bool = True,
                        media_noise: Optional[torch.Tensor] = None,
                        sample_seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Initial latents [B, F, H, W, C]: noise, or ``latents`` (or the
        encoded ``media_items``, with ``media_noise`` as the encoder's draw)
        noised to ``timestep``: t * noise + (1 - t) * latents. The noise is
        ``noise`` or drawn per sample from a generator seeded with
        ``sample_seeds[i]`` (one seed per sample: a server's per-request
        seeds, so that a request's noise depends only on its own seed) or,
        without them, with a seed drawn from ``generator``; either way sample
        i's noise does not depend on the batch size."""
        if latents is not None and media_items is not None:
            raise ValueError("give latents or media_items, not both")
        if media_items is not None:
            latents = self._encode_rows(media_items.to(dtype), generator, media_noise,
                                        per_channel_normalize)
        if noise is not None:
            if tuple(noise.shape) != tuple(latent_shape):
                raise ValueError(f"init noise {tuple(noise.shape)} != {latent_shape}")
            noise = noise.to(self.device, dtype)
        else:
            if sample_seeds is None:
                n = latent_shape[0] * (1 if self._dp is None else self._dp.size)
                seeds = torch.randint(0, 2**62, (n,), generator=generator,
                                      device=generator.device)
                seeds = (seeds if self._dp is None else chunk_of(seeds, self._dp, 0)).tolist()
            else:
                seeds = [int(s) for s in sample_seeds]
            if len(seeds) != latent_shape[0]:
                raise ValueError(f"{len(seeds)} sample_seeds for a batch of {latent_shape[0]}")
            out = []
            for seed in seeds:
                g = torch.Generator(device=self.device)
                g.manual_seed(seed)
                out.append(torch.randn(latent_shape[1:], generator=g,
                                       device=self.device, dtype=torch.float32))
            noise = torch.stack(out).to(dtype)
        if latents is None:
            return noise
        if tuple(latents.shape) != tuple(latent_shape):
            raise ValueError(f"latents {tuple(latents.shape)} != {latent_shape}")
        return timestep * noise + (1 - timestep) * latents.to(self.device, dtype)

    def prepare_conditioning(self, conditioning_items: Optional[Sequence["ConditioningItem"]],
                             init_latents: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             per_channel_normalize: bool = True,
                             item_noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
                             prefix_noise: Optional[Sequence[Optional[torch.Tensor]]] = None):
        """(tokens [B, N, C], pixel coords [B, 3, N], conditioning mask
        [B, N] f32 or None, number of extra prefix tokens).

        Each item is resized to the frame size (unless it is placed at
        ``media_x``/``media_y``) and VAE-encoded (``item_noise[i]``: the
        encoder's draw). A first-frame item lerps its latents into the
        first latent frames, centred or at its offset, after stripping the
        latent border rows and columns that do not meet the frame's border;
        its region of the mask gets its strength. A later item lerps its
        frames after the first two into the frames from its frame number
        on, and its first two latent frames, lerped from noise
        (``prefix_noise[i]``) by its strength, go first as extra tokens
        whose time coordinate is shifted by its frame number.
        """
        b, f_l, h_l, w_l, _ = init_latents.shape
        scale_factors = (self.video_scale_factor, self.vae_scale_factor,
                         self.vae_scale_factor)
        if not conditioning_items:
            tokens, coords = patchify(init_latents, self.patch_size)
            return tokens, latent_to_pixel_coords(coords, scale_factors), None, 0
        item_noise = _per_item(item_noise, len(conditioning_items))
        prefix_noise = _per_item(prefix_noise, len(conditioning_items))
        dev, dtype = init_latents.device, init_latents.dtype
        init_latents = init_latents.clone()
        init_mask = torch.zeros((b, f_l, h_l, w_l), dtype=torch.float32, device=dev)
        extra_tokens, extra_coords, extra_masks = [], [], []
        scale = self.vae_scale_factor
        height, width = h_l * scale, w_l * scale
        for item, enc_noise, pre_noise in zip(conditioning_items, item_noise, prefix_noise):
            if not isinstance(item, ConditioningItem):
                raise TypeError(f"conditioning_items takes ConditioningItem, got {type(item)}")
            media = item.media_item.to(dev)
            frame_no, strength = item.media_frame_number, item.conditioning_strength
            has_position = item.media_x is not None or item.media_y is not None
            if not has_position and tuple(media.shape[2:4]) != (height, width):
                media = resize_media(media.float(), height, width)
            if media.ndim != 5 or media.shape[1] % 8 != 1:
                raise ValueError(f"conditioning media {tuple(media.shape)}: expected "
                                 "[B, 8k + 1, H, W, 3]")
            lat = self._encode_rows(media.to(dtype), generator, enc_noise,
                                    per_channel_normalize).to(dtype)
            if frame_no == 0:
                h_m, w_m = media.shape[2:4]
                if h_m > height or w_m > width or h_m % scale or w_m % scale:
                    raise ValueError(f"conditioning media {h_m}x{w_m} must fit "
                                     f"{height}x{width} in multiples of {scale}")
                x_start = (width - w_m) // 2 if item.media_x is None else item.media_x
                y_start = (height - h_m) // 2 if item.media_y is None else item.media_y
                x_end, y_end = x_start + w_m, y_start + h_m
                if x_end > width or y_end > height:
                    raise ValueError(f"conditioning {x_start}:{x_end}x{y_start}:{y_end} "
                                     f"out of bounds for {width}x{height}")
                # strip the latent border that does not meet the frame's border
                if x_start > 0:
                    x_start += scale
                    lat = lat[:, :, :, 1:]
                if y_start > 0:
                    y_start += scale
                    lat = lat[:, :, 1:]
                if x_end < width:
                    lat = lat[:, :, :, :-1]
                if y_end < height:
                    lat = lat[:, :, :-1]
                l_x, l_y = x_start // scale, y_start // scale
                fl, hl_m, wl_m = lat.shape[1:4]
                region = (slice(None), slice(0, fl), slice(l_y, l_y + hl_m),
                          slice(l_x, l_x + wl_m))
                init_latents[region] = init_latents[region] + strength * (
                    lat - init_latents[region])
                init_mask[region] = strength
                continue
            # a later sequence: lerp the frames after its two-frame prefix in
            # place, pass the prefix on as extra tokens
            if lat.shape[1] > 1:
                f_prefix = 2
                if frame_no % self.video_scale_factor:
                    raise ValueError(f"media_frame_number {frame_no} is not a multiple "
                                     f"of {self.video_scale_factor}")
                start = frame_no // self.video_scale_factor + f_prefix
                end = start + lat.shape[1] - f_prefix
                if lat.shape[1] > f_prefix:
                    init_latents[:, start:end] = init_latents[:, start:end] + strength * (
                        lat[:, f_prefix:] - init_latents[:, start:end])
                    init_mask[:, start:end] = strength
                lat = lat[:, :f_prefix]
            if pre_noise is None:
                pre_noise = self._randn(lat.shape, generator)
            pre_noise = pre_noise.to(dev, dtype)
            lat = pre_noise + strength * (lat - pre_noise)
            tok, coords = patchify(lat, self.patch_size)
            pix = latent_to_pixel_coords(coords, scale_factors)
            pix[:, 0] += frame_no
            extra_tokens.append(tok)
            extra_coords.append(pix)
            extra_masks.append(torch.full(tok.shape[:2], strength, dtype=torch.float32,
                                          device=dev))
        tokens, coords = patchify(init_latents, self.patch_size)
        pixel_coords = latent_to_pixel_coords(coords, scale_factors)
        mask = patchify(init_mask[..., None], self.patch_size)[0][..., 0]
        num_extra = sum(t.shape[1] for t in extra_tokens)
        if extra_tokens:
            tokens = torch.cat(extra_tokens + [tokens], dim=1)
            pixel_coords = torch.cat(extra_coords + [pixel_coords], dim=2)
            mask = torch.cat(extra_masks + [mask], dim=1)
        return tokens, pixel_coords, mask, num_extra

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
                step_noise: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None,
                image_cond_noise_scale: float = 0.0,
                image_cond_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
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

        ``cond_mask`` [B, N] (conditioning items): each token runs at its
        own timestep min(t, 1 - mask), computed in f32 inside the model (no
        AdaLN tables), and keeps its value wherever t - 1e-6 is not below
        1 - mask. With ``image_cond_noise_scale`` > 0 the fully conditioned
        tokens (mask > 1 - 1e-6) restart each step from ``tokens`` plus
        scale * t^2 times fresh noise (``image_cond_noise[i]`` or a draw
        from ``generator``).
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

        with annotate("dit.precompute"):
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
            if cond_mask is None:
                ada_table, emb_table = precompute_timestep_tables(
                    params, cfg, sigmas_ext, prompt_embeds.shape[0], dtype=dtype)
            else:
                cond_mask = cond_mask.to(self.device, torch.float32)
                free_t = 1.0 - cond_mask
        mask = prompt_mask.to(torch.float32).contiguous()
        ref_b, pose_b = _tile(ref_lat, num_conds), _tile(pose_lat, num_conds)

        def token_t(level):
            """The timestep rf_step and the model see at ``sigmas_ext[level]``:
            the level, or per token min(level, 1 - cond_mask)."""
            t = sigmas_ext[level]
            return t if cond_mask is None else torch.minimum(t, free_t)

        def guided_velocity(lat, i, level):
            """The guided velocity at noise level ``sigmas_ext[level]`` with
            step i's guidance scales and skip mask."""
            latent_in = _tile(lat, num_conds)
            if ref_b is not None:
                latent_in = avatar_condition_tokens(latent_in, ref_b, pose_b)
            step_mask = skip_layer_mask
            if step_mask is not None and step_mask.ndim == 3:
                step_mask = step_mask[i]
            if cond_mask is None:
                timing = dict(timestep_tables=(ada_table[level], emb_table[level]))
            else:
                timing = dict(timestep=_tile(token_t(level), num_conds))
            pred = self._velocity(
                params, latent_in, encoder_attention_mask=mask,
                skip_layer_mask=step_mask, skip_layer_strategy=skip_layer_strategy,
                attention_impl=self.attention_impl, freqs_cis=freqs,
                rope_split=self.rope_split, cross_kv=cross_kv, **timing,
            ).to(dtype)
            if num_conds == 1:
                return pred
            # the rescale applies where this step has STG on and a scale != 1
            rs = float(rescale[i]) if stg[i] > 0.0 and rescale[i] != 1.0 else None
            return combine_guidance(pred.chunk(num_conds), do_cfg, do_stg, g_dev[i],
                                    sg_dev[i], rs, cfg_star)

        def pin(new, old, t):
            """Tokens whose 1 - mask is not above t - 1e-6 keep ``old``."""
            if cond_mask is None:
                return new
            return torch.where((t - T_EPS < free_t)[..., None], new, old)

        noisy_cond = cond_mask is not None and image_cond_noise_scale > 0.0
        if noisy_cond:
            pinned = (cond_mask > 1.0 - T_EPS)[..., None]
            if image_cond_noise is not None and (
                    tuple(image_cond_noise.shape) != (steps, *tokens.shape)):
                raise ValueError(
                    f"image_cond_noise {tuple(image_cond_noise.shape)}: one draw of "
                    f"{tuple(tokens.shape)} per step for image_cond_noise_scale > 0")
        latents = tokens
        for i in range(steps):
            with annotate("pipe.step"):
                t = sigmas[i]
                if noisy_cond:
                    if image_cond_noise is None:
                        noise = self._randn(latents.shape, generator)
                    else:
                        noise = image_cond_noise[i]
                    noise_scale = (image_cond_noise_scale * t**2).to(dtype)
                    latents = torch.where(pinned, tokens + noise_scale * noise.to(dtype),
                                          latents)
                pred = guided_velocity(latents, i, i)
                t_tok = token_t(i)
                if solver == "heun" and i + 1 < steps:
                    # Euler predictor to the next level, then the trapezoidal
                    # corrector; rf_step is linear in the velocity, so the Heun
                    # update is rf_step on the averaged velocity
                    with annotate("pipe.rf_step"):
                        predicted = pin(rf_step(sigmas, pred, t_tok, latents), latents, t)
                    pred = 0.5 * (pred + guided_velocity(predicted, i, i + 1))
                noise = None if step_noise is None else step_noise[i]
                if noise is None and stochastic and self._dp is not None:
                    noise = self._randn(latents.shape, generator)
                with annotate("pipe.rf_step"):
                    latents = pin(rf_step(
                        sigmas, pred, t_tok, latents, stochastic_sampling=stochastic,
                        generator=generator, noise=noise), latents, t)
        return latents

    def _velocity(self, params, latent_in, **kw) -> torch.Tensor:
        """The DiT on the walk's input: ``dit_apply``, or under ``pp_mesh``
        / ``sp_mesh`` its pipeline- / sequence-parallel form (the whole
        output on every rank)."""
        cfg = self.dit_cfg
        if self.pp_mesh is not None:
            from avatar_tpu_torch.parallel.pipeline import dit_apply_pp

            return dit_apply_pp(
                params, cfg, latent_in, None, kw.pop("timestep", None), mesh=self.pp_mesh,
                axis=self.pp_axis, num_microbatches=self.pp_microbatches,
                data_axis="data" if "data" in self.pp_mesh.shape else None, **kw)
        if self.sp_mesh is not None:
            from avatar_tpu_torch.parallel.sequence import dit_apply_sp

            return dit_apply_sp(
                params, cfg, latent_in, None, kw.pop("timestep", None), mesh=self.sp_mesh,
                axis=self.sp_axis, sp_impl=self.sp_impl, **kw)
        return dit_apply(params, cfg, latent_in, **kw)

    def decode_latents(self, latents, p: GenerationParams, generator=None,
                       noise: Optional[torch.Tensor] = None,
                       output_type: str = "np") -> torch.Tensor:
        """Decode-time noise and timestep conditioning, tone map, VAE decode
        and the output quantization."""
        with annotate("pipe.decode"):
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
                    noise = self._randn(latents.shape, generator)
                noise = noise.to(self.device, latents.dtype)
                scale = torch.tensor(dns, dtype=torch.float32, device=self.device)
                scale = scale.reshape(-1, 1, 1, 1, 1).to(latents.dtype)
                latents = latents * (1 - scale) + noise * scale
                timestep = torch.tensor(dt, dtype=torch.float32, device=self.device)
            latents = tone_map_latents(latents, float(p.tone_map_compression_ratio))
            images = vae_decode(self.vae_params, self.vae_cfg, latents,
                                timestep=timestep,
                                per_channel_normalize=p.vae_per_channel_normalize)
        with annotate("pipe.output"):
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
        latents: Optional[torch.Tensor] = None,  # [B, F', H', W', C]
        media_items: Optional[torch.Tensor] = None,  # [B, F, H, W, 3]
        conditioning_items: Optional[Sequence[ConditioningItem]] = None,
        ref_image: Optional[torch.Tensor] = None,  # [B, 1, H, W, 3]
        pose_frames: Optional[torch.Tensor] = None,  # [B, F, H, W, 3]
        ref_latents: Optional[torch.Tensor] = None,  # [B, 1, h, w, C]
        pose_latents: Optional[torch.Tensor] = None,  # [B, f, h, w, C]
        output_type: str = "np",
        dtype: torch.dtype = torch.bfloat16,
        ref_noise: Optional[torch.Tensor] = None,
        pose_noise: Optional[torch.Tensor] = None,
        media_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
        item_noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        prefix_noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        image_cond_noise: Optional[torch.Tensor] = None,  # [steps, B, N, C]
        step_noise: Optional[torch.Tensor] = None,  # [steps, B, N, C]
        decode_noise: Optional[torch.Tensor] = None,
        stage_times: Optional[Dict[str, float]] = None,
        sample_seeds: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Generate one batch. ``output_type``: "latent" (denoised latents
        [B, F', H', W', C]), "np" (float frames [B, F, H, W, 3] in [0, 1]),
        "uint8" or "yuv420" (I420 planes [B, F, H*3/2, W]); all returned as
        tensors on the device. Absent negative prompt embeds are zeros with
        an all-zero mask. ``latents`` or ``media_items`` (pixels in [-1, 1])
        start the walk from those latents noised to its first timestep,
        which ``skip_initial_inference_steps`` moves later; neither may come
        with the other. ``stage_times``, if given, receives the seconds of
        the encode, denoise and decode stages (``encode_s``, ``denoise_s``,
        ``decode_s``; each ends in a device synchronize), and the call runs
        under ``utils/profiling.py:recording``, whose :meth:`Recording.flat`
        keys it also receives: each span's host seconds, self seconds and
        calls, and the kernel launches (the recording adds no synchronize;
        it cannot open inside another). ``sample_seeds`` ([B] ints) seed
        each sample's initial noise (see :meth:`prepare_latents`). Under ``dp_mesh`` each
        rank generates its rows of the batch (a multiple of the axis) and
        every rank returns the whole batch."""
        kw = dict(locals())
        kw.pop("self")
        dg = self._dp
        if dg is None:
            return self._generate(**kw)
        b = prompt_embeds.shape[0]
        assert b % dg.size == 0, (
            f"dp_mesh: batch {b} must be a multiple of the '{self.dp_axis}' axis size "
            f"{dg.size} (the serving layer pads)")

        def rows(x, dim=0):
            return None if x is None else chunk_of(x, dg, dim)

        for name in ("prompt_embeds", "prompt_attention_mask", "negative_prompt_embeds",
                     "negative_prompt_attention_mask", "latents", "media_items",
                     "ref_image", "pose_frames", "ref_latents", "pose_latents", "ref_noise",
                     "pose_noise", "media_noise", "init_noise", "decode_noise"):
            kw[name] = rows(kw[name])
        for name in ("image_cond_noise", "step_noise"):
            kw[name] = rows(kw[name], 1)
        for name in ("item_noise", "prefix_noise"):
            if kw[name] is not None:
                kw[name] = [rows(x) for x in kw[name]]
        if conditioning_items:
            kw["conditioning_items"] = [dataclasses.replace(it, media_item=rows(it.media_item))
                                        for it in conditioning_items]
        if sample_seeds is not None:
            per = b // dg.size
            kw["sample_seeds"] = list(sample_seeds)[dg.index * per:(dg.index + 1) * per]
        return all_gather_plain(self._generate(**kw), dg, 0)

    def _generate(
        self,
        params: GenerationParams,
        generator: torch.Generator,
        prompt_embeds: torch.Tensor,  # [B, L, caption_channels]
        prompt_attention_mask: torch.Tensor,  # [B, L]
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_attention_mask: Optional[torch.Tensor] = None,
        latents: Optional[torch.Tensor] = None,  # [B, F', H', W', C]
        media_items: Optional[torch.Tensor] = None,  # [B, F, H, W, 3]
        conditioning_items: Optional[Sequence[ConditioningItem]] = None,
        ref_image: Optional[torch.Tensor] = None,  # [B, 1, H, W, 3]
        pose_frames: Optional[torch.Tensor] = None,  # [B, F, H, W, 3]
        ref_latents: Optional[torch.Tensor] = None,  # [B, 1, h, w, C]
        pose_latents: Optional[torch.Tensor] = None,  # [B, f, h, w, C]
        output_type: str = "np",
        dtype: torch.dtype = torch.bfloat16,
        ref_noise: Optional[torch.Tensor] = None,
        pose_noise: Optional[torch.Tensor] = None,
        media_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
        item_noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        prefix_noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        image_cond_noise: Optional[torch.Tensor] = None,  # [steps, B, N, C]
        step_noise: Optional[torch.Tensor] = None,  # [steps, B, N, C]
        decode_noise: Optional[torch.Tensor] = None,
        stage_times: Optional[Dict[str, float]] = None,
        sample_seeds: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """:meth:`__call__` on this rank's rows."""
        p = params
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
        if p.skip_initial_inference_steps and latents is None and media_items is None:
            raise ValueError("skip_initial_inference_steps requires media_items or latents")
        timesteps = timesteps[p.skip_initial_inference_steps:
                              len(timesteps) - p.skip_final_inference_steps]
        if self.allowed_inference_steps is not None:
            for t in np.round(timesteps, 4):
                if t not in self.allowed_inference_steps:
                    raise ValueError(f"Invalid inference timestep {t}")
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
        # with stage_times, the call's spans and launches go there too
        spans = contextlib.nullcontext() if stage_times is None else recording()
        with spans as rec:
            with annotate("pipe.encode"):
                if ref_image is not None:
                    ref_lat = self._encode_rows(ref_image.to(dtype), generator, ref_noise, pcn)
                if pose_frames is not None:
                    pose_lat = self._encode_rows(pose_frames.to(dtype), generator,
                                                 pose_noise, pcn)
            if ref_lat is None or pose_lat is None:
                # the avatar lerp needs both; with one, the JAX package encodes
                # it and runs without the lerp, and so does the port
                ref_lat = pose_lat = None
            t0 = mark("encode_s", t0)

            with annotate("pipe.prepare"):
                init = self.prepare_latents(
                    generator, latent_shape, dtype, init_noise, latents=latents,
                    media_items=media_items, timestep=float(timesteps[0]),
                    per_channel_normalize=pcn, media_noise=media_noise,
                    sample_seeds=sample_seeds)
                tokens, pixel_coords, cond_mask, num_cond_latents = self.prepare_conditioning(
                    conditioning_items, init, generator, pcn, item_noise, prefix_noise)
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
                if image_cond_noise is not None:
                    image_cond_noise = image_cond_noise.to(dev, dtype)
            final_tokens = self.denoise(
                tokens, _tile(fractional, num_conds), prompt_embeds_b, prompt_mask_b,
                sigmas, ref_lat, pose_lat, guidance=guidance, stg=stg, rescale=rescale,
                cfg_star=p.cfg_star_rescale, skip_layer_mask=skip_layer_mask,
                skip_layer_strategy=p.skip_layer_strategy, solver=p.solver,
                stochastic=p.stochastic_sampling, generator=generator,
                step_noise=step_noise, cond_mask=cond_mask,
                image_cond_noise_scale=p.image_cond_noise_scale,
                image_cond_noise=image_cond_noise)
            # the sequence items' prefix tokens go first; they are not output
            final_tokens = final_tokens[:, num_cond_latents:]
            latents = unpatchify(final_tokens, lat_f, lat_h, lat_w, self.patch_size)
            t0 = mark("denoise_s", t0)
            if output_type == "latent":
                out = latents
            else:
                out = self.decode_latents(latents, p, generator, decode_noise, output_type)
                mark("decode_s", t0)
        if rec is not None:
            stage_times.update(rec.flat())
        return out
