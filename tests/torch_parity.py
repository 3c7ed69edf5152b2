"""Helpers shared by the ``test_torch_*`` parity tests (not a test module)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.pipelines import pipeline as tpipe
from avatar_tpu_torch.utils.weight_import import (
    dit_params_from_numpy,
    vae_params_from_numpy,
)


def vae_numpy_params(cfg, seed: int = 7) -> dict:
    """JAX-layout VAE params with ``init_vae``'s tree and scales, filled
    from a numpy seed. ``jax.eval_shape`` gives the tree; an eager JAX init
    of a 2B-kind config takes tens of seconds on the CPU."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if shape == ():
            return np.float32(1000.0)  # the decoder's timestep multiplier
        if len(shape) in (2, 5) and "kernel" in name:  # linear / conv
            bound = np.sqrt(3.0 / np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if "std_of_means" in name or "scale'" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvae.init_vae(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def dit_numpy_params(cfg, seed: int = 5) -> dict:
    """JAX-layout DiT params with ``init_dit``'s tree, filled from a numpy
    seed at its scales (uniform +-sqrt(3 / fan_in) kernels, small biases,
    AdaLN tables of std inner^-0.5, unit norm scales); cheaper than the
    eager JAX init."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if "kernel" in name:
            bound = np.sqrt(3.0 / shape[0])
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if "scale_shift_table" in name:
            return (cfg.inner_dim**-0.5 * rng.standard_normal(shape)).astype(np.float32)
        if "norm" in name and "scale" in name:
            return np.ones(shape, np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jdit.init_dit(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _f32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# The guided denoising walk of both packages (tests/test_torch_guidance*.py)
# ---------------------------------------------------------------------------

H = W = 64
PIPE_DIT_KW = dict(num_attention_heads=4, attention_head_dim=8, in_channels=8,
                   out_channels=8, num_layers=2, cross_attention_dim=32,
                   caption_channels=32)
STEPS = 3
# f32 through 3 guided steps (5 model evaluations with Heun) of two blocks:
# the summation-order differences of a DiT call (a few 1e-6 at these
# widths) scaled by the guidance (3 to 4.5), the std ratio of the rescale
# and, for cfg_star, the projection coefficient; observed up to 1e-5
PIPE_ATOL = 1e-4


def guided_pipelines(**ctor):
    """Both pipelines with ``attention_impl="flash"`` unless ``ctor`` says
    otherwise: at these token counts "auto" keeps away from the head-major
    kernels on both sides (``supports`` wants Lq * Lk >= 128 * 128)."""
    ctor = {"attention_impl": "flash", **ctor}
    jvcfg = dataclasses.replace(jvae.demo_config(latent_channels=8),
                                base_channels=32, decoder_base_channels=32)
    tvcfg = dataclasses.replace(tvae.demo_config(latent_channels=8),
                                base_channels=32, decoder_base_channels=32)
    jdcfg, tdcfg = jdit.DiTConfig(**PIPE_DIT_KW), tdit.DiTConfig(**PIPE_DIT_KW)
    vtree = vae_numpy_params(jvcfg)
    jdparams = jdit.init_dit(jax.random.PRNGKey(1), jdcfg)
    dtree = jax.tree.map(np.asarray, jdparams)
    jp = jpipe.LTXVideoPipeline(jdcfg, jdparams, jvcfg,
                                jax.tree.map(jnp.asarray, vtree), **ctor)
    tp = tpipe.LTXVideoPipeline(
        tdcfg, dit_params_from_numpy(dtree, tdcfg, device="cpu"), tvcfg,
        vae_params_from_numpy(vtree, tvcfg, device="cpu"), device="cpu", **ctor)
    return jp, tp


def run_guided_walk(pipes, frames, settings, negative=False):
    """Latents of the JAX pipeline and of the port for the same settings,
    the port fed JAX's initial latents and per-step noise."""
    jp, tp = pipes
    rng = np.random.default_rng(0)
    lat_f, lat_hw = (frames - 1) // 8 + 1, H // 32
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    mask[0, 6:] = 0.0
    cond = dict(
        ref_latents=rng.standard_normal((1, 1, lat_hw, lat_hw, 8)).astype(np.float32),
        pose_latents=rng.standard_normal(
            (1, lat_f, lat_hw, lat_hw, 8)).astype(np.float32),
    )
    if negative:
        cond["negative_prompt_embeds"] = rng.standard_normal(
            (1, 8, 32)).astype(np.float32)
        cond["negative_prompt_attention_mask"] = np.ones((1, 8), np.float32)
    base = dict(height=H, width=W, num_frames=frames - 1, frame_rate=25.0,
                num_inference_steps=STEPS)
    jset = dict(settings)
    tset = dict(settings)
    if settings.get("skip_layer_strategy"):
        jset["skip_layer_strategy"] = jdit.SkipLayerStrategy[
            settings["skip_layer_strategy"]]
        tset["skip_layer_strategy"] = tdit.SkipLayerStrategy[
            settings["skip_layer_strategy"]]
    key = jax.random.PRNGKey(3)
    ref = jp(jpipe.GenerationParams(**base, **jset), key, embeds, mask, **cond,
             output_type="latent", dtype=jnp.float32)
    _, _, k_lat, _, k_loop, _ = jax.random.split(key, 6)
    n_tokens = lat_f * lat_hw * lat_hw
    init = jax.random.normal(jax.random.split(k_lat, 1)[0],
                             (lat_f, lat_hw, lat_hw, 8))[None]
    steps = STEPS - settings.get("skip_final_inference_steps", 0)
    step_noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(k_loop, 2 * i + 1),
                                     (1, n_tokens, 8))) for i in range(steps)])
    out = tp(tpipe.GenerationParams(**base, **tset), torch.Generator(), _f32(embeds),
             _f32(mask), **{k: _f32(v) for k, v in cond.items()}, init_noise=_f32(init),
             step_noise=_f32(step_noise), output_type="latent", dtype=torch.float32)
    return out.numpy(), np.asarray(ref)


SHIPPED = dict(guidance_scale=3.0, stg_scale=1.0, rescaling_scale=0.7,
               skip_block_list=[1], skip_layer_strategy="AttentionValues")


# ---------------------------------------------------------------------------
# Conditioning inputs (tests/test_torch_conditioning*.py)
# ---------------------------------------------------------------------------

COND_STEPS, COND_CH, COND_SCALE = STEPS, 8, 32


def cond_latent_shape(media_shape):
    b, f, h, w, _ = media_shape
    return (b, (f - 1) // 8 + 1, h // COND_SCALE, w // COND_SCALE, COND_CH)


def cond_media(seed, frames, size):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1, frames, size, size, 3)).astype(np.float32)


def run_conditioned(pipes, size, frames, items=(), settings=None, latents=None,
                    media_items=None):
    """Latents of the JAX pipeline and of the port (``guided_pipelines``)
    with conditioning inputs: ``items`` as (media, frame, strength, x, y),
    ``latents``, ``media_items``; ``settings`` may name a
    ``skip_layer_strategy`` by its name. The port is fed the JAX pipeline's
    draws, recomputed from its key splits: the initial noise, the media
    encoder's draw, each item's encoder draw and prefix noise, the per-step
    image-conditioning noise and, with ``stochastic_sampling``, the per-step
    sampling noise."""
    jp, tp = pipes
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    mask[0, 6:] = 0.0
    settings = dict(settings or {})
    p = dict(dict(height=size, width=size, num_frames=frames - 1, frame_rate=25.0,
                  num_inference_steps=COND_STEPS, guidance_scale=1.0, stg_scale=0.0,
                  rescaling_scale=1.0), **settings)
    jp_kw, tp_kw = dict(p), dict(p)
    if p.get("skip_layer_strategy"):
        jp_kw["skip_layer_strategy"] = jdit.SkipLayerStrategy[p["skip_layer_strategy"]]
        tp_kw["skip_layer_strategy"] = tdit.SkipLayerStrategy[p["skip_layer_strategy"]]
    key = jax.random.PRNGKey(3)
    jitems = [jpipe.ConditioningItem(jnp.asarray(m), f, s, x, y) for m, f, s, x, y in items]
    ref = jp(jpipe.GenerationParams(**jp_kw), key, embeds, mask,
             conditioning_items=jitems or None,
             latents=None if latents is None else jnp.asarray(latents),
             media_items=None if media_items is None else jnp.asarray(media_items),
             output_type="latent", dtype=jnp.float32)

    # the JAX pipeline's draws, from its key splits
    _, _, k_lat, k_cond, k_loop, _ = jax.random.split(key, 6)
    lat_shape = cond_latent_shape((1, frames, size, size, 3))
    draws = {}
    if media_items is not None:
        k_enc, k_lat = jax.random.split(k_lat)
        draws["media_noise"] = _f32(jax.random.normal(
            k_enc, cond_latent_shape(media_items.shape)))
    draws["init_noise"] = _f32(jax.random.normal(jax.random.split(k_lat, 1)[0],
                                               lat_shape[1:])[None])
    item_noise, prefix_noise, n_extra = [], [], 0
    for m, frame_no, _, x, y in items:
        k_enc, k_noise, k_cond = jax.random.split(k_cond, 3)
        enc_shape = cond_latent_shape(m.shape if x is not None or y is not None
                                      else (1, m.shape[1], size, size, 3))
        item_noise.append(_f32(jax.random.normal(k_enc, enc_shape)))
        if frame_no:
            pre = (1, min(enc_shape[1], 2)) + enc_shape[2:]
            prefix_noise.append(_f32(jax.random.normal(k_noise, pre)))
            n_extra += int(np.prod(pre[1:4]))
        else:
            prefix_noise.append(None)
    tokens = (1, n_extra + int(np.prod(lat_shape[1:4])), COND_CH)
    steps = COND_STEPS - settings.get("skip_initial_inference_steps", 0)
    if settings.get("image_cond_noise_scale"):
        draws["image_cond_noise"] = torch.stack([
            _f32(jax.random.normal(jax.random.fold_in(k_loop, 2 * i), tokens))
            for i in range(steps)])
    if settings.get("stochastic_sampling"):
        draws["step_noise"] = torch.stack([
            _f32(jax.random.normal(jax.random.fold_in(k_loop, 2 * i + 1), tokens))
            for i in range(steps)])
    titems = [tpipe.ConditioningItem(_f32(m), f, s, x, y) for m, f, s, x, y in items]
    out = tp(tpipe.GenerationParams(**tp_kw), torch.Generator(), _f32(embeds), _f32(mask),
             conditioning_items=titems or None,
             latents=None if latents is None else _f32(latents),
             media_items=None if media_items is None else _f32(media_items),
             item_noise=item_noise or None, prefix_noise=prefix_noise or None,
             output_type="latent", dtype=torch.float32, **draws)
    assert tuple(out.shape) == tuple(np.asarray(ref).shape) == lat_shape
    return out.numpy(), np.asarray(ref)
