"""The PyTorch port's pipeline against the JAX pipeline, end to end on the
CPU: a tiny DiT and VAE (as in tests/test_pipeline.py), reference image and
pose frames, 3 Euler steps, guidance 1, STG 0 (the guided walk is held to
the JAX package in tests/test_torch_guidance.py). The JAX side runs its Pallas
attention kernels in interpret mode; the port receives JAX's own random
draws (``jax.random.split(key, 6)`` as the JAX pipeline splits it) as
explicit noise tensors. Compared in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
from torch_parity import vae_numpy_params

torch.set_num_threads(2)

H = W = 64
FRAMES = 9
DIT_KW = dict(num_attention_heads=4, attention_head_dim=8, in_channels=8,
              out_channels=8, num_layers=2, cross_attention_dim=32,
              caption_channels=32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(**kw):
    base = dict(height=H, width=W, num_frames=FRAMES - 1, frame_rate=25.0,
                num_inference_steps=3, guidance_scale=1.0, stg_scale=0.0,
                rescaling_scale=1.0, decode_timestep=0.05)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def pipelines():
    jvcfg = dataclasses.replace(jvae.demo_config(latent_channels=8),
                                base_channels=32, decoder_base_channels=32)
    tvcfg = dataclasses.replace(tvae.demo_config(latent_channels=8),
                                base_channels=32, decoder_base_channels=32)
    jdcfg, tdcfg = jdit.DiTConfig(**DIT_KW), tdit.DiTConfig(**DIT_KW)
    vtree = vae_numpy_params(jvcfg)
    jdparams = jdit.init_dit(jax.random.PRNGKey(1), jdcfg)
    dtree = jax.tree.map(np.asarray, jdparams)
    jp = jpipe.LTXVideoPipeline(jdcfg, jdparams, jvcfg,
                                jax.tree.map(jnp.asarray, vtree),
                                attention_impl="flash")
    tp = tpipe.LTXVideoPipeline(
        tdcfg, dit_params_from_numpy(dtree, tdcfg, device="cpu"), tvcfg,
        vae_params_from_numpy(vtree, tvcfg, device="cpu"), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    mask[0, 6:] = 0.0
    ref = rng.uniform(-1, 1, (1, 1, H, W, 3)).astype(np.float32)
    pose = rng.uniform(-1, 1, (1, FRAMES, H, W, 3)).astype(np.float32)
    return embeds, mask, ref, pose


@pytest.fixture(scope="module")
def jax_run(pipelines, inputs):
    """JAX latents and uint8 frames, and JAX's draws as the port takes them."""
    jp, _ = pipelines
    embeds, mask, ref, pose = inputs
    key = jax.random.PRNGKey(3)
    p = jpipe.GenerationParams(**_params())
    latents = jp(p, key, embeds, mask, ref_image=ref, pose_frames=pose,
                 output_type="latent", dtype=jnp.float32)
    k_ref, k_pose, k_lat, _, _, k_dec = jax.random.split(key, 6)
    frames = jp.decode_latents(latents, p, key=k_dec, output_type="uint8")
    lat_hw = H // 32
    noise = {
        "ref_noise": jax.random.normal(k_ref, (1, 1, lat_hw, lat_hw, 8)),
        "pose_noise": jax.random.normal(k_pose, (1, 2, lat_hw, lat_hw, 8)),
        "init_noise": jax.random.normal(
            jax.random.split(k_lat, 1)[0], (2, lat_hw, lat_hw, 8))[None],
        "decode_noise": jax.random.normal(k_dec, latents.shape),
    }
    return np.asarray(latents), np.asarray(frames), {
        k: _t(v) for k, v in noise.items()}


def _port(pipelines, inputs, noise, output_type):
    _, tp = pipelines
    embeds, mask, ref, pose = inputs
    return tp(tpipe.GenerationParams(**_params()), torch.Generator(), _t(embeds),
              _t(mask), ref_image=_t(ref), pose_frames=_t(pose),
              output_type=output_type, dtype=torch.float32, **noise)


def test_latents_match_jax(pipelines, inputs, jax_run):
    ref_latents, _, noise = jax_run
    out = _port(pipelines, inputs, noise, "latent")
    assert out.shape == ref_latents.shape
    # f32 through two VAE encodes and 3 DiT steps: summation order only
    np.testing.assert_allclose(out.numpy(), ref_latents, atol=2e-4, rtol=2e-4)


def test_uint8_frames_match_jax(pipelines, inputs, jax_run):
    _, ref_frames, noise = jax_run
    out = _port(pipelines, inputs, noise, "uint8").numpy().astype(np.int32)
    assert out.shape == ref_frames.shape == (1, FRAMES, H, W, 3)
    # f32 pixels that agree to ~1e-5 can still fall on either side of a
    # quantization boundary (x*255 + 0.5 truncated): allow one level
    assert np.abs(out - ref_frames.astype(np.int32)).max() <= 1


def test_yuv420_output_shape(pipelines, inputs, jax_run):
    _, _, noise = jax_run
    out = _port(pipelines, inputs, noise, "yuv420")
    assert out.dtype == torch.uint8 and out.shape == (1, FRAMES, H * 3 // 2, W)


@pytest.mark.parametrize("setting", [
    dict(skip_initial_inference_steps=1), dict(image_cond_noise_scale=0.1),
    dict(latents=True), dict(media_items=True), dict(conditioning_items=True),
], ids=lambda s: next(iter(s)))
def test_unported_settings_raise(pipelines, inputs, setting):
    """Each of these inputs runs now (tests/test_torch_conditioning*.py);
    what the JAX package rejects for it, the port rejects and names:
    skipped initial steps without media_items or latents, latents of the
    wrong shape, latents and media_items together, a conditioning item
    that is not a ConditioningItem, and (the port's own tensor input)
    image-conditioning noise of the wrong shape."""
    _, tp = pipelines
    embeds, mask, _, ref = inputs
    name = next(iter(setting))
    lat = torch.zeros(1, 2, H // 32, W // 32, 8)
    call_kw, params = {}, {}
    if name == "skip_initial_inference_steps":
        params = setting
    elif name == "image_cond_noise_scale":
        params = setting
        call_kw = dict(conditioning_items=[tpipe.ConditioningItem(_t(ref))],
                       image_cond_noise=torch.zeros(2, 1, 8, 8))
    elif name == "latents":
        call_kw = dict(latents=_t(embeds))
    elif name == "media_items":
        call_kw = dict(latents=lat, media_items=torch.zeros(1, FRAMES, H, W, 3))
    else:
        call_kw = dict(conditioning_items=[object()])
    with pytest.raises((ValueError, TypeError), match=name):
        tp(tpipe.GenerationParams(**_params(**params)), torch.Generator(),
           _t(embeds), _t(mask), dtype=torch.float32, **call_kw)
