"""The port's ``media_items`` and ``latents`` inputs (with
``skip_initial_inference_steps``) against the JAX ``LTXVideoPipeline`` on the
CPU, in f32, fed the JAX pipeline's draws (``torch_parity.run_conditioned``),
and the ``allowed_inference_steps`` check in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.pipelines import pipeline as tpipe
from torch_parity import (
    COND_CH,
    COND_STEPS,
    cond_latent_shape,
    cond_media,
    guided_pipelines,
    run_conditioned,
)

torch.set_num_threads(2)

# f32 through VAE encodes and 2 DiT steps of two blocks: summation order only
ATOL = RTOL = 2e-4
CH, STEPS = COND_CH, COND_STEPS


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def pipes():
    return guided_pipelines()


def test_media_items_with_skipped_initial_steps_match_jax(pipes):
    out, ref = run_conditioned(pipes, 64, 17, media_items=cond_media(5, 17, 64),
                               settings=dict(skip_initial_inference_steps=1))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_latents_input_matches_jax(pipes):
    latents = np.random.default_rng(6).standard_normal(
        cond_latent_shape((1, 17, 64, 64, 3))).astype(np.float32)
    out, ref = run_conditioned(pipes, 64, 17, latents=latents,
                               settings=dict(skip_initial_inference_steps=1))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_allowed_inference_steps(pipes):
    """A run whose schedule leaves the allowed timesteps fails in both
    packages (the JAX package asserts); one inside them runs."""
    jp, tp = pipes
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    p = dict(height=64, width=64, num_frames=8, num_inference_steps=STEPS,
             guidance_scale=1.0, stg_scale=0.0)
    jp.allowed_inference_steps = [0.5]
    try:
        with pytest.raises(AssertionError, match="Invalid inference timestep"):
            jp(jpipe.GenerationParams(**p), jax.random.PRNGKey(0), embeds, mask,
               output_type="latent", dtype=jnp.float32)
    finally:
        jp.allowed_inference_steps = None
    sched = tp.schedule.set_timesteps(num_inference_steps=STEPS,
                                      samples_shape=(1, CH, 2, 2, 2))
    allowed = [float(t) for t in np.round(np.asarray(sched.sigmas), 4)]
    for allow, ok in (([0.5], False), (allowed, True)):
        limited = tpipe.LTXVideoPipeline(
            tp.dit_cfg, tp.raw_dit_params, tp.vae_cfg, tp.vae_params,
            allowed_inference_steps=allow, device="cpu")
        args = (tpipe.GenerationParams(**p), torch.Generator(), _t(embeds), _t(mask))
        if ok:
            out = limited(*args, output_type="latent", dtype=torch.float32)
            assert out.shape == (1, 2, 2, 2, CH)
        else:
            with pytest.raises(ValueError, match="Invalid inference timestep"):
                limited(*args, output_type="latent", dtype=torch.float32)
