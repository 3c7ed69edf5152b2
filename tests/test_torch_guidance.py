"""Guided inference of the PyTorch port against the JAX package, on the CPU
in f32: the stochastic and per-token ``rf_step``, the guidance schedule
helpers, and the denoising walk with CFG, STG, the std rescale,
``cfg_star_rescale``, Heun and stochastic sampling. ``dit_apply`` under
every ``SkipLayerStrategy`` is in ``test_torch_guidance_dit.py``, the
walk under the pipeline's constructor options in
``test_torch_guidance_ctor.py``.

The JAX side runs its Pallas kernels in interpret mode
(``attention_impl="flash"``); the port runs the plain versions of its
kernels. Weights are initialised in JAX and carried across. The port
receives JAX's own random draws (initial latents, per-step noise) as
tensors, made from the keys exactly as the JAX pipeline derives them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.diffusion import rf as jrf
from avatar_tpu.models import dit as jdit
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.diffusion import rf as trf
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.pipelines import pipeline as tpipe
from torch_parity import H, PIPE_ATOL, SHIPPED, W, guided_pipelines, run_guided_walk

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# rf_step and the guidance schedule helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_rf_step_per_token_and_stochastic(per_token, stochastic):
    rng = np.random.default_rng(0)
    sig = np.asarray([1.0, 0.8, 0.45, 0.1], np.float32)
    x = rng.standard_normal((2, 6, 4)).astype(np.float32)
    v = rng.standard_normal((2, 6, 4)).astype(np.float32)
    # per-token levels: on the schedule, between its levels and below it
    t = (np.asarray([[0.8, 0.8, 0.45, 0.3, 0.05, 1.0]] * 2, np.float32)
         if per_token else np.float32(0.45))
    key = jax.random.PRNGKey(5)
    ref = jrf.rf_step(sig, v, t, x, stochastic_sampling=stochastic,
                      key=key if stochastic else None)
    noise = _t(jax.random.normal(key, x.shape, jnp.float32)) if stochastic else None
    out = trf.rf_step(_t(sig), _t(v), torch.as_tensor(t), _t(x),
                      stochastic_sampling=stochastic, noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_rf_step_stochastic_needs_noise_or_generator():
    x = torch.zeros(1, 2, 2)
    sig = torch.tensor([1.0, 0.5])
    with pytest.raises(ValueError):
        trf.rf_step(sig, x, torch.tensor(1.0), x, stochastic_sampling=True)
    a = trf.rf_step(sig, x, torch.tensor(1.0), x, stochastic_sampling=True,
                    generator=torch.Generator().manual_seed(1))
    b = trf.rf_step(sig, x, torch.tensor(1.0), x, stochastic_sampling=True,
                    generator=torch.Generator().manual_seed(1))
    assert a.abs().sum() > 0 and torch.equal(a, b)


@pytest.mark.parametrize("value", [3.0, [1.0, 4.0, 2.0]])
def test_step_arrays_and_guidance_mapping(value):
    timesteps = np.asarray([1.0, 0.97, 0.6, 0.3, 0.05])
    guidance_timesteps = [1.0, 0.95, 0.2]
    assert (tpipe._guidance_mapping(timesteps, guidance_timesteps)
            == jpipe._guidance_mapping(timesteps, guidance_timesteps))
    np.testing.assert_array_equal(
        tpipe._as_step_array(value, timesteps, guidance_timesteps),
        jpipe._as_step_array(value, timesteps, guidance_timesteps))


@pytest.mark.parametrize("skip", [None, [], [0, 2]])
def test_create_skip_layer_mask(skip):
    ref = jdit.create_skip_layer_mask(3, 2, 3, 2, skip)
    out = tdit.create_skip_layer_mask(3, 2, 3, 2, skip, device="cpu")
    if ref is None:
        assert out is None
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# The guided denoising walk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def default_pipelines():
    return guided_pipelines()


@pytest.mark.parametrize("name,settings,negative", [
    ("cfg_stg_rescale", SHIPPED, False),
    ("cfg_star_negative_prompt",
     dict(SHIPPED, cfg_star_rescale=True, skip_layer_strategy="AttentionSkip"), True),
    ("heun", dict(SHIPPED, solver="heun"), False),
    ("stochastic", dict(SHIPPED, stochastic_sampling=True), False),
    ("stg_only", dict(SHIPPED, guidance_scale=1.0,
                      skip_layer_strategy="TransformerBlock"), False),
    ("per_step_lists_skip_final",
     dict(guidance_scale=[1.0, 4.0, 2.0], stg_scale=[0.0, 1.0, 1.0],
          rescaling_scale=[1.0, 0.7, 1.0], guidance_timesteps=[1.0, 0.9, 0.3],
          skip_block_list=[[], [0], [0, 1]], skip_layer_strategy="AttentionValues",
          skip_final_inference_steps=1), False),
    ("defaults", {}, False),
], ids=lambda v: v if isinstance(v, str) else "")
def test_guided_walk_matches_jax(default_pipelines, name, settings, negative):
    """9 frames at 64 px: 8 tokens, the token-major kernels."""
    out, ref = run_guided_walk(default_pipelines, 9, settings, negative)
    assert out.shape == ref.shape == (1, 2, 2, 2, 8)
    np.testing.assert_allclose(out, ref, atol=PIPE_ATOL, rtol=PIPE_ATOL)


def test_heun_differs_from_euler_and_skips_the_last_corrector(default_pipelines):
    euler, _ = run_guided_walk(default_pipelines, 9, dict(SHIPPED))
    heun, _ = run_guided_walk(default_pipelines, 9, dict(SHIPPED, solver="heun"))
    assert np.abs(euler - heun).max() > 1e-3
    _, tp = default_pipelines
    with pytest.raises(ValueError):
        tp(tpipe.GenerationParams(height=H, width=W, num_frames=8, solver="heun",
                                  stochastic_sampling=True), torch.Generator(),
           torch.zeros(1, 8, 32), torch.ones(1, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        tp(tpipe.GenerationParams(height=H, width=W, num_frames=8, solver="rk4"),
           torch.Generator(), torch.zeros(1, 8, 32), torch.ones(1, 8),
           dtype=torch.float32)
