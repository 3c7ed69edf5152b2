"""The pipeline's decode and VAE options against the JAX pipeline on the
CPU in f32, end to end to the decoded frames: ``tone_map_compression_ratio``,
``decode_noise_scale``, ``vae_per_channel_normalize=False`` and
``decode_timestep=0``. A tiny DiT and a VAE with timestep conditioning
(``torch_parity.guided_pipelines``), reference image and pose frames, 3
Euler steps at guidance 1. The port receives the JAX pipeline's draws (its
key splits) as tensors, the decode-time noise included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.pipelines import pipeline as tpipe
from torch_parity import H, W, guided_pipelines

torch.set_num_threads(2)

FRAMES = 9
# f32 pixels in [0, 1] after two VAE encodes, 3 DiT steps and a decode:
# summation order only (1.8e-6 to 2.2e-6 max abs measured); each option
# moves the frames by 0.2 to 0.9 from the default run's, and each case
# checks that it moves them by more than 1e-3
ATOL = 1e-5

CASES = {
    "tone_map_compression_ratio": dict(tone_map_compression_ratio=0.6),
    "decode_noise_scale": dict(decode_noise_scale=0.2),
    "vae_per_channel_normalize_false": dict(vae_per_channel_normalize=False),
    "decode_timestep_0": dict(decode_timestep=0.0),
}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _settings(**kw):
    return dict(dict(height=H, width=W, num_frames=FRAMES - 1, frame_rate=25.0,
                     num_inference_steps=3, guidance_scale=1.0, stg_scale=0.0,
                     rescaling_scale=1.0, decode_timestep=0.05), **kw)


@pytest.fixture(scope="module")
def pipes():
    return guided_pipelines()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    mask[0, 6:] = 0.0
    ref = rng.uniform(-1, 1, (1, 1, H, W, 3)).astype(np.float32)
    pose = rng.uniform(-1, 1, (1, FRAMES, H, W, 3)).astype(np.float32)
    return embeds, mask, ref, pose


def _jax_frames(pipes, inputs, settings):
    """JAX's decoded frames for ``settings``, and its draws as the port
    takes them."""
    jp, _ = pipes
    embeds, mask, ref, pose = inputs
    key = jax.random.PRNGKey(3)
    p = jpipe.GenerationParams(**settings)
    latents = jp(p, key, embeds, mask, ref_image=ref, pose_frames=pose,
                 output_type="latent", dtype=jnp.float32)
    k_ref, k_pose, k_lat, _, _, k_dec = jax.random.split(key, 6)
    frames = jp.decode_latents(latents, p, key=k_dec, output_type="np")
    lat_hw = H // 32
    noise = {
        "ref_noise": jax.random.normal(k_ref, (1, 1, lat_hw, lat_hw, 8)),
        "pose_noise": jax.random.normal(k_pose, (1, 2, lat_hw, lat_hw, 8)),
        "init_noise": jax.random.normal(
            jax.random.split(k_lat, 1)[0], (2, lat_hw, lat_hw, 8))[None],
        "decode_noise": jax.random.normal(k_dec, latents.shape),
    }
    return np.asarray(frames), {k: _t(v) for k, v in noise.items()}


@pytest.fixture(scope="module")
def default_frames(pipes, inputs):
    return _jax_frames(pipes, inputs, _settings())[0]


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_option_matches_jax(pipes, inputs, default_frames, case):
    _, tp = pipes
    embeds, mask, ref, pose = inputs
    settings = _settings(**CASES[case])
    want, noise = _jax_frames(pipes, inputs, settings)
    assert np.abs(want - default_frames).max() > 1e-3, "the option changes nothing"
    out = tp(tpipe.GenerationParams(**settings), torch.Generator(), _t(embeds), _t(mask),
             ref_image=_t(ref), pose_frames=_t(pose), output_type="np",
             dtype=torch.float32, **noise)
    assert tuple(out.shape) == want.shape == (1, FRAMES, H, W, 3)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)
