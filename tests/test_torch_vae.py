"""Parity of the PyTorch port's causal video VAE with the JAX package, on
the CPU: a narrow config with the 2B VAE's block kinds (``res_x``,
``compress_all``, ``res_x_y``) and ``demo_config`` (the ``compress_*_res``
kinds, replicate padding), both with timestep-conditioned decoding.
Params take the JAX init's tree and scales (``torch_parity.vae_numpy_params``)
and are carried across with ``vae_params_from_numpy``; the posterior noise
is JAX's own draw."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import vae as jvae
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.utils.weight_import import vae_params_from_numpy
from torch_parity import vae_numpy_params

torch.set_num_threads(2)

FRAMES, SIZE = 9, 64
# f32 through ~20 3x3x3 convs with O(1) activations: summation-order
# differences grow to ~1e-5 relative
ATOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _configs(kind):
    if kind == "ltx":
        blocks = dict(tvae.LTX_VAE_CONFIG, timestep_conditioning=True,
                      encoder_base_channels=16, latent_channels=16)
        return jvae.VAEConfig.from_dict(blocks), tvae.VAEConfig.from_dict(blocks)
    j = dataclasses.replace(jvae.demo_config(latent_channels=8), base_channels=16,
                            decoder_base_channels=16)
    t = dataclasses.replace(tvae.demo_config(latent_channels=8), base_channels=16,
                            decoder_base_channels=16)
    return j, t


@pytest.fixture(scope="module", params=["ltx", "demo"])
def vaes(request):
    jcfg, tcfg = _configs(request.param)
    tree = vae_numpy_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = vae_params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_config_factors_match(vaes):
    jcfg, _, tcfg, _ = vaes
    assert tvae.LTX_VAE_CONFIG == jvae.LTX_VAE_CONFIG
    assert tcfg.spatial_downscale_factor == jcfg.spatial_downscale_factor
    assert tcfg.temporal_downscale_factor == jcfg.temporal_downscale_factor


def test_vae_encode_matches_jax(vaes):
    jcfg, jparams, tcfg, tparams = vaes
    rng = np.random.default_rng(0)
    media = rng.uniform(-1, 1, (1, FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jvae.vae_encode(jparams, jcfg, media, key=key,
                          per_channel_normalize=True)
    noise = jax.random.normal(key, ref.shape, dtype=jnp.float32)
    out = tvae.vae_encode(tparams, tcfg, _t(media), noise=_t(noise),
                          per_channel_normalize=True)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_vae_decode_matches_jax(vaes):
    jcfg, jparams, tcfg, tparams = vaes
    rng = np.random.default_rng(1)
    shape = (1, 2, SIZE // jcfg.spatial_downscale_factor,
             SIZE // jcfg.spatial_downscale_factor, jcfg.latent_channels)
    lat = rng.standard_normal(shape).astype(np.float32)
    t = np.asarray([0.05], np.float32)
    ref = jvae.vae_decode(jparams, jcfg, lat, timestep=t, per_channel_normalize=True)
    out = tvae.vae_decode(tparams, tcfg, _t(lat), timestep=_t(t),
                          per_channel_normalize=True)
    assert out.shape == ref.shape == (1, FRAMES, SIZE, SIZE, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_init_vae_matches_jax_tree(vaes):
    jcfg, jparams, tcfg, tparams = vaes
    got = tvae.init_vae(tcfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
