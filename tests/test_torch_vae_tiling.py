"""The port's tiled VAE encode and decode (``models/vae_tiling.py``)
against the JAX package's on the CPU in f32: overlapping spatial tiles,
temporal chunks, both together, and the crossfade they blend with, on a
narrow VAE with the 2B VAE's block kinds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import vae as jvae
from avatar_tpu.models import vae_tiling as jtiling
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.models import vae_tiling as ttiling
from avatar_tpu_torch.utils.weight_import import vae_params_from_numpy
from torch_parity import vae_numpy_params

torch.set_num_threads(2)

# the gate PERF.md section 2 uses for tiny models in f32: relative RMS
REL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2))


@pytest.fixture(scope="module")
def ltx_vae():
    """A narrow VAE with the 2B VAE's blocks (strided causal compress convs,
    which take any chunk length) and timestep-conditioned decoding."""
    d = dict(tvae.LTX_VAE_CONFIG, timestep_conditioning=True, encoder_base_channels=16,
             latent_channels=16)
    jcfg, tcfg = jvae.VAEConfig.from_dict(d), tvae.VAEConfig.from_dict(d)
    tree = vae_numpy_params(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, vae_params_from_numpy(
        tree, tcfg, device="cpu")


TILE = dict(tile_sample_size=64, overlap_factor=0.5)


@pytest.mark.parametrize("fn,kw", [
    ("hw_tiled_encode", TILE),
    ("z_tiled_encode", dict(z_sample_size=8)),
    ("z_tiled_encode", dict(z_sample_size=8, use_hw_tiling=True, **TILE)),
])
def test_tiled_encode_matches_jax(ltx_vae, fn, kw):
    jcfg, jparams, tcfg, tparams = ltx_vae
    media = np.random.default_rng(1).uniform(-1, 1, (1, 17, 64, 96, 3)).astype(np.float32)
    want = getattr(jtiling, fn)(jparams, jcfg, jnp.asarray(media), **kw)
    got = getattr(ttiling, fn)(tparams, tcfg, _t(media), **kw)
    assert got.shape == want.shape
    assert _rel_rms(got.numpy(), want) < REL_TOL


@pytest.mark.parametrize("fn,kw", [
    ("hw_tiled_decode", TILE),
    ("z_tiled_decode", dict(z_sample_size=8)),
    ("z_tiled_decode", dict(z_sample_size=16, use_hw_tiling=True, **TILE)),
])
def test_tiled_decode_matches_jax(ltx_vae, fn, kw):
    jcfg, jparams, tcfg, tparams = ltx_vae
    z = np.random.default_rng(2).standard_normal((1, 3, 3, 3, 16)).astype(np.float32)
    t = np.asarray([0.05], np.float32)
    want = getattr(jtiling, fn)(jparams, jcfg, jnp.asarray(z), jnp.asarray(t), **kw)
    got = getattr(ttiling, fn)(tparams, tcfg, _t(z), _t(t), **kw)
    assert got.shape == want.shape
    assert _rel_rms(got.numpy(), want) < REL_TOL


def test_blend_t_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((1, 2, 5, 6, 3)).astype(np.float32)
    b = rng.standard_normal((1, 2, 4, 6, 3)).astype(np.float32)
    for extent, axis in ((2, 2), (3, 3), (0, 2), (9, 2)):
        a_ = a if axis == 2 else a[:, :, :4]
        np.testing.assert_allclose(
            ttiling.blend_t(_t(a_), _t(b), extent, axis).numpy(),
            np.asarray(jtiling.blend_t(jnp.asarray(a_), jnp.asarray(b), extent, axis)),
            rtol=0, atol=1e-6)
