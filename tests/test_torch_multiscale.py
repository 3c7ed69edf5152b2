"""The port's latent upsampler (``models/latent_upsampler.py``) and
two-pass multi-scale pipeline (``pipelines/multiscale.py``) against the
JAX package on the CPU in f32: the upsampler in each of its modes (norm
affines away from their init), and the whole multi-scale run, reference
image and pose frames resized to each pass, the port fed both passes'
draws recomputed from the JAX run's key splits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import latent_upsampler as jup
from avatar_tpu.pipelines import multiscale as jms
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.models import latent_upsampler as tup
from avatar_tpu_torch.pipelines import multiscale as tms
from avatar_tpu_torch.pipelines import pipeline as tpipe
from avatar_tpu_torch.utils.weight_import import latent_upsampler_params_from_numpy
from torch_parity import guided_pipelines

torch.set_num_threads(2)

# the gate PERF.md section 2 uses for tiny pipelines in f32: relative RMS
REL_TOL = 1e-4
CH = 8


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2))


def _upsampler(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if "norm" in jax.tree_util.keystr(path) else np.asarray(x),
        jup.init_latent_upsampler(jax.random.PRNGKey(seed), cfg))
    tcfg = tup.LatentUpsamplerConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    return tree, tcfg, latent_upsampler_params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(), dict(dims=2), dict(temporal_upsample=True),
    dict(spatial_upsample=False, temporal_upsample=True)],
    ids=["spatial3d", "spatial2d", "spatiotemporal", "temporal"])
def test_latent_upsampler_matches_jax(kw):
    cfg = jup.LatentUpsamplerConfig(in_channels=CH, mid_channels=32, num_blocks_per_stage=2,
                                    **kw)
    tree, tcfg, tparams = _upsampler(cfg)
    assert {k: v.shape for k, v in tup.init_latent_upsampler(tcfg, device="cpu")[
        "upsampler_conv"].items()} == {"weight": tparams["upsampler_conv"]["weight"].shape,
                                      "bias": tparams["upsampler_conv"]["bias"].shape}
    lat = np.random.default_rng(1).standard_normal((1, 3, 4, 5, CH)).astype(np.float32)
    want = jup.latent_upsampler_apply(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(lat))
    got = tup.latent_upsampler_apply(tparams, tcfg, _t(lat))
    assert got.shape == want.shape
    assert _rel_rms(got.numpy(), want) < REL_TOL


def _pass_noise(key, size, frames):
    """One pass's draws for its key (the pipeline's six-way split): the
    reference and pose encoders', the initial noise and the decode noise."""
    k_ref, k_pose, k_lat, _, _, k_dec = jax.random.split(key, 6)
    lat = ((frames - 1) // 8 + 1, size // 32, size // 32, CH)
    d = {"init_noise": _t(jax.random.normal(jax.random.split(k_lat, 1)[0], lat)[None]),
         "decode_noise": _t(jax.random.normal(k_dec, (1,) + lat)),
         "ref_noise": _t(jax.random.normal(k_ref, (1, 1) + lat[1:])),
         "pose_noise": _t(jax.random.normal(k_pose, (1,) + lat))}
    return d


@pytest.mark.parametrize("output_type", ["np", "uint8"])
def test_multiscale_pipeline_matches_jax(output_type):
    """96 px asked for: a 64 px first pass, its latents upsampled and
    AdaIN-matched, a 128 px second pass from them, resized to 96 px."""
    jp, tp = guided_pipelines()
    cfg = jup.LatentUpsamplerConfig(in_channels=CH, mid_channels=32, num_blocks_per_stage=1)
    tree, tcfg, tparams = _upsampler(cfg, seed=2)
    jms_pipe = jms.LTXMultiScalePipeline(jp, cfg, jax.tree.map(jnp.asarray, tree))
    tms_pipe = tms.LTXMultiScalePipeline(tp, tcfg, tparams)
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    ref = rng.uniform(-1, 1, (1, 1, 96, 96, 3)).astype(np.float32)
    pose = rng.uniform(-1, 1, (1, 9, 96, 96, 3)).astype(np.float32)
    base = dict(height=96, width=96, num_frames=8, frame_rate=25.0, num_inference_steps=3,
                guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0,
                decode_timestep=0.05)
    key = jax.random.PRNGKey(4)
    want = jms_pipe(jpipe.GenerationParams(**base), key, embeds, mask,
                    ref_image=jnp.asarray(ref), pose_frames=jnp.asarray(pose),
                    output_type=output_type, dtype=jnp.float32)
    k1, k2 = jax.random.split(key)
    first = _pass_noise(k1, 64, 9)
    first.pop("decode_noise")  # the first pass stops at its latents
    got = tms_pipe(tpipe.GenerationParams(**base), torch.Generator(), _t(embeds), _t(mask),
                   ref_image=_t(ref), pose_frames=_t(pose), output_type=output_type,
                   dtype=torch.float32, first_pass_noise=first,
                   second_pass_noise=_pass_noise(k2, 128, 9))
    assert tuple(got.shape) == tuple(want.shape) == (1, 9, 96, 96, 3)
    if output_type == "uint8":
        assert got.dtype == torch.uint8
        # f32 pixels a few 1e-6 apart can round to neighbouring levels
        assert np.abs(got.numpy().astype(int) - np.asarray(want).astype(int)).max() <= 1
    else:
        assert _rel_rms(got.numpy(), want) < REL_TOL


@pytest.mark.parametrize("factor", [1.0, 0.4])
def test_adain_filter_latent_matches_jax(factor):
    rng = np.random.default_rng(5)
    lat = (2.0 * rng.standard_normal((2, 3, 4, 5, CH)) + 0.5).astype(np.float32)
    ref = rng.standard_normal((2, 2, 4, 5, CH)).astype(np.float32)
    got = tpipe.adain_filter_latent(_t(lat), _t(ref), factor)
    want = jpipe.adain_filter_latent(jnp.asarray(lat), jnp.asarray(ref), factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
