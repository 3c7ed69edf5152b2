"""Guided and long-sequence inference of the PyTorch port against the JAX
package, on the CPU in f32: the stochastic and per-token ``rf_step``, the
guidance schedule helpers, ``dit_apply`` with every ``SkipLayerStrategy``,
both RoPE layouts, both attention paths and both block layouts, and the
denoising walk with CFG, STG, the std rescale, ``cfg_star_rescale``, Heun
and stochastic sampling.

The JAX side runs its Pallas kernels in interpret mode
(``attention_impl="flash"``); the port runs the plain versions of its
kernels. Weights are initialised in JAX and carried across. The port
receives JAX's own random draws (initial latents, per-step noise) as
tensors, made from the keys exactly as the JAX pipeline derives them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.diffusion import rf as jrf
from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.ops import rope as jrope
from avatar_tpu.parallel.pipeline import stack_block_params as jstack
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.diffusion import rf as trf
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.ops import flash_attention as tfa
from avatar_tpu_torch.pipelines import pipeline as tpipe
from avatar_tpu_torch.utils.weight_import import (
    dit_params_from_numpy,
    vae_params_from_numpy,
)
from torch_parity import vae_numpy_params

torch.set_num_threads(2)

CFG_KW = dict(
    num_attention_heads=4, attention_head_dim=16, in_channels=16,
    out_channels=16, num_layers=2, cross_attention_dim=64, caption_channels=96,
)
LK = 16
# f32 through two blocks of O(1) activations (as tests/test_torch_dit.py)
DIT_ATOL = 1e-4


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
# dit_apply
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX unpermuted params, port cfg, port unpermuted params)."""
    jcfg, tcfg = jdit.DiTConfig(**CFG_KW), tdit.DiTConfig(**CFG_KW)
    jparams = jdit.init_dit(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, dit_params_from_numpy(tree, tcfg, device="cpu")


def _dit_inputs(grid_shape, batch=3):
    rng = np.random.default_rng(1)
    n = int(np.prod(grid_shape))
    tokens = rng.standard_normal((batch, n, 16)).astype(np.float32)
    text = rng.standard_normal((batch, LK, 96)).astype(np.float32)
    mask = np.ones((batch, LK), np.float32)
    mask[0, 10:] = 0.0
    grid = jrope.get_latent_coords(*grid_shape, batch_size=batch)
    t = np.asarray([0.5, 0.5, 0.25][:batch], np.float32)
    return tokens, text, mask, grid, t


def _both(models, grid_shape, rope_split=True, impl="flash", stacked=False, **kw):
    """The same call through the JAX ``dit_apply`` and the port's."""
    jcfg, jparams, tcfg, tparams = models
    tokens, text, mask, grid, t = _dit_inputs(grid_shape)
    if rope_split:
        jparams = jdit.permute_dit_params_for_split_rope(jparams, jcfg)
        tparams = tdit.permute_dit_params_for_split_rope(tparams, tcfg)
    if stacked:
        jparams = dict(jparams, blocks=jstack(jparams["blocks"]))
        tparams = dict(tparams, blocks=tdit.stack_block_params(tparams["blocks"]))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if "skip_layer_strategy" in kw and kw["skip_layer_strategy"] is not None:
        jkw["skip_layer_strategy"] = jdit.SkipLayerStrategy[kw["skip_layer_strategy"]]
        kw["skip_layer_strategy"] = tdit.SkipLayerStrategy[kw["skip_layer_strategy"]]
    ref = jdit.dit_apply(jparams, jcfg, tokens, grid, t, text, mask,
                         attention_impl=impl, rope_split=rope_split, **jkw)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out = tdit.dit_apply(tparams, tcfg, _t(tokens), _t(grid), _t(t), _t(text),
                         _t(mask), attention_impl=impl, rope_split=rope_split, **tkw)
    return out.numpy(), np.asarray(ref)


SKIP_MASK = np.asarray([[1, 1, 0], [1, 0, 1]], np.float32)  # [layers, B]


@pytest.fixture(scope="module")
def unperturbed(models):
    """The port's output without a skip mask, by grid shape."""
    return {shape: _both(models, shape)[0] for shape in ((2, 4, 8), (3, 3, 7))}


@pytest.mark.parametrize("strategy", [
    "AttentionSkip", "AttentionValues", "Residual", "TransformerBlock"])
@pytest.mark.parametrize("grid_shape", [(2, 4, 8), (3, 3, 7)])
def test_dit_apply_skip_layer_strategies(models, unperturbed, strategy, grid_shape):
    """64 tokens take the token-major kernels, 63 (not a multiple of 8) the
    head-major flash path; the STG mix follows attention on each."""
    out, ref = _both(models, grid_shape, skip_layer_mask=SKIP_MASK,
                     skip_layer_strategy=strategy)
    np.testing.assert_allclose(out, ref, atol=DIT_ATOL, rtol=DIT_ATOL)
    plain = unperturbed[grid_shape]
    if strategy == "Residual":
        # as in the JAX package, dit.py does nothing for Residual
        np.testing.assert_array_equal(out, plain)
    else:
        assert np.abs(out[1:] - plain[1:]).max() > 1e-3  # the mix took effect
        if strategy != "TransformerBlock":
            # sample 0 is perturbed in no block
            np.testing.assert_array_equal(out[0], plain[0])


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("rope_split", [True, False])
def test_dit_apply_layouts_and_attention_paths(models, rope_split, impl, stacked):
    out, ref = _both(models, (3, 3, 7), rope_split=rope_split, impl=impl,
                     stacked=stacked, skip_layer_mask=SKIP_MASK,
                     skip_layer_strategy="AttentionValues")
    np.testing.assert_allclose(out, ref, atol=DIT_ATOL, rtol=DIT_ATOL)


def test_dit_apply_per_token_timestep_and_stacked_cross_kv(models):
    jcfg, jparams, tcfg, tparams = models
    tokens, text, mask, grid, _ = _dit_inputs((2, 4, 8))
    t = np.random.default_rng(2).uniform(0.1, 1.0, tokens.shape[:2]).astype(np.float32)
    jp = jdit.permute_dit_params_for_split_rope(jparams, jcfg)
    jp = dict(jp, blocks=jstack(jp["blocks"]))
    tp = tdit.permute_dit_params_for_split_rope(tparams, tcfg)
    tp = dict(tp, blocks=tdit.stack_block_params(tp["blocks"]))
    jkv, _ = jdit.precompute_cross_attention_kv(jp, jcfg, text)
    tkv, _ = tdit.precompute_cross_attention_kv(tp, tcfg, _t(text))
    assert tkv[0].shape == tuple(jkv[0].shape) == (2, 3, LK, 64)
    ref = jdit.dit_apply(jp, jcfg, tokens, grid, t, None, mask,
                         attention_impl="flash", rope_split=True, cross_kv=jkv)
    out = tdit.dit_apply(tp, tcfg, _t(tokens), _t(grid), _t(t),
                         encoder_attention_mask=_t(mask), cross_kv=tkv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DIT_ATOL,
                               rtol=DIT_ATOL)


@pytest.mark.parametrize("qk_norm,mode", [("rms_norm", "bounded"), (None, "online")])
def test_dit_long_sequence_takes_the_blocked_flash_kernels(qk_norm, mode):
    """1100 tokens (not a multiple of 8, above one 1024-row block): both
    sides leave the token-major kernels for the blocked flash forward, the
    max-free one with q/k norm and the online one without."""
    kw = dict(CFG_KW, num_layers=1, qk_norm=qk_norm)
    jcfg, tcfg = jdit.DiTConfig(**kw), tdit.DiTConfig(**kw)
    jparams = jdit.init_dit(jax.random.PRNGKey(2), jcfg)
    tparams = dit_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    grid_shape = (11, 10, 10)
    assert tfa.flash_mode(1100, 1100, qk_norm is not None) == mode
    assert not tfa.rope_fused_supports(1100, 4, 16, torch.float32)
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((1, 1100, 16)).astype(np.float32)
    text = rng.standard_normal((1, LK, 96)).astype(np.float32)
    mask = np.ones((1, LK), np.float32)
    mask[0, 12:] = 0.0
    grid = jrope.get_latent_coords(*grid_shape, batch_size=1)
    t = np.asarray([0.6], np.float32)
    jp = jdit.permute_dit_params_for_split_rope(jparams, jcfg)
    tp = tdit.permute_dit_params_for_split_rope(tparams, tcfg)
    ref = jdit.dit_apply(jp, jcfg, tokens, grid, t, text, mask,
                         attention_impl="flash", rope_split=True)
    out = tdit.dit_apply(tp, tcfg, _t(tokens), _t(grid), _t(t), _t(text), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DIT_ATOL,
                               rtol=DIT_ATOL)


# ---------------------------------------------------------------------------
# The guided denoising walk
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


def _pipelines(**ctor):
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


@pytest.fixture(scope="module")
def default_pipelines():
    return _pipelines()


def _run_both(pipes, frames, settings, negative=False):
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
    out = tp(tpipe.GenerationParams(**base, **tset), torch.Generator(), _t(embeds),
             _t(mask), **{k: _t(v) for k, v in cond.items()}, init_noise=_t(init),
             step_noise=_t(step_noise), output_type="latent", dtype=torch.float32)
    return out.numpy(), np.asarray(ref)


SHIPPED = dict(guidance_scale=3.0, stg_scale=1.0, rescaling_scale=0.7,
               skip_block_list=[1], skip_layer_strategy="AttentionValues")


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
    out, ref = _run_both(default_pipelines, 9, settings, negative)
    assert out.shape == ref.shape == (1, 2, 2, 2, 8)
    np.testing.assert_allclose(out, ref, atol=PIPE_ATOL, rtol=PIPE_ATOL)


@pytest.mark.parametrize("ctor", [
    dict(rope_split=False), dict(scan_blocks=True), dict(attention_impl="xla"),
    dict(attention_impl="auto"),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_guided_walk_ctor_options_match_jax(ctor):
    """17 frames: 12 tokens, not a multiple of 8, so both sides take the
    head-major path (the whole-row flash kernel, or plain attention under
    "xla") with RoPE in plain code."""
    out, ref = _run_both(_pipelines(**ctor), 17, SHIPPED)
    np.testing.assert_allclose(out, ref, atol=PIPE_ATOL, rtol=PIPE_ATOL)


def test_heun_differs_from_euler_and_skips_the_last_corrector(default_pipelines):
    euler, _ = _run_both(default_pipelines, 9, dict(SHIPPED))
    heun, _ = _run_both(default_pipelines, 9, dict(SHIPPED, solver="heun"))
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
