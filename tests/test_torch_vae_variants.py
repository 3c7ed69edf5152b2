"""The port's VAE and DiT variants that the shipped 2B model does not use,
against the JAX package on the CPU in f32: a VAE with group norm,
``attn_res_x`` decoder blocks (self-attention with q/k rms-norm, at 320
tokens so that the port's "auto" takes the flash route's plain version)
and decoder noise injection fed JAX's own draws; a VAE with layer norm,
``normalize_latent_channels`` and a per-channel log-variance; and a DiT
with ``adaptive_norm="none"``. Params take the JAX init's tree
(``torch_parity.vae_numpy_params`` / ``init_dit``) carried across with
``*_params_from_numpy``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.ops import rope as jrope
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.ops import flash_attention as fa
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy, vae_params_from_numpy
from torch_parity import vae_numpy_params

torch.set_num_threads(2)

# the gate PERF.md section 2 uses for tiny models in f32: relative RMS
REL_TOL = 1e-4
_ENCODER = [("res_x", {"num_layers": 1}), ("compress_all", {}),
            ("res_x_y", {"multiplier": 2}), ("compress_all", {}), ("compress_all", {}),
            ("res_x", {"num_layers": 1})]
VARIANTS = {
    "group_norm_attention_noise": dict(
        norm_layer="group_norm", timestep_conditioning=True, latent_log_var="uniform",
        decoder_blocks=[
            ("res_x", {"num_layers": 1, "inject_noise": True}),
            ("compress_all", {"residual": True, "multiplier": 2}),
            ("res_x_y", {"multiplier": 2, "inject_noise": True}),
            ("compress_all", {"residual": True}),
            ("attn_res_x", {"num_layers": 2, "attention_head_dim": 64,
                            "inject_noise": True}),
            ("compress_all", {})]),
    "layer_norm_latent_channels": dict(
        norm_layer="layer_norm", normalize_latent_channels=True,
        latent_log_var="per_channel",
        decoder_blocks=[("res_x", {"num_layers": 1}), ("compress_all", {}),
                        ("res_x_y", {"multiplier": 2}), ("compress_all", {}),
                        ("attn_res_x", {"num_layers": 1, "attention_head_dim": 64}),
                        ("compress_all", {})]),
}
FRAMES, SIZE = 17, 128


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2))


def _config_dict(variant):
    return dict(VARIANTS[variant], encoder_blocks=_ENCODER, latent_channels=8,
                encoder_base_channels=32, decoder_base_channels=32, patch_size=4,
                spatial_padding_mode="zeros")


@functools.lru_cache(maxsize=None)
def _build(variant):
    d = _config_dict(variant)
    jcfg, tcfg = jvae.VAEConfig.from_dict(d), tvae.VAEConfig.from_dict(d)
    tree = vae_numpy_params(jcfg)
    if "latent_norm" in tree:
        # BatchNorm running statistics: a positive variance
        tree["latent_norm"]["running_var"] = np.random.default_rng(2).uniform(
            0.5, 2.0, jcfg.latent_channels).astype(np.float32)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            vae_params_from_numpy(tree, tcfg, device="cpu"))


@pytest.fixture(scope="module", params=list(VARIANTS))
def vaes(request):
    return _build(request.param)


def _jax_spatial_noise(jcfg, jparams, key, hw):
    """The [H, W] draws JAX's decoder takes with ``noise_key=key``, in the
    order it takes them: block i folds i into the key, resnet j of a mid
    block j, and conv 1 / 2 of a resnet 1 / 2."""
    h, w = hw
    draws = []
    walk = jvae._decoder_channel_walk(jcfg)
    for i, (bp, (name, _, _, _)) in enumerate(zip(jparams["decoder"]["blocks"], walk)):
        nk = jax.random.fold_in(key, i)
        if name in ("res_x", "attn_res_x", "res_x_y"):
            resnets = (bp["res_blocks"] if name != "res_x_y" else [bp])
            for j, res in enumerate(resnets):
                rk = jax.random.fold_in(nk, j) if name != "res_x_y" else nk
                for n in (1, 2):
                    if f"per_channel_scale{n}" in res:
                        draws.append(jax.random.normal(jax.random.fold_in(rk, n), (h, w)))
        else:
            stride = jvae._upsample_stride(name)
            h, w = h * stride[1], w * stride[2]
    return draws


def test_encoder_attention_blocks_refused_as_in_jax():
    """The JAX encoder takes no ``attn_res_x`` block; neither does the port."""
    d = dict(_config_dict("layer_norm_latent_channels"),
             encoder_blocks=[("attn_res_x", {"num_layers": 1, "attention_head_dim": 64})]
             + _ENCODER)
    with pytest.raises(ValueError, match="attn_res_x"):
        jax.eval_shape(lambda k: jvae.init_vae(k, jvae.VAEConfig.from_dict(d)),
                       jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="attn_res_x"):
        tvae.init_vae(tvae.VAEConfig.from_dict(d), device="cpu")


def test_variant_encode_matches_jax(vaes):
    jcfg, jparams, tcfg, tparams = vaes
    media = np.random.default_rng(0).uniform(-1, 1, (1, FRAMES, SIZE, SIZE, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    ref = jvae.vae_encode(jparams, jcfg, media, key=key, per_channel_normalize=True)
    noise = jax.random.normal(key, ref.shape, dtype=jnp.float32)
    out = tvae.vae_encode(tparams, tcfg, _t(media), noise=_t(noise),
                          per_channel_normalize=True)
    assert out.shape == ref.shape
    assert _rel_rms(out.numpy(), ref) < REL_TOL


def test_variant_decode_matches_jax(vaes, monkeypatch):
    """Decode with timestep conditioning (where configured) and, where
    blocks inject noise, JAX's draws fed to the port; the attention blocks
    run at 320 tokens, on the port's flash route (its plain version)."""
    jcfg, jparams, tcfg, tparams = vaes
    lat_hw = SIZE // jcfg.spatial_downscale_factor
    shape = (1, (FRAMES - 1) // 8 + 1, lat_hw, lat_hw, jcfg.latent_channels)
    latents = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    t = np.asarray([0.05], np.float32) if jcfg.timestep_conditioning else None
    key = jax.random.PRNGKey(9)
    ref = jvae.vae_decode(jparams, jcfg, latents, timestep=t, noise_key=key,
                          per_channel_normalize=True)
    draws = [_t(d) for d in _jax_spatial_noise(jcfg, jparams, key, (lat_hw, lat_hw))]
    has_noise = any(p.get("inject_noise") for _, p in jcfg.decoder_blocks)
    assert bool(draws) == has_noise
    modes = []
    plain_forward = fa._flash_plain

    def spy(q, k, v, kv_mask, scale, mode):
        modes.append(mode)
        return plain_forward(q, k, v, kv_mask, scale, mode)

    monkeypatch.setattr(fa, "_flash_plain", spy)
    out = tvae.vae_decode(tparams, tcfg, _t(latents), None if t is None else _t(t),
                          per_channel_normalize=True,
                          spatial_noise=draws if has_noise else None)
    assert out.shape == ref.shape == (1, FRAMES, SIZE, SIZE, 3)
    assert _rel_rms(out.numpy(), ref) < REL_TOL
    # each attention block took the whole-row kernel's (E's) plain version
    n_attn = sum(p["num_layers"] for n, p in jcfg.decoder_blocks if n == "attn_res_x")
    assert modes == ["single"] * n_attn
    if has_noise:
        # the draws matter: without them the decode leaves JAX's
        plain = tvae.vae_decode(tparams, tcfg, _t(latents), _t(t),
                                per_channel_normalize=True)
        assert _rel_rms(plain.numpy(), ref) > 100 * REL_TOL
        with pytest.raises(ValueError, match="spatial noise"):
            tvae.vae_decode(tparams, tcfg, _t(latents), _t(t),
                            per_channel_normalize=True, spatial_noise=draws[:-1])


def test_variant_noise_from_generator_is_seeded():
    _, _, tcfg, tparams = _build("group_norm_attention_noise")
    lat_hw = SIZE // tcfg.spatial_downscale_factor
    z = torch.randn(1, 2, lat_hw, lat_hw, tcfg.latent_channels,
                    generator=torch.Generator().manual_seed(0))
    t = torch.tensor([0.05])

    def run(seed):
        return tvae.vae_decode(tparams, tcfg, z, t,
                               generator=torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dit_adaptive_norm_none_matches_jax(impl):
    kw = dict(num_attention_heads=4, attention_head_dim=16, in_channels=16,
              out_channels=16, num_layers=2, cross_attention_dim=64, caption_channels=96,
              adaptive_norm="none", norm_elementwise_affine=True)
    jcfg, tcfg = jdit.DiTConfig(**kw), tdit.DiTConfig(**kw)
    jparams = jdit.init_dit(jax.random.PRNGKey(0), jcfg)
    assert "scale_shift_table" not in jparams["blocks"][0]
    tparams = dit_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert "scale_shift_table" not in tdit.init_dit(tcfg, device="cpu")["blocks"][0]
    jp = jdit.permute_dit_params_for_split_rope(jparams, jcfg)
    tp = tdit.permute_dit_params_for_split_rope(tparams, tcfg)
    rng = np.random.default_rng(0)
    b, f, h, w, lk = 2, 2, 4, 8, 16
    tokens = rng.standard_normal((b, f * h * w, 16)).astype(np.float32)
    text = rng.standard_normal((b, lk, 96)).astype(np.float32)
    mask = np.ones((b, lk), np.float32)
    mask[0, 10:] = 0.0
    grid = jrope.get_latent_coords(f, h, w, batch_size=b)
    t = np.asarray([0.5, 0.25], np.float32)
    ref = jdit.dit_apply(jp, jcfg, tokens, grid, t, text, mask, attention_impl=impl,
                         rope_split=True)
    out = tdit.dit_apply(tp, tcfg, _t(tokens), _t(grid), _t(t), _t(text), _t(mask),
                         attention_impl=impl)
    assert out.shape == ref.shape
    assert _rel_rms(out.numpy(), ref) < REL_TOL
