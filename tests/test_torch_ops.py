"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs are made from a seed with numpy and fed to both. Comparisons run in
f32; each tolerance says why it is what it is. The JAX attention kernels run
as Pallas kernels in interpret mode (the CPU backend), the port's through
their plain versions (a CPU tensor never reaches a CUDA kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.diffusion import rf as jrf
from avatar_tpu.ops import attention as jattn
from avatar_tpu.ops import color as jcolor
from avatar_tpu.ops.causal_conv3d import conv3d_params as jconv3d_params
from avatar_tpu.ops import flash_attention as jfa
from avatar_tpu.ops import normalization as jnorm
from avatar_tpu.ops import pixel_shuffle as jps
from avatar_tpu.ops import rope as jrope
from avatar_tpu_torch.diffusion import rf as trf
from avatar_tpu_torch.ops import attention as tattn
from avatar_tpu_torch.ops import causal_conv3d as tconv
from avatar_tpu_torch.ops import color as tcolor
from avatar_tpu_torch.ops import flash_attention as tfa
from avatar_tpu_torch.ops import normalization as tnorm
from avatar_tpu_torch.ops import pixel_shuffle as tps
from avatar_tpu_torch.ops import rope as trope

torch.set_num_threads(2)

# f32 attention: same products, different summation order -> ~1e-6; the
# JAX package's own kernel-vs-reference tests use 2e-5 (tests/test_ops.py).
ATTN_ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _qkv(rng, b, lq, lk, c):
    # rms-normalized rows, as the DiT's qk-norm delivers them
    def rows(n):
        x = rng.standard_normal((b, n, c)).astype(np.float32)
        return x / np.sqrt((x * x).mean(-1, keepdims=True))
    return rows(lq), rows(lk), rng.standard_normal((b, lk, c)).astype(np.float32)


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("heads,hd", [(4, 16), (8, 32)])
def test_rope_fused_attention_matches_jax_kernel(heads, hd, bounded):
    rng = np.random.default_rng(0)
    b, f, h, w = 2, 2, 4, 8
    c, l = heads * hd, f * h * w
    q, k, v = _qkv(rng, b, l, l, c)
    grid = jrope.get_latent_coords(f, h, w, batch_size=b)
    cos, sin = (np.asarray(t) for t in jrope.split_freqs(
        jrope.precompute_freqs_cis(grid, dim=c)))
    assert jfa.rope_fused_supports(l, heads, hd, jnp.float32)
    ref = jfa.rope_fused_attention(q, k, v, cos, sin, heads, hd**-0.5, bounded)
    out = tfa.rope_fused_attention(_t(q), _t(k), _t(v), _t(cos), _t(sin),
                                   heads, hd**-0.5, bounded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_ATOL)


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_token_attention_matches_jax_kernel(bounded, masked):
    rng = np.random.default_rng(1)
    b, lq, lk, heads, hd = 3, 32, 24, 4, 16
    q, k, v = _qkv(rng, b, lq, lk, heads * hd)
    mask = None
    if masked:
        mask = np.ones((b, lk), np.float32)
        mask[1, 10:] = 0.0
        mask[2] = 0.0  # every key masked
    assert jfa.fused_supports(lq, lk, heads, hd, jnp.float32)
    ref = jfa.fused_token_attention(q, k, v, mask, heads, hd**-0.5, bounded)
    out = tfa.fused_token_attention(_t(q), _t(k), _t(v),
                                    None if mask is None else _t(mask),
                                    heads, hd**-0.5, bounded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_ATOL)
    if masked:
        # The kernels' semantics (which the port holds to): a fully-masked
        # row returns 0. The JAX XLA path would give unmasked attention.
        assert np.all(out.numpy()[2] == 0.0)


@pytest.mark.parametrize("mask_dtype", ["float", "bool"])
def test_xla_attention_with_mask_bias(mask_dtype):
    """The plain XLA-path attention and its -1e4 keep-mask bias. Unlike the
    kernels, a fully-masked row here gives ordinary (unmasked) attention."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((2, 3, n, 16)).astype(np.float32)
               for n in (8, 12, 12))
    mask = np.ones((2, 12), np.float32)
    mask[0, 7:] = 0.0
    mask[1] = 0.0
    jm = mask > 0.5 if mask_dtype == "bool" else mask
    tm = torch.from_numpy(mask > 0.5) if mask_dtype == "bool" else _t(mask)
    ref = jattn.xla_attention(q, k, v, jattn._mask_to_bias(jm, jnp.float32, 4))
    out = tattn.xla_attention(_t(q), _t(k), _t(v), tattn.mask_to_bias(tm, 4))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    unmasked = tattn.xla_attention(_t(q[1:]), _t(k[1:]), _t(v[1:]))
    # s - 1e4 keeps s only to f32's ulp at 1e4 (~1e-3)
    np.testing.assert_allclose(out[1:].numpy(), unmasked.numpy(), atol=2e-3)


def test_launch_counts_untouched_on_cpu():
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 8, 8, 128)
    tfa.reset_launch_counts()
    tfa.fused_token_attention(_t(q), _t(k), _t(v), None, 2, 0.125, True)
    heads = [_t(a).reshape(1, 8, 2, 64).transpose(1, 2).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*heads, bounded_logits=True)
    torch.autograd.grad(out.sum(), heads)  # the flash backward's plain version
    ang = torch.from_numpy(rng.uniform(0, 6.3, (1, 8, 64)).astype(np.float32))
    tfa.qk_norm_rope(_t(q), _t(k), torch.ones(128), torch.ones(128), ang.cos(), ang.sin(),
                     2, 0.125)  # kernel M's plain version
    assert set(tfa.launch_counts) == {
        "rope_fused_attention", "fused_token_attention", "rope_fused_attention_sm90",
        "rope_fused_attention_wmma", "fused_token_attention_sm90",
        "fused_token_attention_wmma", "flash_bounded", "flash_online", "flash_single",
        "flash_bounded_sm90", "flash_online_sm90", "flash_single_sm90",
        "flash_bounded_wmma", "flash_online_wmma", "flash_single_wmma",
        "flash_bwd_dkv", "flash_bwd_dq",
        "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_wmma", "flash_bwd_dq_wmma",
        "flash_dense_forward", "flash_dense_bwd_dkv", "flash_dense_bwd_dq",
        "flash_dense_bwd_db", "flash_dense_fwd_sm90", "flash_dense_bwd_dkv_sm90",
        "flash_dense_bwd_dq_sm90", "flash_dense_bwd_db_sm90", "flash_dense_fwd_wmma",
        "flash_dense_bwd_dkv_wmma", "flash_dense_bwd_dq_wmma", "flash_dense_bwd_db_wmma",
        "qk_norm_rope"}
    assert not any(tfa.launch_counts.values())


@pytest.mark.parametrize("name", ["rms", "layer", "pixel"])
def test_norms(name):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    wgt = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    if name == "rms":
        ref = jnorm.rms_norm(x, wgt, eps=1e-6)
        out = tnorm.rms_norm(_t(x), _t(wgt), eps=1e-6)
    elif name == "layer":
        ref = jnorm.layer_norm(x, wgt, bias, eps=1e-5)
        out = tnorm.layer_norm(_t(x), _t(wgt), _t(bias), eps=1e-5)
    else:
        ref = jnorm.pixel_norm(x)
        out = tnorm.pixel_norm(_t(x))
    # f32 reductions in different order: a few ulp of O(1) values
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=1e-6)


def test_norm_along_channel_dim_matches_channels_last():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 6, 2, 3, 3)).astype(np.float32)
    wgt, bias = rng.standard_normal(6), rng.standard_normal(6)
    ncdhw = tnorm.layer_norm(_t(x), _t(wgt), _t(bias), eps=1e-6, dim=1)
    last = tnorm.layer_norm(_t(x).movedim(1, -1), _t(wgt), _t(bias), eps=1e-6)
    torch.testing.assert_close(ncdhw, last.movedim(-1, 1))


@pytest.mark.parametrize("dim", [20, 64])
def test_precompute_freqs_cis(dim):
    # dim 20: 20 % 6 = 2 leading channels get cos 1, sin 0
    grid = jrope.get_latent_coords(3, 4, 5, batch_size=1)
    grid = grid * jnp.asarray([8.0, 32.0, 32.0]).reshape(1, 3, 1)
    grid = grid.at[:, 0].multiply(1 / 25.0)
    ref = jrope.split_freqs(jrope.precompute_freqs_cis(grid, dim=dim))
    out = trope.split_freqs(trope.precompute_freqs_cis(_t(grid), dim=dim))
    for a, b_ in zip(out, ref):
        # angles reach ~1.6e4 rad; one f32 ulp of the angle is ~1e-3 rad,
        # so cos/sin may differ by that much where the two libraries round
        # a frequency differently
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=2e-3)
    assert np.all(out[0].numpy()[..., : (dim % 6) // 2] == 1.0)


def test_split_rope_matches_interleaved_after_permutation():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, 24)).astype(np.float32)
    grid = jrope.get_latent_coords(1, 2, 3, batch_size=1)
    freqs = jrope.precompute_freqs_cis(grid, dim=24)
    ref = np.asarray(jrope.apply_rotary_emb(x, freqs))
    perm = trope.rope_channel_permutation(24)
    split = trope.split_freqs((_t(freqs[0]), _t(freqs[1])))
    out = trope.apply_rotary_emb_split(_t(x[..., perm]), split)
    np.testing.assert_allclose(out.numpy(), ref[..., perm], atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3, 40])
def test_schedule_and_rf_step(steps):
    shape = (1, 128, 13, 8, 8)
    jsched = jrf.RectifiedFlowSchedule.create(
        sampler="Uniform", shifting="SD3", target_shift_terminal=0.1
    ).set_timesteps(num_inference_steps=steps, samples_shape=shape)
    tsched = trf.RectifiedFlowSchedule.create(
        sampler="Uniform", shifting="SD3", target_shift_terminal=0.1
    ).set_timesteps(num_inference_steps=steps, samples_shape=shape)
    np.testing.assert_array_equal(tsched.sigmas, jsched.sigmas)  # same numpy
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 16, 8)).astype(np.float32)
    v = rng.standard_normal((1, 16, 8)).astype(np.float32)
    sig = np.asarray(jsched.sigmas, np.float32)
    for i in range(steps):
        ref = jrf.rf_step(sig, v, sig[i], x)
        out = trf.rf_step(torch.from_numpy(sig), _t(v), torch.tensor(sig[i]), _t(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_add_noise():
    rng = np.random.default_rng(11)
    x0, eps = (rng.standard_normal((2, 6, 4)).astype(np.float32) for _ in range(2))
    t = np.asarray([0.3, 0.8], np.float32)
    ref = jrf.add_noise(x0, eps, t)
    out = trf.add_noise(_t(x0), _t(eps), _t(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["zeros", "replicate"])
@pytest.mark.parametrize("stride", [1, (2, 2, 2)])
def test_causal_conv3d(causal, mode, stride):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 6, 6, 4)).astype(np.float32)
    kern = rng.standard_normal((3, 3, 3, 4, 8)).astype(np.float32) * 0.2
    bias = rng.standard_normal(8).astype(np.float32)
    ref = jconv3d_params({"kernel": kern, "bias": bias}, x, stride=stride,
                              causal=causal, spatial_padding_mode=mode)
    w = _t(kern.transpose(4, 3, 0, 1, 2))
    out = tconv.conv3d_params({"weight": w, "bias": _t(bias)},
                              _t(x).permute(0, 4, 1, 2, 3), stride=stride,
                              causal=causal, spatial_padding_mode=mode)
    # 108-term f32 sums in different order
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               atol=1e-5)


@pytest.mark.parametrize("fn", ["shuffle", "unshuffle", "patchify", "unpatchify"])
def test_pixel_shuffles(fn):
    rng = np.random.default_rng(8)
    if fn == "shuffle":
        x = rng.standard_normal((1, 2, 3, 3, 24)).astype(np.float32)
        ref = jps.pixel_shuffle_3d(x, (2, 2, 2))
        out = tps.pixel_shuffle_3d(_t(x).permute(0, 4, 1, 2, 3), (2, 2, 2))
    elif fn == "unshuffle":
        x = rng.standard_normal((1, 4, 6, 4, 3)).astype(np.float32)
        ref = jps.pixel_unshuffle_3d(x, (2, 2, 1))
        out = tps.pixel_unshuffle_3d(_t(x).permute(0, 4, 1, 2, 3), (2, 2, 1))
    elif fn == "patchify":
        x = rng.standard_normal((1, 3, 8, 8, 3)).astype(np.float32)
        ref = jps.patchify_pixels(x, 4)
        out = tps.patchify_pixels(_t(x).permute(0, 4, 1, 2, 3), 4)
    else:
        x = rng.standard_normal((1, 3, 2, 2, 48)).astype(np.float32)
        ref = jps.unpatchify_pixels(x, 4)
        out = tps.unpatchify_pixels(_t(x).permute(0, 4, 1, 2, 3), 4)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float", "uint8"])
def test_rgb_to_yuv420(dtype):
    rng = np.random.default_rng(9)
    if dtype == "uint8":
        rgb = rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
        trgb = torch.from_numpy(rgb)
    else:
        rgb = rng.random((2, 8, 12, 3)).astype(np.float32)
        trgb = _t(rgb)
    ref = np.asarray(jcolor.rgb_to_yuv420(rgb)).astype(np.int32)
    out = tcolor.rgb_to_yuv420(trgb).numpy().astype(np.int32)
    assert out.shape == ref.shape
    # the same f32 formula, but a value within an ulp of .5 may round
    # either way when the two compilers order the multiply-adds differently
    assert np.abs(out - ref).max() <= 1
    assert (out == ref).mean() > 0.99
