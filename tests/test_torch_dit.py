"""Parity of the PyTorch port's DiT with the JAX package, on the CPU.

A tiny config (4 heads x 16, 2 layers) is initialised in JAX and carried
across with ``dit_params_from_numpy``; both sides then permute into the
split-RoPE layout themselves. The JAX side runs its Pallas attention
kernels in interpret mode (``attention_impl="flash"``), the port its plain
kernel versions. Comparisons in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.ops import flash_attention as jfa
from avatar_tpu.ops import rope as jrope
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.ops import rope as trope
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy

torch.set_num_threads(2)

CFG_KW = dict(
    num_attention_heads=4, attention_head_dim=16, in_channels=16,
    out_channels=16, num_layers=2, cross_attention_dim=64, caption_channels=96,
)
B, F, H, W, LK = 2, 2, 4, 8, 16
# f32 through two blocks of O(1) activations: summation-order differences
# of ~1e-6 per op, a few hundred ops deep
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jdit.DiTConfig(**CFG_KW), tdit.DiTConfig(**CFG_KW)
    jparams = jdit.init_dit(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = dit_params_from_numpy(tree, tcfg, device="cpu")
    return (jcfg, jdit.permute_dit_params_for_split_rope(jparams, jcfg),
            tcfg, tdit.permute_dit_params_for_split_rope(tparams, tcfg))


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((B, F * H * W, 16)).astype(np.float32)
    text = rng.standard_normal((B, LK, 96)).astype(np.float32)
    mask = np.ones((B, LK), np.float32)
    mask[0, 10:] = 0.0  # padded caption keys
    mask[1] = 0.0  # every caption key masked: both kernels give 0 there
    return tokens, text, mask


@pytest.mark.parametrize("hoisted", [True, False])
def test_dit_apply_matches_jax(models, hoisted):
    jcfg, jp, tcfg, tp = models
    tokens, text, mask = _inputs()
    grid = jrope.get_latent_coords(F, H, W, batch_size=B)
    sigmas = jnp.asarray([0.9, 0.5, 0.0], jnp.float32)
    inner = jcfg.inner_dim
    assert jfa.rope_fused_supports(F * H * W, 4, 16, jnp.float32)
    assert jfa.fused_supports(F * H * W, LK, 4, 16, jnp.float32)

    if hoisted:
        jfreqs = jrope.split_freqs(jrope.precompute_freqs_cis(grid, dim=inner))
        jkv, _ = jdit.precompute_cross_attention_kv(jp, jcfg, text)
        jtab = jdit.precompute_timestep_tables(jp, jcfg, sigmas, B, jnp.float32)
        ref = jdit.dit_apply(
            jp, jcfg, tokens, grid, None, None, mask, attention_impl="flash",
            rope_split=True, freqs_cis=jfreqs, cross_kv=jkv,
            timestep_tables=(jtab[0][1], jtab[1][1]),
        )
        tfreqs = trope.split_freqs(trope.precompute_freqs_cis(_t(grid), dim=inner))
        tkv, _ = tdit.precompute_cross_attention_kv(tp, tcfg, _t(text))
        ttab = tdit.precompute_timestep_tables(tp, tcfg, _t(sigmas), B, torch.float32)
        out = tdit.dit_apply(
            tp, tcfg, _t(tokens), encoder_attention_mask=_t(mask),
            freqs_cis=tfreqs, cross_kv=tkv,
            timestep_tables=(ttab[0][1], ttab[1][1]),
        )
    else:
        t = np.asarray([0.5, 0.25], np.float32)
        ref = jdit.dit_apply(jp, jcfg, tokens, grid, t, text, mask,
                             attention_impl="flash", rope_split=True)
        out = tdit.dit_apply(tp, tcfg, _t(tokens), _t(grid), _t(t), _t(text),
                             _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_split_rope_permutation_preserves_the_model(models):
    """The JAX XLA path on UNPERMUTED params equals the port's split-RoPE
    path: the permutation is exact and applied once."""
    jcfg, _, tcfg, tp = models
    jparams = jdit.init_dit(jax.random.PRNGKey(0), jcfg)
    tokens, text, _ = _inputs()
    mask = np.ones((B, LK), np.float32)  # XLA path and kernels agree here
    grid = jrope.get_latent_coords(F, H, W, batch_size=B)
    t = np.asarray([0.7, 0.7], np.float32)
    ref = jdit.dit_apply(jparams, jcfg, tokens, grid, t, text, mask,
                         attention_impl="xla")
    out = tdit.dit_apply(tp, tcfg, _t(tokens), _t(grid), _t(t), _t(text), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_avatar_condition_tokens():
    rng = np.random.default_rng(1)
    tokens = rng.standard_normal((1, 3 * 2 * 2, 4)).astype(np.float32)
    ref_lat = rng.standard_normal((1, 1, 2, 2, 4)).astype(np.float32)
    pose = rng.standard_normal((1, 3, 2, 2, 4)).astype(np.float32)
    ref = jdit.avatar_condition_tokens(tokens, ref_lat, pose)
    out = tdit.avatar_condition_tokens(_t(tokens), _t(ref_lat), _t(pose))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_init_dit_matches_jax_tree_and_scales():
    """The port's seeded init has the JAX init's tree, shapes (in PyTorch
    layout) and scales."""
    cfg_kw = dict(CFG_KW, num_attention_heads=8, attention_head_dim=32,
                  cross_attention_dim=256)
    jtree = jax.tree.map(np.asarray, jdit.init_dit(
        jax.random.PRNGKey(0), jdit.DiTConfig(**cfg_kw)))
    expect = dit_params_from_numpy(jtree, tdit.DiTConfig(**cfg_kw), device="cpu")
    got = tdit.init_dit(tdit.DiTConfig(**cfg_kw), seed=3, device="cpu")
    flat_e = dict(_flatten(expect))
    flat_g = dict(_flatten(got))
    assert flat_e.keys() == flat_g.keys()
    for key, e in flat_e.items():
        g = flat_g[key]
        assert g.shape == e.shape, key
        if e.numel() >= 1024:  # same distribution: std within 10%
            assert abs(g.std().item() / e.std().item() - 1) < 0.1, key


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
