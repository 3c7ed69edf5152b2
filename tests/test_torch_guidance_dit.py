"""``dit_apply`` of the PyTorch port against the JAX package's, on the CPU
in f32: every ``SkipLayerStrategy``, both RoPE layouts, both attention
paths, both block layouts, per-token timesteps and the long-sequence
flash kernels.

The JAX side runs its Pallas kernels in interpret mode
(``attention_impl="flash"``); the port runs the plain versions of its
kernels. Weights are initialised in JAX and carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.ops import rope as jrope
from avatar_tpu.parallel.pipeline import stack_block_params as jstack
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.ops import flash_attention as tfa
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy

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


def _both(models, grid_shape, rope_split=True, impl="flash", stacked=False,
          port_only=False, **kw):
    """The same call through the JAX ``dit_apply`` and the port's (the JAX
    one is skipped, and None returned for it, with ``port_only``)."""
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
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out = tdit.dit_apply(tparams, tcfg, _t(tokens), _t(grid), _t(t), _t(text),
                         _t(mask), attention_impl=impl, rope_split=rope_split, **tkw)
    if port_only:
        return out.numpy(), None
    ref = jdit.dit_apply(jparams, jcfg, tokens, grid, t, text, mask,
                         attention_impl=impl, rope_split=rope_split, **jkw)
    return out.numpy(), np.asarray(ref)


SKIP_MASK = np.asarray([[1, 1, 0], [1, 0, 1]], np.float32)  # [layers, B]


@pytest.fixture(scope="module")
def unperturbed(models):
    """The port's output without a skip mask, by grid shape."""
    return {shape: _both(models, shape, port_only=True)[0]
            for shape in ((2, 4, 8), (3, 3, 7))}


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
