"""The port's DiT under the config options the shipped 2B model leaves at
their defaults, against the JAX package on the CPU in f32: the AdaLN
variant ``single_scale``, layer-norm standardization and q/k norm, exact
GELU, affine norms, linears without bias and a feed-forward of 2x. Each
runs under ``attention_impl="xla"`` (plain attention on both sides) and
"flash" (the JAX side's Pallas kernels in interpret mode, the port's plain
kernel versions). Weights are initialised in JAX and carried across with
``dit_params_from_numpy``."""

import jax
import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.ops import rope as jrope
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy

torch.set_num_threads(2)

BASE = dict(num_attention_heads=4, attention_head_dim=16, in_channels=16,
            out_channels=16, num_layers=2, cross_attention_dim=64, caption_channels=96)
B, F, H, W, LK = 2, 2, 4, 8, 16
# f32 through two blocks: the two packages sum in other orders (3.7e-6 to
# 4.6e-6 max abs measured on outputs of up to 4, every variant and impl);
# 2e-5 leaves room for that, where a wrong norm, activation or bias would
# miss by 1e-2 or more
ATOL = 2e-5

VARIANTS = {
    "adaptive_norm_single_scale": dict(adaptive_norm="single_scale"),
    "standardization_layer_norm": dict(standardization_norm="layer_norm"),
    "qk_norm_layer_norm": dict(qk_norm="layer_norm"),
    "activation_gelu": dict(activation_fn="gelu"),
    "norm_elementwise_affine": dict(norm_elementwise_affine=True),
    "attention_bias_false": dict(attention_bias=False),
    "ff_mult_2": dict(ff_mult=2),
}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _models(variant):
    kw = dict(BASE, **VARIANTS[variant])
    jcfg, tcfg = jdit.DiTConfig(**kw), tdit.DiTConfig(**kw)
    jparams = jdit.init_dit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    # norm affines and biases away from their init (1 and 0), so that a
    # dropped or misplaced one shows
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if any(w in jax.tree_util.keystr(path) for w in ("norm", "bias")) else x,
        jparams)
    tparams = dit_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return (jcfg, jdit.permute_dit_params_for_split_rope(jparams, jcfg), tcfg,
            tdit.permute_dit_params_for_split_rope(tparams, tcfg))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dit_variant_matches_jax(variant, impl):
    jcfg, jp, tcfg, tp = _models(variant)
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((B, F * H * W, 16)).astype(np.float32)
    text = rng.standard_normal((B, LK, 96)).astype(np.float32)
    mask = np.ones((B, LK), np.float32)
    mask[0, 10:] = 0.0
    grid = jrope.get_latent_coords(F, H, W, batch_size=B)
    t = np.asarray([0.5, 0.25], np.float32)
    ref = jdit.dit_apply(jp, jcfg, tokens, grid, t, text, mask, attention_impl=impl,
                         rope_split=True)
    out = tdit.dit_apply(tp, tcfg, _t(tokens), _t(grid), _t(t), _t(text), _t(mask),
                         attention_impl=impl)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
