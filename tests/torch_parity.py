"""Helpers shared by the ``test_torch_*`` parity tests (not a test module)."""

import jax
import numpy as np

from avatar_tpu.models import vae as jvae


def vae_numpy_params(cfg, seed: int = 7) -> dict:
    """JAX-layout VAE params with ``init_vae``'s tree and scales, filled
    from a numpy seed. ``jax.eval_shape`` gives the tree; an eager JAX init
    of a 2B-kind config takes tens of seconds on the CPU."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if shape == ():
            return np.float32(1000.0)  # the decoder's timestep multiplier
        if len(shape) in (2, 5) and "kernel" in name:  # linear / conv
            bound = np.sqrt(3.0 / np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if "std_of_means" in name or "scale'" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvae.init_vae(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)
