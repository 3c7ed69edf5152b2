"""Conditioning items under guidance, the port against the JAX pipeline on
the CPU in f32, end to end to the denoised latents: STG with each of the
two attention strategies (AttentionValues, AttentionSkip) beside CFG,
Heun, stochastic sampling and ``cfg_star_rescale``. The items are a first
frame resized up and, for stochastic sampling, a sequence at frame 8 whose
prefix rides along as extra tokens (so the sampling noise covers them).
The JAX side runs its Pallas kernels in interpret mode; the port is fed the
JAX pipeline's draws (``torch_parity.run_conditioned``)."""

import numpy as np
import pytest
import torch

from torch_parity import cond_media, guided_pipelines, run_conditioned

torch.set_num_threads(2)

# f32 through VAE encodes and 3 guided DiT steps of two blocks (up to 5
# model evaluations with Heun), the guidance scaling the summation-order
# differences: 1.7e-6 to 3.6e-6 max abs measured on latents of up to 5;
# 2e-5 leaves room for that, where a wrong guidance or noise term misses by
# 1e-2 or more
ATOL = 2e-5

FIRST_FRAME = [(cond_media(1, 1, 32), 0, 1.0, None, None)]
STG = dict(guidance_scale=3.0, stg_scale=1.0, rescaling_scale=0.7, skip_block_list=[1])

CASES = {
    "stg_attention_values": dict(size=64, frames=9, items=FIRST_FRAME, settings=dict(
        STG, skip_layer_strategy="AttentionValues")),
    "stg_attention_skip": dict(size=64, frames=9, items=FIRST_FRAME, settings=dict(
        STG, skip_layer_strategy="AttentionSkip")),
    "heun_cfg": dict(size=64, frames=9, items=FIRST_FRAME, settings=dict(
        guidance_scale=3.0, solver="heun")),
    "stochastic_sequence_at_8": dict(
        size=64, frames=25, items=[(cond_media(2, 9, 64), 8, 0.9, None, None)],
        settings=dict(stochastic_sampling=True, image_cond_noise_scale=0.1)),
    "cfg_star_rescale": dict(size=64, frames=9, items=FIRST_FRAME, settings=dict(
        guidance_scale=3.0, cfg_star_rescale=True)),
}


@pytest.fixture(scope="module")
def pipes():
    return guided_pipelines()


@pytest.mark.parametrize("case", list(CASES))
def test_conditioned_guided_walk_matches_jax(pipes, case):
    out, ref = run_conditioned(pipes, **CASES[case])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
