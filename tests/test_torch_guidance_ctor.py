"""The guided denoising walk of the PyTorch port against the JAX package's
under the pipeline's constructor options (RoPE layout, stacked blocks,
attention path), on the CPU in f32. The port receives JAX's own initial
latents and per-step noise (``torch_parity.run_guided_walk``).
"""

import numpy as np
import pytest
import torch

from torch_parity import PIPE_ATOL, SHIPPED, guided_pipelines, run_guided_walk

torch.set_num_threads(2)


@pytest.mark.parametrize("ctor", [
    dict(rope_split=False), dict(scan_blocks=True), dict(attention_impl="xla"),
    dict(attention_impl="auto"),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_guided_walk_ctor_options_match_jax(ctor):
    """17 frames: 12 tokens, not a multiple of 8, so both sides take the
    head-major path (the whole-row flash kernel, or plain attention under
    "xla") with RoPE in plain code."""
    out, ref = run_guided_walk(guided_pipelines(**ctor), 17, SHIPPED)
    np.testing.assert_allclose(out, ref, atol=PIPE_ATOL, rtol=PIPE_ATOL)
