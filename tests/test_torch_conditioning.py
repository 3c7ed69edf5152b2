"""The port's conditioning items against the JAX ``LTXVideoPipeline`` on the
CPU, in f32, end to end to the denoised latents: a first frame resized up,
with ``image_cond_noise_scale`` and CFG; an off-centre item at
``media_x``/``media_y`` beside a sequence at frame 8 resized down, its
two-frame prefix riding along as extra tokens; ``prepare_conditioning``'s
mask, tokens and coordinates; the resize itself against
``jax.image.resize``. The port receives the JAX pipeline's own draws (its
key splits, recomputed in ``torch_parity.run_conditioned``) as tensors.
``media_items``, ``latents`` and ``allowed_inference_steps`` are in
``tests/test_torch_conditioning_inputs.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.pipelines import pipeline as tpipe
from torch_parity import COND_CH, cond_media, guided_pipelines, run_conditioned

torch.set_num_threads(2)

# f32 through VAE encodes and 3 DiT steps of two blocks (CFG 3 in one case):
# summation order only
ATOL = RTOL = 2e-4
CH = COND_CH


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def pipes():
    return guided_pipelines()


CASES = {
    # a first frame at 32 px resized up to 64, image-to-video noise, CFG 3
    "first_frame_resize_up_noise_cfg": dict(
        size=64, frames=9, items=[(cond_media(1, 1, 32), 0, 1.0, None, None)],
        settings=dict(image_cond_noise_scale=0.15, guidance_scale=3.0)),
    # in a 128 px frame: 64 px at x = 64, y = 0 (the border strip keeps one
    # latent column), and a 17-frame sequence at frame 8 resized down from
    # 160 px (frame 3 lerped in place, its first two latent frames as 32
    # extra tokens)
    "off_centre_and_sequence_resize_down": dict(
        size=128, frames=25, items=[(cond_media(3, 1, 64), 0, 1.0, 64, 0),
                                    (cond_media(2, 17, 160), 8, 0.9, None, None)],
        settings=dict(image_cond_noise_scale=0.1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_conditioning_items_match_jax(pipes, case):
    out, ref = run_conditioned(pipes, **CASES[case])
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("src,dst", [(32, 64), (128, 64), (96, 64)],
                         ids=["up", "down", "down_non_integer"])
def test_resize_media_matches_jax_image_resize(src, dst):
    media = cond_media(7, 9, src)
    ref = jax.image.resize(jnp.asarray(media), (1, 9, dst, dst, 3), method="bilinear")
    out = tpipe.resize_media(_t(media), dst, dst)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def test_prepare_conditioning_mask_and_extra_tokens(pipes):
    """The conditioning mask, the prefix tokens' count and their shifted
    time coordinates, against the JAX package's prepare_conditioning."""
    jp, tp = pipes
    seq = cond_media(8, 17, 64)
    init = np.zeros((1, 4, 2, 2, CH), np.float32)
    j_items = [jpipe.ConditioningItem(jnp.asarray(seq), 8, 0.7)]
    jt, jc, jm, jn = jp.prepare_conditioning(j_items, jnp.asarray(init), jax.random.PRNGKey(1))
    k_enc, k_noise, _ = jax.random.split(jax.random.PRNGKey(1), 3)
    enc = _t(jax.random.normal(k_enc, (1, 3, 2, 2, CH)))
    pre = _t(jax.random.normal(k_noise, (1, 2, 2, 2, CH)))
    tt, tc, tm, tn = tp.prepare_conditioning(
        [tpipe.ConditioningItem(_t(seq), 8, 0.7)], _t(init), None, True, [enc], [pre])
    assert tn == jn == 8
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL, rtol=RTOL)
