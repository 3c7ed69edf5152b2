"""The port's windowed long video (``pipelines/long_video.py``) against
the JAX package on the CPU in f32: the window grammar, and two windows
with the reference image, pose frames that run short, the pixel handoff
as a frame-0 item, AdaIN to window 0 and the crossfade, the port fed the
JAX run's draws (its key splits recomputed)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.pipelines import long_video as jlong
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu_torch.pipelines import long_video as tlong
from avatar_tpu_torch.pipelines import pipeline as tpipe
from torch_parity import guided_pipelines

torch.set_num_threads(2)

# the gate PERF.md section 2 uses for tiny pipelines in f32: relative RMS
REL_TOL = 1e-4
SIZE, CH, STEPS = 64, 8, 3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2) / np.mean(b**2))


@pytest.mark.parametrize("total,window,overlap", [
    (1, 97, 9), (97, 97, 9), (98, 97, 9), (185, 97, 9), (400, 97, 17), (25, 17, 9),
    (26, 17, 1)])
def test_window_starts_match_jax(total, window, overlap):
    starts = tlong.window_starts(total, window, overlap)
    assert starts == jlong.window_starts(total, window, overlap)
    assert starts[-1] + window >= total


@pytest.mark.parametrize("kw", [dict(window_frames=96), dict(overlap_frames=8),
                                dict(overlap_frames=97), dict(num_frames=0),
                                dict(window_frames=17, overlap_frames=17)])
def test_long_video_params_validation_matches_jax(kw):
    kw = dict(dict(num_frames=185), **kw)
    with pytest.raises(ValueError) as jerr:
        jlong.LongVideoParams(**kw)
    with pytest.raises(ValueError) as terr:
        tlong.LongVideoParams(**kw)
    assert str(terr.value) == str(jerr.value)


def _window_noise(key, n_windows, window, overlap):
    """The draws of JAX's generate_long_video for ``key``: the reference
    image's encoder draw, then per window (``fold_in(key, i)`` split six
    ways by the pipeline) the pose encoder's draw, the initial noise, the
    handoff item's encoder draw and the decode noise."""
    lat_hw, lat_f = SIZE // 32, (window - 1) // 8 + 1
    k_ref, key = jax.random.split(key)
    ref_noise = _t(jax.random.normal(k_ref, (1, 1, lat_hw, lat_hw, CH)))
    noise = []
    for i in range(n_windows):
        k_win = jax.random.fold_in(key, i)
        _, k_pose, k_lat, k_cond, _, _ = jax.random.split(k_win, 6)
        d = {"pose_noise": _t(jax.random.normal(k_pose, (1, lat_f, lat_hw, lat_hw, CH))),
             "init_noise": _t(jax.random.normal(jax.random.split(k_lat, 1)[0],
                                                (lat_f, lat_hw, lat_hw, CH))[None]),
             "decode_noise": _t(jax.random.normal(jax.random.fold_in(k_win, 7),
                                                  (1, lat_f, lat_hw, lat_hw, CH)))}
        if i:
            k_enc = jax.random.split(k_cond, 3)[0]
            d["item_noise"] = [_t(jax.random.normal(
                k_enc, (1, (overlap - 1) // 8 + 1, lat_hw, lat_hw, CH)))]
        noise.append(d)
    return ref_noise, noise


@pytest.mark.parametrize("blend,adain", [(True, True), (False, False)])
def test_generate_long_video_matches_jax(blend, adain):
    """25 frames as two 17-frame windows overlapping by 9, pose frames for
    21 (the last window is padded with the last frame)."""
    jp, tp = guided_pipelines()
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    mask[0, 6:] = 0.0
    ref = rng.uniform(-1, 1, (1, 1, SIZE, SIZE, 3)).astype(np.float32)
    pose = rng.uniform(-1, 1, (1, 21, SIZE, SIZE, 3)).astype(np.float32)
    base = dict(height=SIZE, width=SIZE, num_frames=16, frame_rate=25.0,
                num_inference_steps=STEPS, guidance_scale=1.0, stg_scale=0.0,
                rescaling_scale=1.0, decode_timestep=0.05)
    long = dict(num_frames=25, window_frames=17, overlap_frames=9, blend_overlap=blend,
                adain_anchor=adain)
    key = jax.random.PRNGKey(11)
    want = jlong.generate_long_video(
        jp, jpipe.GenerationParams(**base), jlong.LongVideoParams(**long), key,
        jnp.asarray(embeds), jnp.asarray(mask), ref_image=jnp.asarray(ref),
        pose_frames=jnp.asarray(pose), dtype=jnp.float32)
    ref_noise, window_noise = _window_noise(key, 2, 17, 9)
    got = tlong.generate_long_video(
        tp, tpipe.GenerationParams(**base), tlong.LongVideoParams(**long),
        torch.Generator(), _t(embeds), _t(mask), ref_image=_t(ref), pose_frames=_t(pose),
        dtype=torch.float32, ref_noise=ref_noise, window_noise=window_noise)
    assert got.shape == want.shape == (1, 25, SIZE, SIZE, 3)
    assert _rel_rms(got.numpy(), want) < REL_TOL
    with pytest.raises(ValueError, match="output_type"):
        tlong.generate_long_video(tp, tpipe.GenerationParams(**base),
                                  tlong.LongVideoParams(**long), torch.Generator(),
                                  _t(embeds), _t(mask), output_type="latent")


def test_slice_pose_pads_with_the_last_frame():
    pose = np.arange(5, dtype=np.float32).reshape(1, 5, 1, 1, 1) * np.ones((1, 5, 2, 2, 3),
                                                                           np.float32)
    for start, frames in ((0, 3), (2, 3), (3, 4)):
        np.testing.assert_array_equal(tlong._slice_pose(_t(pose), start, frames).numpy(),
                                      np.asarray(jlong._slice_pose(jnp.asarray(pose), start,
                                                                   frames)))


def test_dataclass_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tlong.LongVideoParams)] == [
        f.name for f in dataclasses.fields(jlong.LongVideoParams)]
