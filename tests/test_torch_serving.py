"""The port's serving layer (``avatar_tpu_torch/pipelines/serving.py``) on
the CPU: dynamic batching, batch-composition independence, bucket
isolation and errors, and the media-latent cache, as
``tests/test_serving.py`` holds the JAX server, on a port pipeline with
f32 weights and that test's sizes (served in bf16, as there); the host
logic (the bucket key's partition and the cache's hits and misses)
against the JAX package's on one request stream; and ``sample_seeds``. The server's noise comes from ``torch`` generators,
so its videos are not compared with the JAX server's."""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu.pipelines import serving as jserving
from avatar_tpu_torch.diffusion.rf import RectifiedFlowSchedule
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.pipelines import (
    AvatarServer,
    GenerationParams,
    GenerationRequest,
    LTXVideoPipeline,
)
from avatar_tpu_torch.pipelines import serving as tserving

torch.set_num_threads(2)

H = W = 64
FRAMES = 9


@pytest.fixture(scope="module")
def pipeline():
    vae_cfg = dataclasses.replace(tvae.demo_config(latent_channels=8), base_channels=32,
                                  decoder_base_channels=32)
    dit_cfg = tdit.DiTConfig(num_attention_heads=4, attention_head_dim=8, in_channels=8,
                             out_channels=8, num_layers=2, cross_attention_dim=32,
                             caption_channels=32)
    return LTXVideoPipeline(
        dit_cfg, tdit.init_dit(dit_cfg, seed=1, device="cpu"),
        vae_cfg, tvae.init_vae(vae_cfg, seed=0, device="cpu"),
        schedule=RectifiedFlowSchedule.create(sampler="Uniform", shifting="SD3",
                                              target_shift_terminal=0.1),
        attention_impl="xla", device="cpu")


def _request(seed=0, steps=2, output_type="np"):
    rng = np.random.default_rng(40 + seed)
    return GenerationRequest(
        params=GenerationParams(
            height=H, width=W, num_frames=FRAMES, frame_rate=25.0,
            num_inference_steps=steps, guidance_scale=1.0, stg_scale=0.0,
            rescaling_scale=1.0, decode_timestep=0.0),
        prompt_embeds=rng.standard_normal((1, 8, 32)).astype(np.float32),
        prompt_attention_mask=np.ones((1, 8), np.float32),
        seed=seed, output_type=output_type)


def test_batching_and_results(pipeline):
    server = AvatarServer(pipeline, max_batch=4, batch_window_s=0.5)
    futs = [server.submit(_request(seed=i)) for i in range(3)]
    vids = [f.result(timeout=600) for f in futs]
    server.shutdown()
    for v in vids:
        assert isinstance(v, np.ndarray) and v.shape == (FRAMES, H, W, 3)
        assert np.isfinite(v).all()
    # same-bucket requests coalesced into one pipeline call
    assert server.stats == {"requests": 3, "batches": 1}
    assert not np.allclose(vids[0], vids[1])


def test_batch_composition_independence(pipeline):
    """A request's output is the same whether served alone or batched."""
    server = AvatarServer(pipeline, max_batch=4, batch_window_s=0.5)
    futs = [server.submit(_request(seed=s)) for s in (7, 8)]
    batched = [f.result(timeout=600) for f in futs]
    server.shutdown()
    assert server.stats["batches"] == 1
    solo_server = AvatarServer(pipeline, max_batch=1, batch_window_s=0.0)
    solo = solo_server.submit(_request(seed=7)).result(timeout=600)
    solo_server.shutdown()
    np.testing.assert_allclose(batched[0], solo, atol=1e-5)


def test_bucket_isolation_and_errors(pipeline):
    """Different buckets go to different batches; a bad request fails only
    its own future."""
    server = AvatarServer(pipeline, max_batch=4, batch_window_s=0.5)
    ok = server.submit(_request(seed=1))
    other = server.submit(_request(seed=2, steps=3))  # another bucket
    bad_req = _request(seed=3)
    bad_req.prompt_embeds = np.zeros((1, 8, 999), np.float32)  # wrong caption width
    bad = server.submit(bad_req)
    assert ok.result(timeout=600).shape == (FRAMES, H, W, 3)
    assert other.result(timeout=600).shape == (FRAMES, H, W, 3)
    with pytest.raises(Exception):
        bad.result(timeout=600)
    server.shutdown()
    assert server.stats["batches"] >= 2


def test_media_latent_cache(pipeline):
    """Avatar media are VAE-encoded once per distinct host array and reused
    as cached latents; results do not depend on the batch; without the
    cache the pixels ride with the batch."""
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((1, 1, H, W, 3)).astype(np.float32)
    pose = rng.standard_normal((1, FRAMES, H, W, 3)).astype(np.float32)

    def req(seed):
        r = _request(seed=seed)
        r.ref_image = ref
        r.pose_frames = pose
        return r

    server = AvatarServer(pipeline, max_batch=4, batch_window_s=0.5)
    futs = [server.submit(req(seed=i)) for i in range(3)]
    vids = [f.result(timeout=600) for f in futs]
    server.shutdown()
    # one encode per distinct array (ref + pose), the rest hits
    assert (server._media_cache.misses, server._media_cache.hits) == (2, 4)
    for v in vids:
        assert v.shape == (FRAMES, H, W, 3) and np.isfinite(v).all()
    assert not np.allclose(vids[0], vids[1])  # per-request noise still rules

    solo = AvatarServer(pipeline, max_batch=1, batch_window_s=0.0)
    alone = solo.submit(req(seed=0)).result(timeout=600)
    solo.shutdown()
    np.testing.assert_allclose(vids[0], alone, atol=1e-5)

    legacy = AvatarServer(pipeline, max_batch=4, batch_window_s=0.5, media_cache_size=0)
    out = legacy.submit(req(seed=0)).result(timeout=600)
    legacy.shutdown()
    assert legacy._media_cache.misses == 0
    assert out.shape == (FRAMES, H, W, 3) and np.isfinite(out).all()


# one value other than the default for every GenerationParams field, by
# package (the skip-layer strategy is each package's own enum)
def _varied(skip_strategy):
    return {
        "height": 128, "width": 96, "num_frames": 17, "frame_rate": 30.0,
        "num_inference_steps": 3, "skip_initial_inference_steps": 1,
        "skip_final_inference_steps": 1, "guidance_scale": [1.0, 3.0],
        "stg_scale": 0.5, "rescaling_scale": [0.7, 0.0],
        "guidance_timesteps": [1.0, 0.5], "cfg_star_rescale": True,
        "skip_layer_strategy": skip_strategy, "skip_block_list": [[1], [0, 1]],
        "decode_timestep": 0.05, "decode_noise_scale": [0.025],
        "tone_map_compression_ratio": 0.5,
        "stochastic_sampling": True, "image_cond_noise_scale": 0.15, "is_video": False,
        "vae_per_channel_normalize": False, "solver": "heun",
    }


def _stream(package, params_cls, skip_strategy):
    """Requests of one stream: the base twice, each field varied (twice),
    and each shape field varied."""
    base = dict(height=H, width=W, num_frames=FRAMES)
    embeds = np.zeros((1, 8, 32), np.float32)
    mask = np.ones((1, 8), np.float32)
    pixels = np.zeros((1, 1, H, W, 3), np.float32)

    def req(params=None, **kw):
        p = params_cls(**dict(base, **(params or {})))
        return package.GenerationRequest(p, kw.pop("embeds", embeds), mask, **kw)

    varied = _varied(skip_strategy)
    assert set(varied) == {f.name for f in dataclasses.fields(params_cls)}
    out = [req(), req()]
    for name, value in varied.items():
        out += [req({name: value}), req({name: value})]
    out += [req(embeds=np.zeros((1, 16, 32), np.float32)), req(ref_image=pixels),
            req(pose_frames=pixels), req(output_type="np"), req(output_type="uint8")]
    return out


def _partition(keys):
    return [[j for j, other in enumerate(keys) if other == k] for k in keys]


def test_bucket_key_partition_matches_jax():
    """Both packages' bucket keys split one request stream alike: every
    GenerationParams field and every shape field opens its own bucket."""
    tkeys = [tserving._bucket_key(r) for r in _stream(
        tserving, GenerationParams, tdit.SkipLayerStrategy.AttentionValues)]
    jkeys = [jserving._bucket_key(r) for r in _stream(
        jserving, jpipe.GenerationParams, jdit.SkipLayerStrategy.AttentionValues)]
    assert _partition(tkeys) == _partition(jkeys)
    assert len(set(tkeys)) == 1 + len(_varied(None)) + 5


def test_latent_cache_hits_match_jax():
    """The same stream of lookups gives the same hits and misses in both
    packages' caches: LRU at capacity 2, and an array dropped by its
    caller is never a hit (its id() may come back on a new array)."""

    def run(cache_cls):
        cache, log = cache_cls(2), []
        arrays = [np.full((4,), i, np.float32) for i in range(3)]

        def get(media, extra=True):
            before = cache.hits
            cache.get(media, extra, lambda m: m.sum())
            log.append(("hit" if cache.hits > before else "miss", len(cache._entries)))

        for i in (0, 1, 0, 2, 1, 0, 0):
            get(arrays[i])
        get(arrays[0], extra=False)
        del arrays[2]
        gc.collect()
        # new arrays, some of which may take the dropped one's id()
        reborn = [np.zeros((4,), np.float32) for _ in range(8)]
        for a in reborn:
            get(a)
        get(arrays[1])
        get(reborn[-1])
        return log, cache.hits, cache.misses

    assert run(tserving._LatentCache) == run(jserving._LatentCache)


def test_sample_seeds_make_each_sample_independent_of_the_batch(pipeline):
    """With ``sample_seeds`` sample i's initial noise depends on its seed
    alone: the same in a batch of 2 as alone, whatever the batch
    generator."""
    shape = (2, 2, 2, 2, 8)
    pair = pipeline.prepare_latents(torch.Generator().manual_seed(0), shape, torch.float32,
                                    sample_seeds=[7, 8])
    for i, seed in enumerate((7, 8)):
        alone = pipeline.prepare_latents(torch.Generator().manual_seed(5), (1, *shape[1:]),
                                         torch.float32, sample_seeds=[seed])
        assert torch.equal(pair[i:i + 1], alone)
    assert not torch.equal(pair[0], pair[1])
    with pytest.raises(ValueError):
        pipeline.prepare_latents(torch.Generator(), shape, torch.float32, sample_seeds=[7])


def test_outputs_reach_the_host_as_numpy(pipeline):
    """I420 planes as uint8; the bf16 float frames as f32 (numpy has no
    bf16)."""
    server = AvatarServer(pipeline, max_batch=2, batch_window_s=0.0)
    yuv = server.submit(_request(seed=1, output_type="yuv420"))
    frames = server.submit(_request(seed=1, output_type="np"))
    yuv, frames = yuv.result(timeout=600), frames.result(timeout=600)
    server.shutdown()
    assert yuv.dtype == np.uint8 and yuv.shape == (FRAMES, H * 3 // 2, W)
    assert frames.dtype == np.float32 and frames.shape == (FRAMES, H, W, 3)
    assert np.isfinite(frames).all() and server.stats["batches"] == 2
