"""The port's preprocessing CLI against the JAX package's, on the CPU:
the host helpers bit for bit (``preprocess_frames`` on PIL and array
frames and as uint8, ``iter_clips``, ``save_latents_and_meta`` in both
formats), ``VAEEncoder`` in f32 against the JAX one fed the same draw, the
port's uint8 path against its float path bit for bit, and the
``save-vae-latents`` (with ``--save_pixels``) and ``save-video-clips``
subcommands of both packages on two synthetic mp4s (written with cv2 as
``tests/test_preprocess.py`` writes them): the same files, metadata and
pixels, and latents within the bf16 limit with the JAX draws injected.
The tiny checkpoint is written by the JAX package."""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from avatar_tpu.cli import preprocess as jpre
from avatar_tpu.models import dit as jdit
from avatar_tpu.models import vae as jvae
from avatar_tpu.utils import weight_import as jwi
from avatar_tpu_torch.cli import preprocess as tpre
from avatar_tpu_torch.utils.safetensors_io import load_safetensors
from torch_parity import dit_numpy_params, vae_numpy_params

torch.set_num_threads(2)

LATENT_CH = 8
H, W = 64, 96  # multiples of the tiny VAE's 32x spatial factor
CLIP = 9
# f32 on both sides through the VAE's convs; bf16 runs held at the repo's
# bf16 limit
F32_TOL = 1e-5
BF16_TOL = 0.02


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def write_checkpoint(path):
    """A single-file checkpoint of a tiny DiT and VAE (per-channel
    statistics away from 0 / 1), written by the JAX package."""
    dcfg = jdit.DiTConfig(num_attention_heads=2, attention_head_dim=8, in_channels=LATENT_CH,
                          out_channels=LATENT_CH, num_layers=1, cross_attention_dim=16,
                          caption_channels=32)
    vcfg = dataclasses.replace(jvae.demo_config(latent_channels=LATENT_CH), base_channels=32,
                               decoder_base_channels=32)
    vae = jax.tree.map(jnp.asarray, vae_numpy_params(vcfg))
    jwi.save_single_file_checkpoint(
        path, jax.tree.map(jnp.asarray, dit_numpy_params(dcfg)), dcfg,
        vae_state=jwi.export_vae_state(vae, vcfg), vae_config=vcfg.to_dict(),
        scheduler_config={"_class_name": "RectifiedFlowScheduler",
                          "num_train_timesteps": 1000, "sampler": "Uniform"})
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("pre_ckpt") / "ckpt.safetensors")


def write_video(path, num_frames, seed=7, size=(H + 8, W + 16)):
    import cv2

    h, w = size
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
    base = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    for i in range(num_frames):
        wr.write(np.roll(base, 2 * i, axis=1))
    wr.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Two mp4s: two 9-frame clips each, the second with 4 frames left
    over (no third clip)."""
    d = tmp_path_factory.mktemp("vids")
    write_video(d / "v0.mp4", 2 * CLIP, seed=7)
    write_video(d / "v1.mp4", 2 * CLIP + 4, seed=8)
    return d


def jax_draw(seed, shape, dtype):
    """The JAX encoder's posterior draw: ``jax.random.normal`` of
    ``PRNGKey(seed)`` in the moments' dtype, as f32."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jdt).astype(jnp.float32)))


def latent_shape(cfg, media_shape):
    f, h, w = media_shape[1:4]
    s = cfg.spatial_downscale_factor
    return (1, (f - 1) // cfg.temporal_downscale_factor + 1, h // s, w // s,
            cfg.latent_channels)


def inject_jax_draws(monkeypatch):
    """Make the port's ``VAEEncoder.encode`` take the JAX encoder's draw
    for its seed (the two generators cannot agree)."""
    real = tpre.VAEEncoder.encode

    def encode(self, media, seed, per_channel=True, noise=None):
        noise = jax_draw(seed, latent_shape(self.cfg, media.shape), self.dtype)
        return real(self, media, seed, per_channel, noise=noise)

    monkeypatch.setattr(tpre.VAEEncoder, "encode", encode)


def test_preprocess_frames_matches_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 255, (40, 52, 3), np.uint8) for _ in range(5)]
    images = [Image.fromarray(a) for a in arrays]
    rgba = [Image.fromarray(a).convert("RGBA") for a in arrays[:2]]
    for frames in (images, arrays, arrays[:1], rgba):
        for as_uint8 in (False, True):
            got = tpre.preprocess_frames(frames, 32, 48, as_uint8=as_uint8)
            ref = jpre.preprocess_frames(frames, 32, 48, as_uint8=as_uint8)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="No frames"):
        tpre.preprocess_frames([], 32, 48)


@pytest.mark.parametrize("num_frames", [0, 8, 9, 57, 58, 121, 200])
@pytest.mark.parametrize("clip_length,stride", [(9, 9), (57, 57), (57, 30), (9, 0), (1, 1)])
def test_iter_clips_matches_jax(num_frames, clip_length, stride):
    assert tpre.iter_clips(num_frames, clip_length, stride) == jpre.iter_clips(
        num_frames, clip_length, stride)


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
@pytest.mark.parametrize("is_reference", [False, True])
def test_save_latents_and_meta_matches_jax(tmp_path, fmt, is_reference):
    lat = np.random.default_rng(1).standard_normal((1, 2, 2, 3, LATENT_CH)).astype(np.float32)
    for name, mod in (("j", jpre), ("t", tpre)):
        mod.save_latents_and_meta(lat, str(tmp_path / name), "clipA", 3, 18, 27, 24.0, True,
                                  is_reference=is_reference, fmt=fmt)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for n in names:
        got, ref = tmp_path / "t" / n, tmp_path / "j" / n
        if n.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(ref.read_text())
            assert got.read_text() == ref.read_text()
        elif fmt == "pt":
            a, b = (torch.load(p, weights_only=True)["latents"] for p in (got, ref))
            assert a.dtype == b.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            (a, ma), (b, mb) = load_safetensors(got), load_safetensors(ref)
            assert ma == mb and a.keys() == b.keys() == {"latents"}
            np.testing.assert_array_equal(a["latents"].numpy(), b["latents"].numpy())
            np.testing.assert_array_equal(a["latents"].numpy(), lat.transpose(0, 4, 1, 2, 3))


def test_vae_encoder_matches_jax_f32(ckpt):
    """The same uint8 clip through both encoders in f32, the JAX draw fed
    to the port; and the port's posterior mean alone (per-channel
    normalization off) against the JAX encode without sampling."""
    jenc = jpre.VAEEncoder(str(ckpt), precision="float32")
    tenc = tpre.VAEEncoder(str(ckpt), precision="float32", device="cpu")
    u8 = np.random.default_rng(3).integers(0, 255, (1, CLIP, H, W, 3), np.uint8)
    for seed, per_channel in ((11, True), (0, False)):
        ref = np.asarray(jenc.encode(u8, seed=seed, per_channel=per_channel))
        noise = jax_draw(seed, ref.shape, torch.float32)
        got = tenc.encode(u8, seed=seed, per_channel=per_channel, noise=noise).numpy()
        assert got.shape == ref.shape == latent_shape(tenc.cfg, u8.shape)
        assert _rel_rms(got, ref) < F32_TOL
    # the seeded generator: deterministic, and the seed matters
    a, b, c = (tenc.encode(u8, seed=s).numpy() for s in (5, 5, 6))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_uint8_path_is_the_float_path(ckpt, precision):
    """uint8 frames normalized on the device equal the host's float frames
    bit for bit: the same f32 expression, ``x * (2 / 255) - 1``."""
    enc = tpre.VAEEncoder(str(ckpt), precision=precision, device="cpu")
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (1, CLIP, H, W, 3), np.uint8)
    u8[0, 0, 0, :3] = [0, 255, 128]
    host = u8.astype(np.float32)
    host *= 2.0 / 255.0
    host -= 1.0
    np.testing.assert_array_equal(enc.normalize(torch.from_numpy(u8)).float().numpy(),
                                  torch.from_numpy(host).to(enc.dtype).float().numpy())
    noise = torch.from_numpy(rng.standard_normal(latent_shape(enc.cfg, u8.shape)).astype(
        np.float32))
    np.testing.assert_array_equal(enc.encode(u8, 1, noise=noise).float().numpy(),
                                  enc.encode(host, 1, noise=noise).float().numpy())


def _vae_args(ckpt, inputs, out, fmt):
    return types.SimpleNamespace(
        ckpt=str(ckpt), inputs=[str(inputs)], output_dir=str(out), clip_length=CLIP,
        stride=CLIP, height=H, width=W, per_channel_normalize=True, format=fmt,
        save_pixels=True)


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_save_vae_latents_matches_jax(ckpt, videos, tmp_path, monkeypatch, fmt):
    """Both CLIs (bf16) over two videos: the same file names, metadata
    JSONs and ``_pixels.npy`` targets bit for bit; latents [1, C, F', H',
    W'] within the bf16 limit, the JAX draws injected. The port's run goes
    through ``main`` (its argparse surface, ``--device cpu``)."""
    inject_jax_draws(monkeypatch)
    jpre.cmd_save_vae_latents(_vae_args(ckpt, videos, tmp_path / "j", fmt))
    tpre.main(["save-vae-latents", "--inputs", str(videos), "--output_dir",
               str(tmp_path / "t"), "--ckpt", str(ckpt), "--clip_length", str(CLIP),
               "--stride", str(CLIP), "--height", str(H), "--width", str(W), "--format",
               fmt, "--save_pixels", "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    ext = ".pt" if fmt == "pt" else ".safetensors"
    assert sum(n.endswith(ext) for n in names) == 4
    assert sum(n.endswith("_pixels.npy") for n in names) == 4
    for n in names:
        got, ref = tmp_path / "t" / n, tmp_path / "j" / n
        if n.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(ref.read_text())
        elif n.endswith(".npy"):
            a, b = np.load(got), np.load(ref)
            assert a.dtype == b.dtype == np.uint8 and a.shape == (CLIP, H, W, 3)
            np.testing.assert_array_equal(a, b)
        else:
            if fmt == "pt":
                a, b = (torch.load(p, weights_only=True)["latents"].numpy() for p in (got, ref))
            else:
                a, b = (load_safetensors(p)[0]["latents"].numpy() for p in (got, ref))
            assert a.shape == b.shape == (1, LATENT_CH, 2, H // 32, W // 32)
            assert a.dtype == b.dtype == np.float32
            assert _rel_rms(a, b) < BF16_TOL, n


def test_save_vae_latents_takes_decoded_clips(ckpt, tmp_path):
    """Clips handed over already decoded (as the card's machine, with no
    cv2, feeds them) go through the staging stage, encode and save, and
    the run's counts come back."""
    enc = tpre.VAEEncoder(str(ckpt), precision="float32", device="cpu")
    rng = np.random.default_rng(9)
    clips = [(rng.integers(0, 256, (1, CLIP, H, W, 3), np.uint8), "mem", i, CLIP * i,
              CLIP * (i + 1), 30.0) for i in range(3)]
    args = _vae_args(ckpt, tmp_path, tmp_path / "out", "safetensors")
    stats = tpre.cmd_save_vae_latents(args, encoder=enc, clips=iter(clips))
    assert stats["clips"] == 3 and stats["frames"] == 3 * CLIP and stats["seconds"] > 0
    for x, base, i, s, e, fps in clips:
        lat = load_safetensors(tmp_path / "out" / f"mem_{i}.safetensors")[0]["latents"]
        want = enc.encode(x, seed=i).numpy().transpose(0, 4, 1, 2, 3)
        np.testing.assert_array_equal(lat.numpy(), want)
        np.testing.assert_array_equal(np.load(tmp_path / "out" / f"mem_{i}_pixels.npy"), x[0])
        meta = json.loads((tmp_path / "out" / f"mem_{i}.json").read_text())
        assert (meta["start_frame"], meta["end_frame_exclusive"], meta["fps"]) == (s, e, fps)


class _DecodeError(RuntimeError):
    pass


@pytest.mark.parametrize("source", ["files", "clips"])
def test_save_vae_latents_fails_when_a_decode_fails(ckpt, videos, tmp_path, monkeypatch,
                                                     source):
    """A decode that raises (``read_video`` on one of the files, or the
    iterable of decoded clips) fails the subcommand with that error, not
    an exit with the file's latents missing."""
    if source == "files":
        real = tpre.read_video

        def read_video(path):
            if path.endswith("v1.mp4"):
                raise _DecodeError(path)
            return real(path)

        monkeypatch.setattr(tpre, "read_video", read_video)
        with pytest.raises(_DecodeError, match="v1.mp4"):
            tpre.main(["save-vae-latents", "--inputs", str(videos), "--output_dir",
                       str(tmp_path / "t"), "--ckpt", str(ckpt), "--clip_length", str(CLIP),
                       "--stride", str(CLIP), "--height", str(H), "--width", str(W),
                       "--device", "cpu"])
        return

    def clips():
        yield (np.zeros((1, CLIP, H, W, 3), np.uint8), "mem", 0, 0, CLIP, 30.0)
        raise _DecodeError("clip 1")

    enc = tpre.VAEEncoder(str(ckpt), precision="float32", device="cpu")
    with pytest.raises(_DecodeError, match="clip 1"):
        tpre.cmd_save_vae_latents(_vae_args(ckpt, tmp_path, tmp_path / "out", "safetensors"),
                                  encoder=enc, clips=clips())


def test_save_video_clips_matches_jax(videos, tmp_path):
    """Both packages write the same resized clips: equal decoded frames."""
    from avatar_tpu_torch.data.media import read_video_frames

    args = dict(inputs=[str(videos)], clip_length=CLIP, stride=CLIP, height=H, width=W)
    jpre.cmd_save_video_clips(types.SimpleNamespace(output_dir=str(tmp_path / "j"), **args))
    tpre.cmd_save_video_clips(types.SimpleNamespace(output_dir=str(tmp_path / "t"), **args))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == ["v0_0.mp4", "v0_1.mp4", "v1_0.mp4", "v1_1.mp4"]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for n in names:
        a, b = (np.stack(list(read_video_frames(d / n))) for d in (tmp_path / "t",
                                                                   tmp_path / "j"))
        assert a.shape == (CLIP, H, W, 3)
        np.testing.assert_array_equal(a, b)
