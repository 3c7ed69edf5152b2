"""The port's host-side media IO (``avatar_tpu_torch/data/media.py``,
``avatar_tpu_torch/native``) against the JAX package's, bit for bit, on
this host's libraries: the CRF round trip on the backend the host takes
(the native libavcodec shim where PyAV is absent), image, mp4 and
frame-folder loading with the reference's preprocessing, the padding
arithmetic and video writing."""

import numpy as np
import pytest
from PIL import Image

from avatar_tpu.data import media as jmedia
from avatar_tpu_torch import native as tnative
from avatar_tpu_torch.data import media as tmedia

H, W = 64, 96


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A PNG, a folder of 5 frames and a 5-frame mp4 (written by cv2) of
    seeded noise with a gradient, 100 x 128: cropped to 85 x 128 or
    resized to 64 x 96 (widths that are multiples of 16, which the JAX
    package's CRF shim takes: see test_port_crf_shim_takes_any_even_width)."""
    tmp = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    ramp = np.linspace(0, 200, 128, dtype=np.float32)[None, :, None]

    def frame():
        return np.clip(ramp + rng.normal(0, 25, (100, 128, 3)), 0, 255).astype(np.uint8)

    Image.fromarray(frame()).save(tmp / "img.png")
    (tmp / "frames").mkdir()
    video = np.stack([frame() for _ in range(5)])
    for i, f in enumerate(video):
        Image.fromarray(f).save(tmp / "frames" / f"frame_{i:03d}.png")
    jmedia.write_video(tmp / "clip.mp4", video, fps=10)
    return tmp


def test_crf_compress_same_bits_on_this_hosts_backend():
    img = np.random.default_rng(1).uniform(0, 1, (63, 81, 3)).astype(np.float32)
    arr = (img[:62, :80] * 255.0).astype(np.uint8)
    try:
        import av  # noqa: F401
        backend = "pyav"
    except ImportError:
        backend = "native" if tnative.crf_roundtrip(arr, 29) is not None else "jpeg"
    assert backend != "jpeg", "this host has libavcodec: the native shim must build"
    out, ref = tmedia.crf_compress(img), jmedia.crf_compress(img)
    assert out.shape == ref.shape == (62, 80, 3) and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, arr / 255.0)  # lossy
    assert tmedia.crf_compress(img, crf=0) is img


@pytest.mark.parametrize("crf", [29, 23])
def test_crf_compress_jpeg_fallback_same_bits(monkeypatch, crf):
    """Without PyAV and the shim both packages take the calibrated JPEG
    round trip, and warn."""
    import avatar_tpu.native as jnative

    monkeypatch.setattr(jnative, "crf_roundtrip", lambda arr, crf: None)
    monkeypatch.setattr(tnative, "crf_roundtrip", lambda arr, crf: None)
    img = np.random.default_rng(5).uniform(0, 1, (40, 56, 3)).astype(np.float32)
    with pytest.warns(UserWarning, match="JPEG"):
        out = tmedia.crf_compress(img, crf)
    np.testing.assert_array_equal(out, jmedia.crf_compress(img, crf))
    assert out.shape == img.shape and not np.array_equal(out, img)


@pytest.mark.parametrize("width", [24, 120, 184])
def test_port_crf_shim_takes_any_even_width(width):
    """The JAX package's shim hands packed rows straight to swscale, whose
    SIMD rows overrun them: at widths of 8 modulo 16 it corrupts the heap
    and aborts the process (so it is not run here). The
    port's copy goes through padded rows: any even width runs, seeded
    output, lossy but close."""
    rgb = np.random.default_rng(4).integers(60, 200, (48, width, 3), dtype=np.uint8)
    out = tnative.crf_roundtrip(rgb, 29)
    assert out is not None and out.shape == rgb.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, tnative.crf_roundtrip(rgb, 29))
    assert 0 < np.abs(out.astype(int) - rgb).mean() < 40


@pytest.mark.parametrize("kind", ["img.png", "frames", "clip.mp4"])
@pytest.mark.parametrize("just_crop", [False, True])
def test_load_media_file_same_bits(files, kind, just_crop):
    padding = tmedia.calculate_padding(H, W, 64, 128)
    out = tmedia.load_media_file(str(files / kind), H, W, padding, just_crop=just_crop)
    ref = jmedia.load_media_file(str(files / kind), H, W, padding, just_crop=just_crop)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert out.shape[1] == (1 if kind == "img.png" else 5)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("src,dst", [((64, 96), (64, 128)), ((100, 120), (128, 128)),
                                     ((192, 320), (192, 320)), ((190, 317), (192, 320))])
def test_padding_same(src, dst):
    pad = tmedia.calculate_padding(*src, *dst)
    assert pad == jmedia.calculate_padding(*src, *dst)
    media = np.random.default_rng(2).standard_normal((1, 2, *src, 3)).astype(np.float32)
    padded = tmedia.pad_media(media, pad)
    np.testing.assert_array_equal(padded, jmedia.pad_media(media, pad))
    assert padded.shape[2:4] == dst
    np.testing.assert_array_equal(tmedia.unpad_media(padded, pad), media)
    np.testing.assert_array_equal(tmedia.unpad_media(padded, pad),
                                  jmedia.unpad_media(padded, pad))


@pytest.mark.parametrize("frames,name", [(4, "v.mp4"), (1, "v.png"), (3, "f.png")])
def test_write_video_same(tmp_path, frames, name):
    video = np.random.default_rng(3).uniform(0, 1, (frames, 32, 48, 3)).astype(np.float32)
    tmedia.write_video(tmp_path / "port" / name, video, fps=10)
    jmedia.write_video(tmp_path / "jax" / name, video, fps=10)
    if name.endswith(".png"):
        out = np.asarray(Image.open(tmp_path / "port" / name))
        np.testing.assert_array_equal(out, np.asarray(Image.open(tmp_path / "jax" / name)))
        return
    out = np.stack(list(tmedia.read_video_frames(tmp_path / "port" / name)))
    ref = np.stack(list(jmedia.read_video_frames(tmp_path / "jax" / name)))
    assert out.shape == (frames, 32, 48, 3)
    np.testing.assert_array_equal(out, ref)
