"""The port's pose frames against the JAX package's, on the CPU: the
host-side pieces (frame counts, projection, landmark pixels, audio
loading, cv2 rendering, face detection's refusal), ``generate_faceformer_frames``
on a wav through both packages, and the CLI's ``--text`` (Coqui TTS
patched to write a wav). The tiny FaceFormer is
``tests/test_torch_faceformer.py``'s."""

import numpy as np
import pytest
import torch

from avatar_tpu.models import faceformer as jff
from avatar_tpu.pipelines import pose_frames as jpose
from avatar_tpu_torch.models import faceformer as tff
from avatar_tpu_torch.pipelines import pose_frames as tpose
from test_torch_faceformer import FF_ATOL, N_VERTS, models  # noqa: F401

torch.set_num_threads(2)


def test_host_pieces_match_jax(tmp_path):
    """Frame counts, projection, landmark pixels, audio loading, and the
    cv2 rendering of the same vertices, pixel for pixel."""
    from scipy.io import wavfile

    for args in ((100, None, 20, 30), (10, None, 20, 30), (100, 33, 20, 30), (145, None, 20, 30)):
        assert tpose.adjust_num_frames(*args) == jpose.adjust_num_frames(*args)
    assert tpose.MAX_AUDIO_SAMPLES == jpose.MAX_AUDIO_SAMPLES
    np.testing.assert_array_equal(tpose.FLAME_51_STATIC_LANDMARK_INDICES,
                                  jpose.FLAME_51_STATIC_LANDMARK_INDICES)
    verts = np.random.default_rng(0).standard_normal((5023, 3)).astype(np.float32) * 0.1
    for a, b in zip(tpose.project_vertices(verts), jpose.project_vertices(verts)):
        np.testing.assert_array_equal(a, b)
    box = (0.2, 0.3, 0.7, 0.8)
    for a, b in zip(tpose._landmark_pixels(verts, 64, 96, box, True),
                    jpose._landmark_pixels(verts, 64, 96, box, True)):
        np.testing.assert_array_equal(a, b)
    wavfile.write(tmp_path / "a.wav", 22050,
                  (np.random.default_rng(1).standard_normal(4410) * 3000).astype(np.int16))
    np.testing.assert_array_equal(tpose.load_audio_16k(tmp_path / "a.wav"),
                                  jpose.load_audio_16k(tmp_path / "a.wav"))
    from PIL import Image

    for mod, name in ((tpose, "t.png"), (jpose, "j.png")):
        mod.render_frame(verts, tmp_path / name, height=64, width=96, face_bbox=box)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    with pytest.raises((ValueError, RuntimeError), match="face"):
        tpose.detect_face_bbox(np.zeros((64, 64, 3), np.uint8))


def _tiny_loaders(models):
    (jw, tw, jcfg, tcfg), _, _ = models

    def jload(path):
        st = torch.load(path, map_location="cpu", weights_only=False)
        return jcfg, jw, jff.import_faceformer_state({k: v.numpy() for k, v in st.items()}, jw)

    load = tff.load_faceformer

    def tload(path, w2v_cfg=None, device="cuda"):
        _, w, params = load(path, tw, device=device)
        return tcfg, w, params

    return jload, tload


def _write_assets(models, tmp_path):
    from scipy.io import wavfile

    _, state, _ = models
    torch.save(state, tmp_path / "vocaset.pth")
    rng = np.random.default_rng(0)
    wavfile.write(tmp_path / "speech.wav", 16000,
                  (rng.standard_normal(1600) * 3000).astype(np.int16))
    np.save(tmp_path / "template.npy", rng.standard_normal((N_VERTS, 3)).astype(np.float32) * 0.1)


def test_generate_faceformer_frames_matches_jax(models, tmp_path, monkeypatch):
    """A wav through both packages' ``generate_faceformer_frames``: the
    vertices handed to each rendered frame agree, and the port writes the
    17 PNG frames."""
    jload, tload = _tiny_loaders(models)
    _write_assets(models, tmp_path)
    monkeypatch.setattr(jff, "load_faceformer", jload)
    monkeypatch.setattr(tff, "load_faceformer", tload)
    seen = {"j": [], "t": []}
    real_render = tpose.render_frame
    monkeypatch.setattr(jpose, "render_frame",
                        lambda v, path, **kw: seen["j"].append(np.array(v)))

    def t_render(v, path, **kw):
        seen["t"].append(np.array(v))
        real_render(v, path, **kw)

    monkeypatch.setattr(tpose, "render_frame", t_render)
    kw = dict(audio_path=tmp_path / "speech.wav", faceformer_checkpoint=str(
        tmp_path / "vocaset.pth"), template_path=str(tmp_path / "template.npy"),
        face_bbox=(0.25, 0.25, 0.75, 0.75), num_frames=17, target_fps=20, height=64,
        width=64)
    jpose.generate_faceformer_frames(output_dir=tmp_path / "jframes", **kw)
    out = tpose.generate_faceformer_frames(output_dir=tmp_path / "frames", device="cpu", **kw)
    assert len(seen["t"]) == len(seen["j"]) == 17
    np.testing.assert_allclose(np.stack(seen["t"]), np.stack(seen["j"]), atol=FF_ATOL)
    frames = sorted(out.glob("frame_*.png"))
    assert len(frames) == 17
    from PIL import Image

    img = np.asarray(Image.open(frames[0]).convert("RGB"))
    assert img.shape == (64, 64, 3) and img.max() > 100


def test_cli_text_renders_pose_frames(models, tmp_path, monkeypatch):
    """``--text`` with a reference image: the face box of the image, Coqui
    TTS (patched here to write a wav), FaceFormer's frames rendered at the
    CLI's size and frame rate, their directory appended as the pose
    frames."""
    from PIL import Image

    from avatar_tpu_torch.cli import infer as tinfer

    _, tload = _tiny_loaders(models)
    _write_assets(models, tmp_path)
    monkeypatch.setattr(tff, "load_faceformer", tload)
    spoken = {}

    def fake_tts(text, out_wav, model_name=None):
        spoken["text"] = text
        out_wav = str(out_wav)
        import shutil

        shutil.copy(tmp_path / "speech.wav", out_wav)
        return out_wav

    monkeypatch.setattr(tpose, "synthesize_tts", fake_tts)
    monkeypatch.setattr(tpose, "detect_face_bbox", lambda image: (0.2, 0.2, 0.8, 0.8))
    seen = {}
    monkeypatch.setattr(tinfer, "infer", lambda config: seen.setdefault("config", config))
    ref = tmp_path / "ref.png"
    Image.fromarray(np.zeros((48, 80, 3), np.uint8)).save(ref)
    tinfer.main(["--text", "hello there", "--conditioning_media_paths", str(ref),
                 "--faceformer_checkpoint", str(tmp_path / "vocaset.pth"),
                 "--flame_template", str(tmp_path / "template.npy"),
                 "--output_path", str(tmp_path / "out"), "--height", "48", "--width", "80",
                 "--device", "cpu"])
    config = seen["config"]
    frames_dir = tmp_path / "out" / "pose_frames"
    assert spoken == {"text": "hello there"}
    assert config.conditioning_media_paths == [str(ref), str(frames_dir)]
    frames = sorted(frames_dir.glob("frame_*.png"))
    # the tiny conv stack (strides 5, 2) leaves 159 feature frames of 0.1 s,
    # taken as 50 Hz: 95 FaceFormer frames; the frame count then follows
    # adjust_num_frames with the tiny config's period (5) as the model's fps
    assert len(frames) == tpose.adjust_num_frames(95, None, 20, 5) == 95
    assert np.asarray(Image.open(frames[0])).shape[:2] == (48, 80)
