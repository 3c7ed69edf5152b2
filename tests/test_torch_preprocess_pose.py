"""The port's preprocessing subcommands of the pose path against the JAX
package's, on the CPU: ``save-condition-latents`` (transcript words,
reference png, face box, FaceFormer pose frames), then
``save-condition-encoder-latents`` on the same conditioning directory, and
``save-text-latents`` on a wav and a text file. Face detection and Coqui
TTS are stubbed (no mediapipe, no TTS model here); FaceFormer is the tiny
one of ``tests/test_torch_faceformer.py``. File names and metadata must be
equal, the reference pngs bit for bit, latents within the bf16 limit with
the JAX draws injected, FaceFormer's features within its f32 limit."""

import json
import shutil
import types

import numpy as np
import pytest
import torch
from PIL import Image

from avatar_tpu.cli import preprocess as jpre
from avatar_tpu.models import faceformer as jff
from avatar_tpu.pipelines import pose_frames as jpose
from avatar_tpu_torch.cli import preprocess as tpre
from avatar_tpu_torch.models import faceformer as tff
from avatar_tpu_torch.pipelines import pose_frames as tpose
from avatar_tpu_torch.utils.safetensors_io import load_safetensors
from test_torch_faceformer import FF_ATOL, models  # noqa: F401
from test_torch_pose_frames import _tiny_loaders, _write_assets
from test_torch_preprocess import (BF16_TOL, CLIP, H, LATENT_CH, W, _rel_rms,
                                   inject_jax_draws, write_checkpoint, write_video)

torch.set_num_threads(2)

BOX = (0.2, 0.25, 0.8, 0.75)


@pytest.fixture
def stubs(models, tmp_path, monkeypatch):
    """The tiny FaceFormer's files, both packages' loaders patched to read
    it, face detection and TTS stubbed alike."""
    _write_assets(models, tmp_path)
    jload, tload = _tiny_loaders(models)
    monkeypatch.setattr(jff, "load_faceformer", jload)
    monkeypatch.setattr(tff, "load_faceformer", tload)
    spoken = []

    def fake_tts(text, out_wav, model_name=None):
        spoken.append(text)
        shutil.copy(tmp_path / "speech.wav", out_wav)
        return out_wav

    for mod in (jpose, tpose):
        monkeypatch.setattr(mod, "detect_face_bbox", lambda image: BOX)
        monkeypatch.setattr(mod, "synthesize_tts", fake_tts)
    return types.SimpleNamespace(dir=tmp_path, spoken=spoken)


def _tree(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


def test_condition_latents_match_jax(stubs, monkeypatch):
    """Per clip: the words of the transcript inside the clip, the
    reference png, the face box and ``clip_length`` pose frames; then both
    packages' condition-encoder latents of one conditioning directory."""
    tmp = stubs.dir
    vids = tmp / "vids"
    vids.mkdir()
    write_video(vids / "talk.mp4", 2 * CLIP, seed=3)
    (tmp / "tr.json").write_text(json.dumps({"some/dir/talk.mp4": [
        {"start": 0.0, "end": 0.5, "words": [{"word": "hello", "start": 0.05, "end": 0.2},
                                             {"word": "there", "start": 0.3, "end": 0.4}]},
        {"start": 0.5, "end": 1.0, "words": [{"word": "again", "start": 0.5}]}]}))
    common = dict(inputs=[str(vids)], transcripts=str(tmp / "tr.json"),
                  default_text="Person speaking naturally",
                  faceformer_checkpoint=str(tmp / "vocaset.pth"),
                  flame_template=str(tmp / "template.npy"), clip_length=CLIP, stride=CLIP,
                  height=H, width=W)
    jpre.cmd_save_condition_latents(types.SimpleNamespace(output_dir=str(tmp / "jc"), **common))
    tpre.cmd_save_condition_latents(types.SimpleNamespace(output_dir=str(tmp / "tc"),
                                                          device="cpu", **common))
    assert _tree(tmp / "tc") == _tree(tmp / "jc")
    # 25 fps: clip 0 is 0-0.36 s, clip 1 0.36-0.72 s
    for clip, text in ((0, "hello there"), (1, "there again")):
        meta = json.loads((tmp / "tc" / f"talk_{clip}.json").read_text())
        assert meta == json.loads((tmp / "jc" / f"talk_{clip}.json").read_text())
        assert meta["text"] == text and meta["num_pose_frames"] == CLIP
        assert tuple(meta["face_bbox"].values()) == BOX
        ref = [np.asarray(Image.open(tmp / d / f"talk_{clip}_ref.png")) for d in ("tc", "jc")]
        np.testing.assert_array_equal(*ref)
        # FaceFormer's vertices differ at the f32 limit: a landmark dot may
        # land one pixel over, so the frames agree but for a few pixels
        for f in sorted((tmp / "tc" / f"talk_{clip}_poses").glob("frame_*.png")):
            a, b = (np.asarray(Image.open(d / f.parent.name / f.name), np.int32)
                    for d in (tmp / "tc", tmp / "jc"))
            assert a.max() > 100 and np.mean(a != b) < 0.01
    assert stubs.spoken == ["hello there", "there again"] * 2

    # the encoder latents of the JAX run's conditioning directory
    ckpt = write_checkpoint(tmp / "ckpt.safetensors")
    inject_jax_draws(monkeypatch)
    args = dict(ckpt=str(ckpt), conditions_dir=str(tmp / "jc"), clip_length=CLIP, height=H,
                width=W, per_channel_normalize=True, format="safetensors")
    jpre.cmd_save_condition_encoder_latents(types.SimpleNamespace(output_dir=str(tmp / "je"),
                                                                  **args))
    tpre.main(["save-condition-encoder-latents", "--conditions_dir", str(tmp / "jc"),
               "--output_dir", str(tmp / "te"), "--ckpt", str(ckpt), "--clip_length",
               str(CLIP), "--height", str(H), "--width", str(W), "--device", "cpu"])
    names = _tree(tmp / "je")
    assert _tree(tmp / "te") == names and len(names) == 8
    for n in names:
        got, ref = tmp / "te" / n, tmp / "je" / n
        if n.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(ref.read_text())
            continue
        a, b = (load_safetensors(p)[0]["latents"].numpy() for p in (got, ref))
        frames = 1 if n.endswith("_ref.safetensors") else 2
        assert a.shape == b.shape == (1, LATENT_CH, frames, H // 32, W // 32)
        assert _rel_rms(a, b) < BF16_TOL, n


def test_load_pose_frames_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)).save(
            tmp_path / f"frame_{i:05d}.png")
    for n in (2, 4, 7):
        got, ref = tpre.load_pose_frames(tmp_path, n), jpre.load_pose_frames(tmp_path, n)
        assert len(got) == len(ref) == n
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="No pose frames"):
        tpre.load_pose_frames(tmp_path / "none")
    assert tpre.get_clip_text(None, "x", 0, 1, "d") == jpre.get_clip_text(None, "x", 0, 1, "d")


def test_text_latents_match_jax(stubs):
    """A wav and a text file (spoken by the stubbed TTS): ``{stem}_ff.npy``
    [frames, feature_dim] f32 from both packages, within FaceFormer's f32
    limit."""
    tmp = stubs.dir
    (tmp / "line.txt").write_text("  say this  \n")
    common = dict(inputs=[str(tmp / "speech.wav"), str(tmp / "line.txt")],
                  faceformer_checkpoint=str(tmp / "vocaset.pth"))
    jpre.cmd_save_text_latents(types.SimpleNamespace(output_dir=str(tmp / "j"), **common))
    timings = tpre.cmd_save_text_latents(types.SimpleNamespace(output_dir=str(tmp / "t"),
                                                               device="cpu", **common))
    assert [stem for stem, _ in timings] == ["speech", "line"]
    assert stubs.spoken == ["say this"] * 2
    assert _tree(tmp / "t") == _tree(tmp / "j") == ["line_ff.npy", "line_tts.wav",
                                                    "speech_ff.npy"]
    for n in ("line_ff.npy", "speech_ff.npy"):
        a, b = np.load(tmp / "t" / n), np.load(tmp / "j" / n)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape and a.ndim == 2
        np.testing.assert_allclose(a, b, atol=FF_ATOL)
