"""Text or audio -> talking-face pose frames (port of
``avatar_tpu/pipelines/pose_frames.py``).

Coqui TTS (optional) or a given wav -> 16 kHz audio -> FaceFormer's
vertices on the card (:func:`faceformer_predict`) -> the 51 FLAME landmark
vertices drawn as white dots on black inside the detected face box -> a
directory of PNG frames, with the N*8+1 frame count and the ~20 s audio
cap.

Host-side pieces (TTS, audio IO, face detection, rendering) are plain
Python; their optional packages (mediapipe or cv2, Coqui ``TTS``, scipy,
cv2 or matplotlib) are imported only inside the functions that use them.
"""

from __future__ import annotations

import math
import tempfile
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

# The 51 static landmark vertex indices of FLAME (landmarks 17-67, without
# the nose block).
FLAME_51_STATIC_LANDMARK_INDICES = np.array(
    [
        # Right eyebrow (landmarks 17-21)
        3763, 2566, 335, 3154, 3712,
        # Left eyebrow (landmarks 22-26)
        3868, 2135, 16, 17, 3892,
        # Right eye (landmarks 36-41)
        2437, 2383, 2494, 3632, 2293, 2296,
        # Left eye (landmarks 42-47)
        3833, 1343, 1034, 1175, 884, 881,
        # Mouth outer (landmarks 48-59)
        2715, 2813, 2774, 3543, 1657, 1696, 1579, 1795, 1865, 3503, 2948, 2898,
        # Mouth inner (landmarks 60-67)
        2845, 2785, 3533, 1668, 1730, 1848, 3509, 2937,
    ],
    dtype=np.int64,
)

MAX_AUDIO_SAMPLES = 600 * 16000 // 30  # ~20 s: FaceFormer's 600 frames at 30 fps


# ---------------------------------------------------------------------------
# Face detection (mediapipe, with a cv2 fallback)
# ---------------------------------------------------------------------------


def detect_face_bbox(
    image: np.ndarray,  # [H, W, 3] uint8 or float
    min_detection_confidence: float = 0.5,
) -> Tuple[float, float, float, float]:
    """Detect exactly one face; return normalized (x_min, y_min, x_max, y_max).

    Uses MediaPipe when installed; otherwise OpenCV's Haar cascade
    detector.
    """
    if image.dtype != np.uint8:
        image = (
            (image * 255).astype(np.uint8)
            if image.max() <= 1.0 else image.astype(np.uint8)
        )
    h, w = image.shape[:2]

    try:
        import mediapipe as mp

        with mp.solutions.face_detection.FaceDetection(
            model_selection=1,
            min_detection_confidence=min_detection_confidence,
        ) as det:
            results = det.process(image)
        detections = results.detections or []
        if len(detections) == 0:
            raise ValueError("No face detected in the image.")
        if len(detections) > 1:
            raise ValueError(
                f"Multiple faces detected ({len(detections)}). "
                "Please provide an image with exactly one face."
            )
        bbox = detections[0].location_data.relative_bounding_box
        clamp = lambda v: max(0.0, min(1.0, v))  # noqa: E731
        return (
            clamp(bbox.xmin), clamp(bbox.ymin),
            clamp(bbox.xmin + bbox.width), clamp(bbox.ymin + bbox.height),
        )
    except ImportError:
        pass

    import os

    import cv2

    cascade_path = os.path.join(
        getattr(cv2.data, "haarcascades", ""),
        "haarcascade_frontalface_default.xml",
    )
    if not os.path.exists(cascade_path):
        raise RuntimeError(
            "No face-detection backend available: install `mediapipe` "
            "or an OpenCV build with Haar cascades, "
            "or pass an explicit face bbox (--face_bbox x0 y0 x1 y1)."
        )
    gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    cascade = cv2.CascadeClassifier(cascade_path)
    faces = cascade.detectMultiScale(gray, scaleFactor=1.1, minNeighbors=5)
    if len(faces) == 0:
        raise ValueError("No face detected in the image (cv2 fallback).")
    if len(faces) > 1:
        raise ValueError(
            f"Multiple faces detected ({len(faces)}). "
            "Please provide an image with exactly one face."
        )
    x, y, fw, fh = faces[0]
    return (x / w, y / h, (x + fw) / w, (y + fh) / h)


# ---------------------------------------------------------------------------
# Audio (scipy)
# ---------------------------------------------------------------------------


def load_audio_16k(wav_path: Union[str, Path]) -> np.ndarray:
    """Read a wav, downmix to mono, resample to 16 kHz float32 [-1, 1]."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, audio = wavfile.read(str(wav_path))
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype == np.int32:
        audio = audio.astype(np.float32) / 2147483648.0
    elif audio.dtype == np.uint8:
        audio = (audio.astype(np.float32) - 128.0) / 128.0
    else:
        audio = audio.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr != 16000:
        from math import gcd

        g = gcd(int(sr), 16000)
        audio = resample_poly(audio, 16000 // g, int(sr) // g).astype(np.float32)
    return audio


def synthesize_tts(
    text: str,
    out_wav: Union[str, Path],
    model_name: str = "tts_models/en/ljspeech/tacotron2-DDC",
) -> Path:
    """Coqui TTS -> 16 kHz wav. An optional dependency: raises an
    ImportError that says so where it is absent."""
    try:
        from TTS.api import TTS
    except ImportError as e:
        raise ImportError(
            "Coqui TTS is not installed. Install `TTS` for text-driven "
            "generation, or pass a wav file via `audio_path`."
        ) from e
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    tts = TTS(model_name=model_name)
    audio = np.asarray(tts.tts(text), dtype=np.float32)
    src_sr = int(
        getattr(tts, "speakers_sample_rate", None)
        or getattr(tts, "sample_rate", None)
        or 22050
    )
    if src_sr != 16000:
        from math import gcd

        g = gcd(src_sr, 16000)
        audio = resample_poly(audio, 16000 // g, src_sr // g)
    wavfile.write(str(out_wav), 16000, (audio * 32767).astype(np.int16))
    return Path(out_wav)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def project_vertices(vertices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Orthographic xy projection normalized to [-1, 1] + depth in [0, 1]."""
    coords = vertices[:, :2]
    coords = coords - coords.mean(axis=0, keepdims=True)
    coords = coords / (np.max(np.abs(coords)) + 1e-6)
    depth = vertices[:, 2]
    depth = depth - depth.min()
    if depth.max() > 0:
        depth = depth / depth.max()
    return coords, depth


def _landmark_pixels(vertices, height, width, face_bbox, features_only):
    if features_only:
        idx = FLAME_51_STATIC_LANDMARK_INDICES
        idx = idx[idx < len(vertices)]
        if len(idx) == 0:
            raise ValueError("No landmark vertices found")
        vertices = vertices[idx]

    coords, _ = project_vertices(vertices)
    x_min, y_min, x_max, y_max = face_bbox
    cx, cy = (x_min + x_max) / 2 * width, (y_min + y_max) / 2 * height
    bw, bh = (x_max - x_min) * width, (y_max - y_min) * height
    xs = coords[:, 0] * bw / 2.0 + cx
    ys = -coords[:, 1] * bh / 2.0 + cy  # flip Y
    return xs, ys


def render_frame(
    vertices: np.ndarray,
    out_path: Union[str, Path],
    height: int,
    width: int,
    face_bbox: Tuple[float, float, float, float],
    features_only: bool = True,
    point_size: float = 2.0,
    renderer: str = "cv2",
) -> None:
    """White landmark dots on black inside the face bbox, exact pixel size.

    ``renderer``: "cv2" rasterizes anti-aliased circles directly (the
    default); "matplotlib" draws a scatter plot and saves it: the same dot
    positions (one projection), slightly different anti-aliasing."""
    xs, ys = _landmark_pixels(vertices, height, width, face_bbox,
                              features_only)

    if renderer == "cv2":
        import cv2

        img = np.zeros((height, width, 3), np.uint8)
        # matplotlib scatter s=2.0 points^2 -> diameter sqrt(2) pt at dpi
        # 100 = ~1.96 px; cv2 circles take an int radius in fixed-point
        radius = max(1, round(math.sqrt(point_size) / 72.0 * 100.0 / 2.0))
        for x, y in zip(xs, ys):
            if -4 <= x <= width + 4 and -4 <= y <= height + 4:
                cv2.circle(img, (round(x * 4), round(y * 4)), radius * 4,
                           (255, 255, 255), -1, lineType=cv2.LINE_AA, shift=2)
        cv2.imwrite(str(out_path), img)
        return

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dpi = 100
    fig = plt.figure(figsize=(width / dpi, height / dpi), dpi=dpi)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.axis("off")
    fig.patch.set_facecolor("black")
    ax.set_facecolor("black")
    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)
    ax.scatter(xs, ys, c="white", s=point_size, linewidths=0)
    fig.savefig(str(out_path), dpi=dpi, facecolor="black", pad_inches=0)
    plt.close(fig)


def adjust_num_frames(
    available: int,
    num_frames: Optional[int],
    target_fps: int,
    period: int,
) -> int:
    """The frame count: ``num_frames`` if given, else the available frames
    resampled to ``target_fps``, rounded to N*8+1; at most ``available``."""
    if num_frames is not None:
        return min(num_frames, available)
    n = int(available * target_fps / period) if target_fps < period else available
    n = ((n - 2) // 8 + 1) * 8 + 1
    return min(n, available)


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------


def generate_faceformer_frames(
    text: Optional[str] = None,
    *,
    audio_path: Optional[Union[str, Path]] = None,
    output_dir: Union[str, Path],
    faceformer_checkpoint: Union[str, Path],
    template_path: Union[str, Path],
    face_bbox: Optional[Tuple[float, float, float, float]] = None,
    num_frames: Optional[int] = None,
    features_only: bool = True,
    point_size: float = 2.0,
    identity_index: int = 0,
    target_fps: int = 20,
    height: int = 512,
    width: int = 512,
    tts_model: str = "tts_models/en/ljspeech/tacotron2-DDC",
    renderer: str = "cv2",
    device="cuda",
) -> Path:
    """Text (or a wav) -> a directory of rendered pose frames,
    ``frame_{i:05d}.png``. FaceFormer (``faceformer_checkpoint``, read by
    :func:`load_faceformer`) runs on ``device``; the FLAME template
    (``template_path``, [V, 3] or flat) is added to its vertex offsets."""
    from avatar_tpu_torch.models import faceformer

    if text is None and audio_path is None:
        raise ValueError("need text or audio_path")

    tmp_dir = None
    if audio_path is None:
        tmp_dir = tempfile.TemporaryDirectory()
        audio_path = synthesize_tts(text, Path(tmp_dir.name) / "tts_16k.wav", tts_model)
    audio = load_audio_16k(audio_path)
    if audio.shape[0] > MAX_AUDIO_SAMPLES:
        print(f"[FaceFormer] Audio too long ({audio.shape[0]} samples), "
              f"truncating to {MAX_AUDIO_SAMPLES} samples (~20s)")
        audio = audio[:MAX_AUDIO_SAMPLES]

    template = np.load(str(template_path))
    if template.ndim == 1:
        template = template.reshape(-1, 3)
    template = template.astype(np.float32)

    ff_cfg, w2v_cfg, params = faceformer.load_faceformer(str(faceformer_checkpoint),
                                                         device=device)
    one_hot = np.zeros((1, ff_cfg.num_identities), np.float32)
    one_hot[0, max(0, min(ff_cfg.num_identities - 1, identity_index))] = 1.0

    with torch.no_grad():
        verts = faceformer.faceformer_predict(
            params, ff_cfg, w2v_cfg, torch.from_numpy(audio[None]).to(device),
            torch.from_numpy(template.reshape(1, -1)).to(device),
            torch.from_numpy(one_hot).to(device))
    seq = verts[0].float().cpu().numpy().reshape(-1, template.shape[0], 3)

    frames_dir = Path(output_dir)
    frames_dir.mkdir(parents=True, exist_ok=True)

    n = adjust_num_frames(seq.shape[0], num_frames, target_fps, ff_cfg.period)
    frame_indices = np.linspace(0, seq.shape[0] - 1, n, dtype=int)
    if face_bbox is None:
        face_bbox = (0.25, 0.25, 0.75, 0.75)

    for out_idx, model_idx in enumerate(frame_indices):
        render_frame(
            seq[model_idx],
            frames_dir / f"frame_{out_idx:05d}.png",
            height=height, width=width, face_bbox=face_bbox,
            features_only=features_only, point_size=point_size,
            renderer=renderer,
        )
    if tmp_dir is not None:
        tmp_dir.cleanup()
    return frames_dir
