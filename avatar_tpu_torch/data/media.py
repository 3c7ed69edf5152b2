"""Host-side media IO (port of ``avatar_tpu/data/media.py``): image and
video loading with the reference's preprocessing chain (centre crop and
resize, 3x3 Gaussian blur, CRF-29 compression round trip, [-1, 1]), the
padding arithmetic and video writing. numpy, PIL and cv2 only, each
imported where it is used; arrays are channels-last [B, F, H, W, 3].
"""

from __future__ import annotations

import io
import os
import warnings
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def crf_compress(image: np.ndarray, crf: int = 29) -> np.ndarray:
    """H.264 CRF encode and decode of a [H, W, 3] float [0, 1] image, cropped
    to even sides, as the training data was compressed. Backends in order:
    PyAV, the native libavcodec / libx264 shim (``avatar_tpu_torch.native``,
    the same pixels given the same libx264), then a JPEG round trip at the
    quality calibrated against CRF 29 (with a warning)."""
    if crf == 0:
        return image
    arr = (image[: image.shape[0] // 2 * 2, : image.shape[1] // 2 * 2] * 255.0)
    arr = arr.astype(np.uint8)

    try:
        import av
    except ImportError:
        av = None
    if av is not None:
        with io.BytesIO() as buf:
            container = av.open(buf, "w", format="mp4")
            try:
                stream = container.add_stream(
                    "libx264", rate=1, options={"crf": str(crf), "preset": "veryfast"})
                stream.height, stream.width = arr.shape[0], arr.shape[1]
                frame = av.VideoFrame.from_ndarray(arr, format="rgb24").reformat(
                    format="yuv420p")
                container.mux(stream.encode(frame))
                container.mux(stream.encode())
            finally:
                container.close()
            data = buf.getvalue()
        with io.BytesIO(data) as buf:
            container = av.open(buf)
            try:
                stream = next(s for s in container.streams if s.type == "video")
                decoded = next(container.decode(stream)).to_ndarray(format="rgb24")
            finally:
                container.close()
        return decoded.astype(image.dtype) / 255.0

    from avatar_tpu_torch.native import crf_roundtrip

    decoded = crf_roundtrip(arr, crf)
    if decoded is not None:
        return decoded.astype(image.dtype) / 255.0

    # JPEG round trip, calibrated against libx264: quality 90 at CRF 29,
    # two quality steps per CRF step around it (the default warning filter
    # shows this once)
    warnings.warn("PyAV / libavcodec not available: a calibrated JPEG round trip "
                  "stands in for the CRF compression (install `av` for the "
                  "reference's pixels).")
    import cv2

    quality = int(np.clip(90 - 2 * (crf - 29), 5, 95))
    _, enc = cv2.imencode(".jpg", arr[..., ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
    return dec.astype(image.dtype) / 255.0


def _gaussian_blur3(img: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """torchvision's gaussian_blur(kernel_size=3, sigma=1.0)."""
    import cv2

    return cv2.GaussianBlur(img, (3, 3), sigmaX=sigma, sigmaY=sigma)


def load_image_to_array_with_resize_and_crop(
    image_input,
    target_height: int = 512,
    target_width: int = 768,
    just_crop: bool = False,
    apply_blur_and_compress: bool = True,
) -> np.ndarray:
    """A path or PIL image -> [1, 1, H, W, 3] f32 in [-1, 1]: centre crop to
    the target aspect, resize (unless ``just_crop``), blur and CRF round
    trip."""
    from PIL import Image

    if isinstance(image_input, (str, Path)):
        image = Image.open(image_input).convert("RGB")
    elif isinstance(image_input, Image.Image):
        image = image_input
    else:
        raise ValueError("image_input must be a path or PIL Image")

    input_width, input_height = image.size
    aspect_target = target_width / target_height
    if input_width / input_height > aspect_target:
        new_width, new_height = int(input_height * aspect_target), input_height
        x_start, y_start = (input_width - new_width) // 2, 0
    else:
        new_width, new_height = input_width, int(input_width / aspect_target)
        x_start, y_start = 0, (input_height - new_height) // 2
    image = image.crop((x_start, y_start, x_start + new_width, y_start + new_height))
    if not just_crop:
        image = image.resize((target_width, target_height))

    arr = np.asarray(image, dtype=np.float32) / 255.0
    if apply_blur_and_compress:
        arr = crf_compress(_gaussian_blur3(arr, sigma=1.0))
    arr = arr * 255.0 / 127.5 - 1.0
    return arr[None, None]


def calculate_padding(source_height: int, source_width: int, target_height: int,
                      target_width: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) padding that centres the source."""
    pad_height = target_height - source_height
    pad_width = target_width - source_width
    pad_top = pad_height // 2
    pad_left = pad_width // 2
    return (pad_left, pad_width - pad_left, pad_top, pad_height - pad_top)


def pad_media(media: np.ndarray, padding: Tuple[int, int, int, int]) -> np.ndarray:
    """Zero-pad [B, F, H, W, C] by (left, right, top, bottom)."""
    left, right, top, bottom = padding
    return np.pad(media, ((0, 0), (0, 0), (top, bottom), (left, right), (0, 0)))


def unpad_media(media: np.ndarray, padding: Tuple[int, int, int, int]) -> np.ndarray:
    left, right, top, bottom = padding
    h, w = media.shape[2], media.shape[3]
    return media[:, :, top:h - bottom if bottom else h, left:w - right if right else w]


def load_media_file(media_path: str, height: int, width: int,
                    padding: Tuple[int, int, int, int],
                    just_crop: bool = False) -> np.ndarray:
    """An image file, a video file or a folder of frames -> [1, F, H, W, 3]
    in [-1, 1], padded."""
    media_path = Path(media_path)
    if media_path.is_dir():
        image_files = sorted(f for f in os.listdir(media_path)
                             if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
        if not image_files:
            raise ValueError(f"No image files found in folder: {media_path}")
        media = np.concatenate([
            load_image_to_array_with_resize_and_crop(media_path / f, height, width,
                                                     just_crop=just_crop)
            for f in image_files], axis=1)
    elif media_path.suffix.lower() in (".mp4", ".avi", ".mov", ".mkv", ".webm"):
        from PIL import Image

        media = np.concatenate([
            load_image_to_array_with_resize_and_crop(Image.fromarray(frame), height,
                                                     width, just_crop=just_crop)
            for frame in read_video_frames(media_path)], axis=1)
    else:
        media = load_image_to_array_with_resize_and_crop(media_path, height, width,
                                                         just_crop=just_crop)
    return pad_media(media, padding)


def read_video_frames(path: Union[str, Path]):
    """Yield the RGB uint8 frames of a video file (cv2)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame[..., ::-1]  # BGR -> RGB
    finally:
        cap.release()


def write_video(path: Union[str, Path], video: np.ndarray, fps: float = 25.0) -> None:
    """[F, H, W, 3] uint8, or float in [0, 1], -> a PNG when it is one frame
    or the path ends in .png, else an mp4 through cv2's VideoWriter; with
    no codec there, a directory of PNG frames beside the path."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    video_u8 = video if video.dtype == np.uint8 else (
        np.clip(video, 0, 1) * 255).astype(np.uint8)
    if video_u8.shape[0] == 1 or str(path).endswith(".png"):
        Image.fromarray(video_u8[0]).save(str(path))
        return

    import cv2

    h, w = video_u8.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if writer.isOpened():
        try:
            for frame in video_u8:
                writer.write(frame[..., ::-1])  # RGB -> BGR
        finally:
            writer.release()
        if path.stat().st_size > 0:
            return
    frames_dir = path.with_suffix("")
    frames_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(video_u8):
        Image.fromarray(frame).save(frames_dir / f"frame_{i:05d}.png")
