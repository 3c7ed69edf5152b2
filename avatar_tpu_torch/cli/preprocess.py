"""Offline preprocessing CLIs (port of ``avatar_tpu/cli/preprocess.py``):
one module, five subcommands, the files the trainers read.

  python -m avatar_tpu_torch.cli.preprocess save-vae-latents --inputs videos/ \\
      --output_dir enc --ckpt ckpt.safetensors [--save_pixels] [--device cpu]
  python -m avatar_tpu_torch.cli.preprocess save-condition-latents ...
  python -m avatar_tpu_torch.cli.preprocess save-condition-encoder-latents ...
  python -m avatar_tpu_torch.cli.preprocess save-video-clips ...
  python -m avatar_tpu_torch.cli.preprocess save-text-latents ...

``save-vae-latents`` runs three stages at once: up to 3 decode threads
(cv2 decode, PIL bicubic resize, whole files each), a staging thread that
copies each uint8 clip into pinned host memory and up to the card on a
side stream, and the encode, which waits on the clip's event; each clip's
latents come back through pinned memory and are written while the next
clip encodes. Latents are ``.safetensors`` (``--format pt``: torch
pickles ``{"latents": <NCFHW>}``) with the reference's metadata JSONs;
``save-text-latents`` writes FaceFormer's audio latents, ``{stem}_ff.npy``.

cv2 and PIL (decode, resize, image IO) and the pose path's optional
packages are imported only inside the functions that use them.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

VIDEO_PATTERNS = ("*.mp4", "*.mov", "*.mkv", "*.avi")


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def read_video(path: str) -> Tuple[List[np.ndarray], float]:
    """RGB uint8 frames of a video file (cv2) and its fps (25 if unknown)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(frame[..., ::-1]))
    cap.release()
    return frames, float(fps)


def preprocess_frames(frames: List, height: int, width: int,
                      as_uint8: bool = False) -> np.ndarray:
    """PIL bicubic resize of PIL images or RGB uint8 arrays (on a thread
    pool: PIL's resample releases the GIL), then [-1, 1] in f32 as
    ``x * (2 / 255) - 1``; channels-last [1, F, H, W, 3]. ``as_uint8``:
    the resized uint8 frames (a quarter of the bytes to upload;
    :class:`VAEEncoder` normalizes them on the device with the same two
    f32 roundings)."""
    from PIL import Image

    if not frames:
        raise ValueError("No frames to process")

    def resize(im):
        if not isinstance(im, Image.Image):
            im = Image.fromarray(im)
        elif im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im.resize((width, height), Image.BICUBIC), np.uint8)

    if len(frames) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            processed = list(ex.map(resize, frames))
    else:
        processed = [resize(frames[0])]
    x = np.stack(processed, axis=0)
    if as_uint8:
        return x[None]
    xf = x.astype(np.float32)
    xf *= 2.0 / 255.0
    xf -= 1.0
    return xf[None]


def iter_clips(num_frames: int, clip_length: int, stride: int) -> List[Tuple[int, int]]:
    """[start, end) of every whole clip, ``stride`` frames apart."""
    clips = []
    i = 0
    while i < num_frames:
        j = i + clip_length
        if j > num_frames:
            break
        clips.append((i, j))
        if j == num_frames:
            break
        i += max(1, stride)
    return clips


def save_latents_and_meta(
    latents: np.ndarray,  # [1, F, H, W, C] channels-last
    out_dir: str,
    base_name: str,
    clip_idx: int,
    start_f: int,
    end_f: int,
    fps: float,
    vae_per_channel_normalize: bool,
    is_reference: bool = False,
    fmt: str = "safetensors",
) -> None:
    """``{base}_{clip}[_ref].safetensors`` (or ``.pt``) holding the latents
    in the reference's [1, C, F, H, W] layout, and its metadata JSON."""
    os.makedirs(out_dir, exist_ok=True)
    suffix = "_ref" if is_reference else ""
    ncfhw = np.ascontiguousarray(np.transpose(np.asarray(latents), (0, 4, 1, 2, 3)))
    stem = os.path.join(out_dir, f"{base_name}_{clip_idx}{suffix}")
    if fmt == "pt":
        torch.save({"latents": torch.from_numpy(ncfhw)}, f"{stem}.pt")
    else:
        from avatar_tpu_torch.utils.safetensors_io import save_safetensors

        save_safetensors({"latents": ncfhw}, f"{stem}.safetensors")
    meta = {
        "video": base_name,
        "clip_index": clip_idx,
        "start_frame": int(start_f),
        "end_frame_exclusive": int(end_f),
        "fps": float(fps),
        "start_time_sec": float(start_f / max(fps, 1e-8)),
        "end_time_sec": float(end_f / max(fps, 1e-8)),
        "vae_per_channel_normalize": bool(vae_per_channel_normalize),
        "format": "torch.pt" if fmt == "pt" else "safetensors",
    }
    if is_reference:
        meta["is_reference"] = True
    with open(f"{stem}.json", "w") as f:
        json.dump(meta, f, indent=2)


def _video_files(inputs: Iterable[str]) -> List[str]:
    files: List[str] = []
    for inp in inputs:
        p = Path(inp)
        if p.is_dir():
            files.extend(str(pp) for ext in VIDEO_PATTERNS for pp in p.rglob(ext))
        else:
            files.append(str(p))
    return files


class VAEEncoder:
    """The VAE's encoder from a single-file checkpoint, on ``device``, in
    ``precision`` (bf16 or f32)."""

    def __init__(self, ckpt_path: str, precision: str = "bfloat16", device="cuda"):
        from avatar_tpu_torch.models.vae import VAEConfig
        from avatar_tpu_torch.utils.weight_import import (
            import_vae_state, load_single_file_checkpoint,
        )

        configs, _, v_state = load_single_file_checkpoint(ckpt_path)
        cfg = VAEConfig.from_dict(configs["vae"])
        self._setup(import_vae_state(v_state, cfg, device=device), cfg, precision, device)

    @classmethod
    def from_params(cls, params: dict, cfg, precision: str = "bfloat16",
                    device="cuda") -> "VAEEncoder":
        """Wrap a param tree already in memory (no checkpoint file)."""
        self = cls.__new__(cls)
        self._setup(params, cfg, precision, device)
        return self

    def _setup(self, params, cfg, precision: str, device):
        from avatar_tpu_torch.train.train import tree_map

        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if precision in ("bfloat16", "bf16") else torch.float32
        self.params = tree_map(lambda t: t.to(
            device=self.device, dtype=self.dtype if t.is_floating_point() else None), params)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 frames -> ``x * (2 / 255) - 1`` in f32 on their device (the
        host path's expression and roundings), then the encoder's dtype."""
        if x.dtype == torch.uint8:
            x = x.float() * (2.0 / 255.0) - 1.0
        return x.to(self.dtype)

    @torch.no_grad()
    def encode(self, media, seed: int, per_channel: bool = True,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """media [1, F, H, W, 3] (numpy or torch; uint8 or float in [-1, 1])
        -> normalized latents [1, F', H', W', C] on the device. The
        posterior's draw comes from a generator on the device seeded with
        ``seed``, unless ``noise`` ([1, F', H', W', C]) is given."""
        from avatar_tpu_torch.models.vae import vae_encode

        x = torch.as_tensor(media).to(self.device, non_blocking=True)
        generator = None
        if noise is None:
            generator = torch.Generator(device=self.device).manual_seed(int(seed))
        else:
            noise = torch.as_tensor(noise).to(self.device)
        return vae_encode(self.params, self.cfg, self.normalize(x), generator=generator,
                          noise=noise, per_channel_normalize=per_channel)


# ---------------------------------------------------------------------------
# save-vae-latents
# ---------------------------------------------------------------------------

_SENTINEL = object()


def _decode_clips(files, clip_length, stride, height, width, out_q, n_producers):
    """Start ``n_producers`` decode threads over ``files``; each puts
    (uint8 clip [1, F, H, W, 3], base, clip_idx, start, end, fps) on
    ``out_q``, any exception its decode raised, then one sentinel."""
    file_q: "queue.Queue" = queue.Queue()
    for f in files:
        file_q.put(f)

    def producer():
        try:
            while True:
                try:
                    vid_path = file_q.get_nowait()
                except queue.Empty:
                    return
                frames, fps = read_video(vid_path)
                if not frames:
                    continue
                base = os.path.splitext(os.path.basename(vid_path))[0]
                for clip_idx, (s, e) in enumerate(iter_clips(len(frames), clip_length,
                                                             stride)):
                    x = preprocess_frames(frames[s:e], height, width, as_uint8=True)
                    out_q.put((x, base, clip_idx, s, e, fps))
        except Exception as err:  # a decode's failure ends the consumer's loop
            out_q.put(err)
        finally:
            out_q.put(_SENTINEL)

    for _ in range(n_producers):
        threading.Thread(target=producer, daemon=True).start()


def _iter_preprocessed_clips(files, clip_length, stride, height, width, stage,
                             prefetch: int = 2, clips=None):
    """Decoded clips, staged, in the order they are ready: the decode
    threads run ahead of the consumer (``prefetch`` clips queued), and
    ``stage`` maps each clip array on a thread of its own (the upload), so
    that it overlaps both the next decode and the current encode.
    ``clips``: an iterable of already decoded items (as the decode threads
    make them) fed to the stage in place of ``files``."""
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 2))
    if clips is None:
        n_producers = max(1, min(3, len(files)))
        _decode_clips(files, clip_length, stride, height, width, q, n_producers)
    else:
        n_producers = 1

        def feeder():
            try:
                for item in clips:
                    q.put(item)
            except Exception as err:
                q.put(err)
            finally:
                q.put(_SENTINEL)

        threading.Thread(target=feeder, daemon=True).start()

    out_q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 2))

    def stager():
        done = 0
        try:
            while done < n_producers:
                item = q.get()
                if item is _SENTINEL:
                    done += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                out_q.put((stage(item[0]),) + item[1:])
        except Exception as err:  # a decode's or an upload's failure ends the consumer's loop
            out_q.put(err)
        out_q.put(_SENTINEL)

    threading.Thread(target=stager, daemon=True).start()
    while True:
        item = out_q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, Exception):
            raise item
        yield item


class _Uploader:
    """The staging stage: a uint8 clip -> (device tensor, event the
    encode waits on or None, the host array). On the card the clip goes
    through pinned host memory and a ``non_blocking`` copy on a side
    stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, x: np.ndarray):
        if self.stream is None:
            return torch.from_numpy(x).to(self.device), None, x
        host = torch.from_numpy(x).pin_memory()
        with torch.cuda.stream(self.stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return dev, ready, x

    @staticmethod
    def take(staged) -> Tuple[torch.Tensor, np.ndarray]:
        """The device clip, usable on the current stream."""
        dev, ready, host = staged
        if ready is not None:
            stream = torch.cuda.current_stream(dev.device)
            stream.wait_event(ready)
            dev.record_stream(stream)
        return dev, host


def _fetch(lat: torch.Tensor):
    """Start the copy of latents to the host as f32: (host tensor, event
    or None)."""
    lat = lat.float()
    if lat.device.type != "cuda":
        return lat, None
    host = torch.empty(lat.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(lat, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _flush_latents(fetched, save_args, fmt):
    host, done = fetched
    if done is not None:
        done.synchronize()
    out_dir, base, clip_idx, s, e, fps, pcn = save_args
    save_latents_and_meta(host.numpy(), out_dir, base, clip_idx, s, e, fps, pcn, fmt=fmt)


def cmd_save_vae_latents(args, encoder: Optional[VAEEncoder] = None,
                         clips: Optional[Iterable] = None) -> Dict[str, float]:
    """Encode every clip of ``args.inputs`` (files or directories) and save
    its latents; ``--save_pixels`` also writes ``{base}_{clip}_pixels.npy``
    (uint8 [F, H, W, 3], the decoder trainer's targets) from the host copy.
    ``encoder`` (default: ``VAEEncoder(args.ckpt)`` on ``args.device``) and
    ``clips`` (decoded items in place of the files' decode) let a caller
    feed the loop directly. Returns the run's counts and seconds: ``wait_s``
    blocked on the next staged clip, ``encode_s`` queuing encodes,
    ``flush_s`` waiting for latents and writing files."""
    device = getattr(args, "device", "cuda")
    enc = encoder if encoder is not None else VAEEncoder(args.ckpt, device=device)
    files = [] if clips is not None else sorted(_video_files(args.inputs))
    save_pixels = bool(getattr(args, "save_pixels", False))
    if save_pixels:
        os.makedirs(args.output_dir, exist_ok=True)
    upload = _Uploader(enc.device)

    stats = {"clips": 0, "frames": 0, "wait_s": 0.0, "encode_s": 0.0, "flush_s": 0.0}
    t_start = time.perf_counter()
    pending = None  # (fetched latents, save args): written after the next encode is queued
    items = _iter_preprocessed_clips(files, args.clip_length, args.stride, args.height,
                                     args.width, upload, clips=clips)
    while True:
        t0 = time.perf_counter()
        item = next(items, None)
        stats["wait_s"] += time.perf_counter() - t0
        if item is None:
            break
        staged, base, clip_idx, s, e, fps = item
        x, host_pixels = _Uploader.take(staged)
        if save_pixels:
            np.save(Path(args.output_dir) / f"{base}_{clip_idx}_pixels.npy",
                    np.asarray(host_pixels[0], dtype=np.uint8))
        t0 = time.perf_counter()
        lat = enc.encode(x, seed=clip_idx, per_channel=args.per_channel_normalize)
        fetched = _fetch(lat)
        stats["encode_s"] += time.perf_counter() - t0
        if pending is not None:
            t0 = time.perf_counter()
            _flush_latents(*pending, fmt=args.format)
            stats["flush_s"] += time.perf_counter() - t0
        pending = (fetched, (args.output_dir, base, clip_idx, s, e, fps,
                             args.per_channel_normalize))
        stats["clips"] += 1
        stats["frames"] += e - s
        print(f"{base} clip {clip_idx}: latents {tuple(lat.shape)}")
    if pending is not None:
        t0 = time.perf_counter()
        _flush_latents(*pending, fmt=args.format)
        stats["flush_s"] += time.perf_counter() - t0
    stats["seconds"] = time.perf_counter() - t_start
    return stats


# ---------------------------------------------------------------------------
# save-condition-latents
# ---------------------------------------------------------------------------


def load_transcripts(path: Optional[str]) -> Optional[Dict]:
    if not path:
        return None
    with open(path) as f:
        raw = json.load(f)
    return {Path(k).stem: v for k, v in raw.items() if isinstance(v, list)}


def get_clip_text(transcripts: Optional[Dict], video_base: str, start_time: float,
                  end_time: float, default_text: str = "") -> str:
    """The words of a word-level transcript that overlap [start, end)."""
    if transcripts is None or video_base not in transcripts:
        return default_text
    clip_words = []
    for seg in transcripts[video_base]:
        if seg["start"] >= end_time or seg["end"] <= start_time:
            continue
        for w in seg.get("words", []):
            ws = w.get("start", seg["start"])
            we = w.get("end", seg["end"])
            if ws < end_time and we > start_time:
                clip_words.append(w.get("word", ""))
    result = " ".join(clip_words).strip()
    return result or default_text


def cmd_save_condition_latents(args):
    """Per clip: the first frame as the reference png and its face box;
    the transcript's text; FaceFormer's pose frames, as many as the clip
    has frames (FaceFormer on ``args.device``); the metadata JSON."""
    from PIL import Image

    from avatar_tpu_torch.pipelines.pose_frames import (
        detect_face_bbox, generate_faceformer_frames,
    )

    device = getattr(args, "device", "cuda")
    transcripts = load_transcripts(args.transcripts)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    for vid_path in sorted(_video_files(args.inputs)):
        frames, fps = read_video(vid_path)
        base = Path(vid_path).stem
        for clip_idx, (s, e) in enumerate(iter_clips(len(frames), args.clip_length,
                                                     args.stride)):
            ref_image = Image.fromarray(frames[s]).resize((args.width, args.height),
                                                          Image.BICUBIC)
            try:
                bbox = detect_face_bbox(np.asarray(ref_image))
            except (ValueError, RuntimeError) as err:
                print(f"  skip {base}_{clip_idx}: {err}")
                continue
            text = get_clip_text(transcripts, base, s / fps, e / fps, args.default_text)
            poses_dir = out_dir / f"{base}_{clip_idx}_poses"
            generate_faceformer_frames(
                text or args.default_text,
                output_dir=poses_dir,
                faceformer_checkpoint=args.faceformer_checkpoint,
                template_path=args.flame_template,
                face_bbox=bbox,
                num_frames=e - s,
                height=args.height,
                width=args.width,
                device=device,
            )
            ref_path = out_dir / f"{base}_{clip_idx}_ref.png"
            ref_image.save(ref_path)
            meta = {
                "video": base,
                "clip_index": clip_idx,
                "start_frame": int(s),
                "end_frame_exclusive": int(e),
                "fps": float(fps),
                "start_time_sec": s / max(fps, 1e-8),
                "end_time_sec": e / max(fps, 1e-8),
                "reference_image": ref_path.name,
                "face_bbox": {"x_min": bbox[0], "y_min": bbox[1],
                              "x_max": bbox[2], "y_max": bbox[3]},
                "pose_frames_dir": poses_dir.name,
                "num_pose_frames": len(list(poses_dir.glob("frame_*.png"))),
                "text": text,
                "format": "conditioning_data",
            }
            with open(out_dir / f"{base}_{clip_idx}.json", "w") as f:
                json.dump(meta, f, indent=2)
            print(f"{base} clip {clip_idx}: conditioning saved")


# ---------------------------------------------------------------------------
# save-condition-encoder-latents
# ---------------------------------------------------------------------------


def load_pose_frames(poses_dir: Path, target_length: int = 57) -> List:
    """The ``frame_*.png`` sequence as RGB PIL images, cut or padded with
    its last frame to ``target_length``."""
    from PIL import Image

    frame_files = sorted(Path(poses_dir).glob("frame_*.png"))
    if not frame_files:
        raise ValueError(f"No pose frames found in {poses_dir}")
    frames = [Image.open(f).convert("RGB") for f in frame_files]
    if len(frames) > target_length:
        frames = frames[:target_length]
    while len(frames) < target_length:
        frames.append(frames[-1].copy())
    return frames


def cmd_save_condition_encoder_latents(args, encoder: Optional[VAEEncoder] = None):
    """The pose frames' latents (seeded with the clip index) and the
    reference image's (seeded 10000 + clip index) of every conditioning
    JSON in ``args.conditions_dir``."""
    from PIL import Image

    enc = encoder if encoder is not None else VAEEncoder(
        args.ckpt, device=getattr(args, "device", "cuda"))
    cond_dir = Path(args.conditions_dir)
    out_dir = args.output_dir

    json_files = sorted(f for f in cond_dir.glob("*.json")
                        if not f.name.endswith("_ref.json"))
    for jf in json_files:
        with open(jf) as f:
            meta = json.load(f)
        if meta.get("format") != "conditioning_data":
            continue
        base, clip_idx = meta["video"], meta["clip_index"]
        frames = load_pose_frames(cond_dir / meta["pose_frames_dir"],
                                  target_length=args.clip_length)
        x = preprocess_frames(frames, args.height, args.width)
        lat = enc.encode(x, seed=clip_idx, per_channel=args.per_channel_normalize)
        save_latents_and_meta(
            lat.float().cpu().numpy(), out_dir, base, clip_idx, meta["start_frame"],
            meta["end_frame_exclusive"], meta["fps"], args.per_channel_normalize,
            fmt=args.format)
        print(f"  Saved pose latents: {base}_{clip_idx}")

        ref_img = Image.open(cond_dir / meta["reference_image"]).convert("RGB")
        x_ref = preprocess_frames([ref_img], args.height, args.width)
        lat_ref = enc.encode(x_ref, seed=10_000 + clip_idx,
                             per_channel=args.per_channel_normalize)
        save_latents_and_meta(
            lat_ref.float().cpu().numpy(), out_dir, base, clip_idx, meta["start_frame"],
            meta["end_frame_exclusive"], meta["fps"], args.per_channel_normalize,
            is_reference=True, fmt=args.format)
        print(f"  Saved reference latents: {base}_{clip_idx}_ref")


# ---------------------------------------------------------------------------
# save-video-clips
# ---------------------------------------------------------------------------


def cmd_save_video_clips(args):
    """Every clip, resized, as ``{base}_{clip}.mp4``."""
    from avatar_tpu_torch.data.media import write_video

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for vid_path in sorted(_video_files(args.inputs)):
        frames, fps = read_video(vid_path)
        base = Path(vid_path).stem
        for clip_idx, (s, e) in enumerate(iter_clips(len(frames), args.clip_length,
                                                     args.stride)):
            clip = preprocess_frames(frames[s:e], args.height, args.width)[0]
            write_video(out_dir / f"{base}_{clip_idx}.mp4", (clip + 1) / 2, fps=fps)
            print(f"{base} clip {clip_idx}: video saved")


# ---------------------------------------------------------------------------
# save-text-latents
# ---------------------------------------------------------------------------


def cmd_save_text_latents(args) -> List[Tuple[str, float]]:
    """FaceFormer's audio latents ``{stem}_ff.npy`` ([frames, feature_dim]
    f32) of each wav (or of each text file, spoken by TTS first), the
    audio cut at ``MAX_AUDIO_SAMPLES``; FaceFormer runs on ``args.device``.
    Returns (stem, seconds) per file."""
    from avatar_tpu_torch.models.faceformer import (
        extract_audio_motion_features, load_faceformer,
    )
    from avatar_tpu_torch.pipelines.pose_frames import (
        MAX_AUDIO_SAMPLES, load_audio_16k, synthesize_tts,
    )

    device = getattr(args, "device", "cuda")
    ff_cfg, w2v_cfg, params = load_faceformer(args.faceformer_checkpoint, device=device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    inputs = []
    for inp in args.inputs:
        p = Path(inp)
        inputs.extend(sorted(p.glob("*.wav")) if p.is_dir() else [p])

    timings = []
    for item in inputs:
        t0 = time.perf_counter()
        stem = Path(item).stem
        if str(item).endswith(".wav"):
            audio = load_audio_16k(item)
        else:  # a text file: synthesize
            wav = out_dir / f"{stem}_tts.wav"
            synthesize_tts(Path(item).read_text().strip(), wav)
            audio = load_audio_16k(wav)
        audio = audio[:MAX_AUDIO_SAMPLES]
        with torch.no_grad():
            feats = extract_audio_motion_features(
                params, ff_cfg, w2v_cfg, torch.from_numpy(audio[None]).to(device))
        np.save(out_dir / f"{stem}_ff.npy", feats[0].float().cpu().numpy())
        timings.append((stem, time.perf_counter() - t0))
        print(f"{stem}: audio latents {tuple(feats.shape)}")
    return timings


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="avatar_tpu_torch preprocessing")
    sub = parser.add_subparsers(dest="command", required=True)

    def device(p):
        p.add_argument("--device", type=str, default="cuda",
                       help="where the VAE / FaceFormer run (cuda, or cpu)")

    def common(p, ckpt=True):
        p.add_argument("--output_dir", type=str, required=True)
        p.add_argument("--clip_length", type=int, default=57)
        p.add_argument("--stride", type=int, default=57)
        p.add_argument("--height", type=int, default=192)
        p.add_argument("--width", type=int, default=320)
        p.add_argument("--format", type=str, default="safetensors",
                       choices=["safetensors", "pt"])
        p.add_argument("--per_channel_normalize", action="store_true", default=True)
        if ckpt:
            p.add_argument("--ckpt", type=str, required=True,
                           help="LTX checkpoint (single-file safetensors)")
        device(p)

    p = sub.add_parser("save-vae-latents")
    p.add_argument("--inputs", type=str, nargs="+", required=True)
    p.add_argument("--save_pixels", action="store_true",
                   help="also save {stem}_pixels.npy uint8 targets for decoder "
                        "fine-tuning (train/decoder.py)")
    common(p)
    p.set_defaults(fn=cmd_save_vae_latents)

    p = sub.add_parser("save-condition-latents")
    p.add_argument("--inputs", type=str, nargs="+", required=True)
    p.add_argument("--transcripts", type=str, default=None)
    p.add_argument("--default_text", type=str, default="Person speaking naturally")
    p.add_argument("--faceformer_checkpoint", type=str, required=True)
    p.add_argument("--flame_template", type=str, required=True)
    common(p, ckpt=False)
    p.set_defaults(fn=cmd_save_condition_latents)

    p = sub.add_parser("save-condition-encoder-latents")
    p.add_argument("--conditions_dir", type=str, required=True)
    common(p)
    p.set_defaults(fn=cmd_save_condition_encoder_latents)

    p = sub.add_parser("save-video-clips")
    p.add_argument("--inputs", type=str, nargs="+", required=True)
    common(p, ckpt=False)
    p.set_defaults(fn=cmd_save_video_clips)

    p = sub.add_parser("save-text-latents")
    p.add_argument("--inputs", type=str, nargs="+", required=True,
                   help="wav files/dirs or text files")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--faceformer_checkpoint", type=str, required=True)
    device(p)
    p.set_defaults(fn=cmd_save_text_latents)
    return parser


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
